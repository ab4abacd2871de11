"""The flash-attention kernel's plain PyTorch version against the JAX
package's Pallas kernel in interpret mode and against both packages' oracles
(``ref.attention_ref``), on small shapes with the edge cases: causal and not,
GQA groups 1, 2 and 6, ``sk_valid`` below ``Sk``, one query row, lengths that
are not tile multiples, the model's decode call (``q_offset``), and the
sliding window (against the JAX model's attention and its mask).

float32 throughout; the tolerance is atol 1e-5 because only the order of the
float sums differs.  On the CPU the wrapper takes its plain version; the CUDA
kernel is held against the same plain version on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import _jax_ref  # noqa: F401  (jax 0.9 shim before the JAX package)
import jax
import jax.numpy as jnp

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro.models.layers import _mask_block as j_mask_block
from repro.models.layers import attention as j_attention
from repro_torch.kernels.flash_attention import (attend, attend_plain,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bh)

j_fa = importlib.import_module(
    "repro.kernels.flash_attention.flash_attention")

ATOL = 1e-5

_j_flash = jax.jit(j_flash, static_argnames=("causal", "block_q", "block_k",
                                             "interpret"))
_j_bh = jax.jit(j_fa.flash_attention_bh, static_argnames=(
    "h_q", "h_kv", "causal", "block_q", "block_k", "sk_valid", "interpret"))


def _qkv(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, sk, d), dtype=np.float32),
            rng.standard_normal((b, hkv, sk, d), dtype=np.float32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# (b, hq, hkv, sq, sk, d): groups 1, 2 and 6, one query row, lengths that are
# not multiples of the JAX kernel's 8-row minimum block, and qwen2's heads.
SHAPES = [
    (2, 2, 2, 16, 16, 16),
    (1, 4, 2, 13, 29, 16),
    (2, 6, 1, 1, 37, 32),
    (1, 12, 2, 24, 24, 16),
    (2, 2, 1, 5, 70, 16),
    (2, 12, 2, 9, 70, 128),
]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_interpret_and_refs(shape, causal):
    b, hq, hkv, sq, sk, d = shape
    q, k, v = _qkv(sum(shape), *shape)
    want = np.asarray(_j_flash(q, k, v, causal=causal, block_q=16,
                               block_k=16, interpret=True))
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    _close(got, want)
    _close(attention_ref(_t(q), _t(k), _t(v), causal=causal),
           j_ref(q, k, v, causal=causal))
    _close(got, j_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("sk_valid", [1, 13, 31, 32])
@pytest.mark.parametrize("causal", [True, False])
def test_sk_valid_below_sk_matches_the_tpu_kernel(sk_valid, causal):
    b, hq, hkv, sq, sk, d = 2, 6, 2, 16, 32, 16
    q, k, v = _qkv(sk_valid, b, hq, hkv, sq, sk, d)
    qb, kb, vb = (x.reshape(-1, x.shape[2], d) for x in (q, k, v))
    want = np.asarray(_j_bh(qb, kb, vb, h_q=hq, h_kv=hkv, causal=causal,
                            block_q=8, block_k=8, sk_valid=sk_valid,
                            interpret=True))
    got = flash_attention_bh(_t(qb), _t(kb), _t(vb), h_q=hq, h_kv=hkv,
                             causal=causal, sk_valid=sk_valid)
    _close(got, want)
    _close(attention_ref(_t(q), _t(k), _t(v), causal=causal,
                         sk_valid=sk_valid),
           j_ref(q, k, v, causal=causal, sk_valid=sk_valid))


@pytest.mark.parametrize("pos", [0, 7, 30])
@pytest.mark.parametrize("group", [1, 2, 6])
def test_decode_call_is_non_causal_attention_up_to_pos(pos, group):
    """The model's decode step (Sq 1 at q_offset = pos over a cache with
    sk_valid = pos + 1) is the kernel's non-causal call with sk_valid = pos +
    1, and equals the JAX model's attention."""
    b, hkv, sk, d = 2, 2, 33, 16
    q, k, v = _qkv(pos + group, b, hkv * group, hkv, 1, sk, d)
    ql, kl, vl = (x.transpose(0, 2, 1, 3) for x in (q, k, v))  # [B, S, H, d]
    got = attend(_t(ql), _t(kl), _t(vl), causal=True, sk_valid=pos + 1,
                 q_offset=pos)
    _close(got, np.asarray(j_attention(ql, kl, vl, causal=True, q_offset=pos,
                                       kv_valid=pos + 1)))
    want = j_ref(q, k, v, causal=False, sk_valid=pos + 1)
    _close(got.transpose(1, 2), want)
    _close(attend(_t(ql), _t(kl), _t(vl), causal=False, sk_valid=pos + 1),
           want.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("chunk", [0, 8])
def test_model_layout_matches_the_jax_model_attention(chunk):
    """attend on [B, S, H, d] strided views equals ``repro.models.layers.
    attention`` (unchunked and its streaming twin) with a cache-style
    kv_valid."""
    b, hq, hkv, sq, sk, d = 2, 4, 2, 11, 20, 16
    rng = np.random.default_rng(chunk)
    q = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    kv = rng.standard_normal((2, b, sk, hkv, d), dtype=np.float32)
    want = np.asarray(j_attention(q, kv[0], kv[1], causal=True, kv_valid=sq,
                                  chunk=chunk))
    # Keys and values as strided views of one [B, Sk, 2, Hkv, d] tensor.
    kvt = _t(kv.transpose(1, 2, 0, 3, 4))
    got = attend(_t(q), kvt[:, :, 0], kvt[:, :, 1], causal=True, sk_valid=sq)
    _close(got, want)


def test_fully_masked_rows_give_zeros():
    q, k, v = _qkv(0, 1, 2, 2, 4, 8, 16)
    got = attend_plain(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                       _t(v).transpose(1, 2), causal=False, sk_valid=0)
    assert torch.equal(got, torch.zeros_like(got))
    _close(got.transpose(1, 2), j_ref(q, k, v, causal=False, sk_valid=0))


# (b, hq, hkv, sq, sk, d, window, q_offset, kv_valid, causal): prefill with
# a window shorter than the prompt, a ragged one, queries at q_offset over a
# cache, decode steps past the window, recurrentgemma's head dim 256 over one
# KV head, a window of 1 and one wider than every key, and a non-causal call.
WINDOWED = [
    (2, 4, 2, 20, 20, 16, 5, 0, None, True),
    (1, 4, 1, 37, 37, 16, 16, 0, None, True),
    (2, 4, 2, 6, 30, 16, 8, 17, 23, True),
    (2, 4, 1, 1, 40, 16, 16, 33, 34, True),
    (2, 6, 1, 1, 70, 32, 16, 69, 70, True),
    (2, 4, 1, 9, 40, 256, 16, 25, 34, True),
    (1, 10, 1, 1, 50, 256, 32, 45, 46, True),
    (1, 2, 2, 8, 8, 16, 1, 0, None, True),
    (1, 2, 2, 8, 8, 16, 100, 0, None, True),
    (2, 4, 2, 12, 12, 16, 4, 0, None, False),
]


def _masked_softmax_ref(q, k, v, *, window, q_offset, kv_valid, causal):
    """Attention from the JAX model's own mask (``layers._mask_block``) and
    a numpy softmax, without Pallas and without the model's attention."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    mask = np.asarray(j_mask_block(q_offset + jnp.arange(sq), jnp.arange(sk),
                                   causal=causal, window=window, prefix=0))
    if kv_valid is not None:
        mask = mask & (np.arange(sk) < kv_valid)[None, :]
    kr = np.repeat(k, hq // hkv, axis=2).astype(np.float64)
    vr = np.repeat(v, hq // hkv, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kr) / np.sqrt(d)
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, vr)


@pytest.mark.parametrize("case", WINDOWED, ids=str)
def test_window_matches_the_jax_model_attention_and_its_mask(case):
    b, hq, hkv, sq, sk, d, window, q_offset, kv_valid, causal = case
    rng = np.random.default_rng(sum(x or 0 for x in case))
    q = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid=kv_valid)
    got = attend(_t(q), _t(k), _t(v), causal=causal, sk_valid=kv_valid,
                 q_offset=q_offset, window=window)
    for chunk in (0, 4):
        _close(got, np.asarray(j_attention(q, k, v, window=window,
                                           chunk=chunk, **kw)))
    _close(got, _masked_softmax_ref(q, k, v, window=window, **kw))
    _close(attend_plain(_t(q), _t(k), _t(v), causal=causal,
                        sk_valid=kv_valid, q_offset=q_offset, window=window),
           got.numpy())


def test_a_window_wider_than_every_key_changes_nothing():
    q, k, v = (_t(x).transpose(1, 2) for x in _qkv(3, 2, 4, 2, 10, 10, 16))
    assert torch.equal(attend(q, k, v, causal=True, window=10),
                       attend(q, k, v, causal=True))


def test_attend_rejects_bad_shapes():
    q = torch.zeros((1, 4, 3, 16))
    k = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        attend(q, k, k, causal=True)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        attend(torch.zeros((1, 4, 4, 16)), k, torch.zeros((1, 5, 2, 16)),
               causal=True)
    with pytest.raises(ValueError, match="window"):
        attend(k, k, k, causal=True, window=-1)
