"""The flash-attention kernel's plain PyTorch version against the JAX
package's Pallas kernel in interpret mode and against both packages' oracles
(``ref.attention_ref``), on small shapes with the edge cases: causal and not,
GQA groups 1, 2 and 6, ``sk_valid`` below ``Sk``, one query row, lengths that
are not tile multiples, the model's decode call (``q_offset``), the
sliding window and the prefix-LM mask (against the JAX model's attention
and its mask).

float32 throughout; the tolerance is atol 1e-5 because only the order of the
float sums differs.  On the CPU the wrapper takes its plain version; the CUDA
kernel is held against the same plain version on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).  What of the CUDA path
the CPU can check is checked here too: the launch plan's key splits, given
the card's SM count, and the bf16 kernels' rounding (kernel 5's and
kernel 5b's), modelled in plain PyTorch, against the card's bf16
tolerances.
"""

from __future__ import annotations

import importlib
import math

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


def _masked_softmax_ref(q, k, v, *, window, q_offset, kv_valid, causal,
                        prefix=0):
    """Attention from the JAX model's own mask (``layers._mask_block``) and
    a numpy softmax, without Pallas and without the model's attention."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    mask = np.asarray(j_mask_block(q_offset + jnp.arange(sq), jnp.arange(sk),
                                   causal=causal, window=window,
                                   prefix=prefix))
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


# (b, hq, hkv, sq, sk, d, prefix, window, q_offset, kv_valid): the prefix-LM
# mask of the patches frontend: a prefix of one key, one ending inside a
# 16-key tile and one past it, every key, with a window (applied after it),
# a decode call, arctic's GQA group of 7 and paligemma's group of 8 at head
# dim 256.
PREFIXED = [
    (2, 4, 2, 20, 20, 16, 1, 0, 0, None),
    (2, 4, 2, 40, 40, 16, 7, 0, 0, None),
    (1, 4, 1, 40, 40, 16, 21, 0, 0, None),
    (1, 2, 2, 12, 12, 16, 12, 0, 0, None),
    (2, 4, 2, 40, 40, 16, 21, 6, 0, None),
    (2, 4, 1, 1, 40, 32, 25, 0, 10, 11),
    (1, 7, 1, 9, 30, 16, 13, 0, 0, 20),
    (2, 8, 1, 19, 24, 256, 11, 0, 0, 19),
]


@pytest.mark.parametrize("case", PREFIXED, ids=str)
def test_prefix_matches_the_jax_model_attention_and_its_mask(case):
    """``attend`` and ``attend_plain`` with ``prefix`` equal the JAX model's
    ``layers.attention`` (unchunked and streamed) and a numpy softmax under
    its own mask ``(k <= q) | (k < prefix)``."""
    b, hq, hkv, sq, sk, d, prefix, window, q_offset, kv_valid = case
    rng = np.random.default_rng(sum(x or 0 for x in case))
    q = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    kw = dict(causal=True, q_offset=q_offset, kv_valid=kv_valid)
    got = attend(_t(q), _t(k), _t(v), causal=True, sk_valid=kv_valid,
                 q_offset=q_offset, window=window, prefix=prefix)
    for chunk in (0, 4):
        _close(got, np.asarray(j_attention(q, k, v, window=window,
                                           prefix=prefix, chunk=chunk, **kw)))
    _close(got, _masked_softmax_ref(q, k, v, window=window, prefix=prefix,
                                    **kw))
    _close(attend_plain(_t(q), _t(k), _t(v), causal=True, sk_valid=kv_valid,
                        q_offset=q_offset, window=window, prefix=prefix),
           got.numpy())
    if prefix <= q_offset + 1:   # every row sees the prefix anyway
        _close(got, attend(_t(q), _t(k), _t(v), causal=True,
                           sk_valid=kv_valid, q_offset=q_offset,
                           window=window).numpy())


def test_a_prefix_without_causal_changes_nothing():
    q, k, v = (_t(x).transpose(1, 2) for x in _qkv(5, 2, 4, 2, 10, 10, 16))
    assert torch.equal(attend(q, k, v, causal=False, prefix=6),
                       attend(q, k, v, causal=False))
    with pytest.raises(ValueError, match="prefix"):
        attend(q, k, v, causal=True, prefix=-1)


def _kernel_keys(rows, group, bq, bk, kw_keys, *, sk, sk_valid, q_offset,
                 window, prefix, split_len=0, splits=1):
    """The keys ``flash_attention.cu`` computes for each query row, from its
    ``key_range`` (the causal end at the block's last row's limit ``max(pos,
    prefix - 1)``, the window's first tile) and the tensor-core kernel's
    sub-tile skip (``k0 > cl_hi``, or wholly before the window), per
    split: ``{row: set of keys}``, masked keys left out as the kernel's
    per-row test leaves them."""
    def limit(pos):
        return max(pos, prefix - 1)

    def first_tile(pos):
        first = pos - window + 1
        return first // bk * bk if first > 0 else 0

    kv_lim = min(sk_valid, sk)
    seen = {r: set() for r in range(rows)}
    split_len = split_len or sk
    for r0 in range(0, rows, bq):
        r_end = min(r0 + bq, rows)
        kv_end = min(limit(q_offset + (r_end - 1) // group) + 1, kv_lim)
        base = first_tile(q_offset) if window else 0
        for split in range(splits):
            lo = base + split * split_len
            hi = min(lo + split_len, kv_end)
            if window:
                lo = max(lo, first_tile(q_offset + r0 // group))
            for t0 in range(lo, hi, bk):
                for w0 in range(r0, r_end, 16):        # a warp's 16 rows
                    w_last = min(w0 + 16, r_end) - 1
                    pos_lo = q_offset + w0 // group
                    cl_hi = limit(q_offset + w_last // group)
                    for k0 in range(t0, t0 + bk, kw_keys):
                        if (k0 >= hi or k0 > cl_hi or (
                                window and k0 + kw_keys - 1
                                <= pos_lo - window)):
                            continue
                        for r in range(w0, w_last + 1):
                            pos = q_offset + r // group
                            for kp in range(k0, min(k0 + kw_keys, hi)):
                                if kp <= limit(pos) and (
                                        not window or kp > pos - window):
                                    seen[r].add(kp)
    return seen


@pytest.mark.parametrize("case", [
    (1, 256, 8, 64, 64, 300, 300, 0, 0, 256),      # paligemma-like prefill
    (12, 0, 7, 64, 64, 200, 150, 0, 0, 40),       # arctic's group of 7
    (20, 0, 8, 64, 32, 100, 100, 0, 16, 70),      # prefix with a window
    (1, 0, 8, 16, 16, 300, 301, 300, 0, 256),     # decode, keys split
    (3, 5, 1, 64, 64, 200, 200, 5, 0, 130),       # past 2 key tiles
], ids=str)
def test_kernel_key_ranges_give_each_row_its_prefix_keys(case):
    """The CUDA kernel's key ranges and sub-tile skips, mirrored in Python:
    with a prefix every row is given exactly the keys the JAX mask lets it
    see, each once."""
    sq, extra, group, bq, kw_keys, sk, sk_valid, q_offset, window, prefix         = case
    sq += extra
    rows = sq * group
    splits, split_len = (1, 0) if sq > 1 else (5, 64)
    seen = _kernel_keys(rows, group, bq, 64, kw_keys, sk=sk,
                        sk_valid=sk_valid, q_offset=q_offset, window=window,
                        prefix=prefix, split_len=split_len, splits=splits)
    for r in range(rows):
        pos = q_offset + r // group
        want = {kp for kp in range(min(sk, sk_valid))
                if (kp <= pos or kp < prefix)
                and (not window or kp > pos - window)}
        assert seen[r] == want, r


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


# --------------------------------------------------------------------------- #
# The CUDA kernel's launch plan and its bf16 rounding, checked on the CPU.    #
# --------------------------------------------------------------------------- #

SMS = 132   # the H100 SXM's streaming multiprocessors

j_fa_t = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")

# (name, b, sq, hq, hkv, d, sk, sk_valid, q_offset, window): the serve path's
# calls (qwen2-1.5b and recurrentgemma-2b, prefill and decode), a windowed
# decode whose window starts inside a key tile, ragged and small calls, and
# no valid key.
PLANS = [
    ("qwen2 prefill", 8, 1024, 12, 2, 128, 1096, 1024, 0, 0),
    ("qwen2 decode", 8, 1, 12, 2, 128, 1096, 1062, 1061, 0),
    ("recurrentgemma prefill", 8, 3072, 10, 1, 256, 3144, 3072, 0, 2048),
    ("recurrentgemma decode", 8, 1, 10, 1, 256, 3144, 3110, 3109, 2048),
    ("windowed decode", 4, 1, 10, 1, 256, 700, 650, 649, 300),
    ("ragged prefill", 2, 70, 6, 2, 64, 150, 76, 5, 0),
    ("small", 1, 3, 4, 1, 32, 80, 61, 58, 0),
    ("no valid key", 1, 1, 6, 1, 64, 100, 0, 0, 0),
    ("paligemma prefill", 8, 1024, 8, 1, 256, 1096, 1024, 0, 0),
    ("paligemma decode", 8, 1, 8, 1, 256, 1096, 1062, 1061, 0),
    ("arctic decode", 8, 1, 56, 8, 128, 1096, 1062, 1061, 0),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("case", PLANS, ids=lambda c: c[0])
def test_plan_splits_cover_every_live_key_once(case, dtype):
    """The kernel's key ranges, as ``flash_attention.cu`` cuts them from the
    plan: split s covers ``[base + s·split_len, base + (s + 1)·split_len)``
    below the last valid key.  Together they cover every live key exactly
    once, none is empty, ``split_len`` is a multiple of the key tile, and a
    call whose row tiles are too few for the card gets at least one block
    per SM where there are key tiles enough."""
    _, b, sq, hq, hkv, d, sk, sk_valid, q_offset, window = case
    rows = sq * (hq // hkv)
    bq, bk, splits, split_len = j_fa_t._plan(
        SMS, dtype, b, rows, hkv, d, sk=sk, sk_valid=sk_valid,
        q_offset=q_offset, window=window)
    assert (bq, bk) == j_fa_t._tiles(dtype, d, rows)
    base = j_fa_t._key_base(q_offset, window, bk)
    assert base % bk == 0
    if window:
        assert base <= max(0, q_offset - window + 1)   # row 0's first key
    end = min(max(sk_valid, 0), sk)
    blocks = -(-rows // bq) * hkv * b
    if splits == 1:
        assert split_len == 0
        return
    assert split_len > 0 and split_len % bk == 0
    covered = []
    for s in range(splits):
        lo, hi = base + s * split_len, min(base + (s + 1) * split_len, end)
        assert lo < hi, f"split {s} is empty"
        covered += range(lo, hi)
    assert covered == list(range(base, end))
    assert blocks < SMS
    kv_tiles, per = -(-(end - base) // bk), split_len // bk
    if kv_tiles >= -(-SMS // blocks):
        # At least one block per SM, and no longer ranges would give that.
        assert blocks * splits >= SMS
        assert blocks * -(-kv_tiles // (per + 1)) < SMS


@pytest.mark.parametrize("case", PLANS[:4], ids=lambda c: c[0])
def test_plan_of_the_serve_calls(case):
    """bf16 at the serve shapes: prefill on 64-row tiles, unsplit; decode
    on one 16-row tile with the keys split over at least 132 blocks."""
    name, b, sq, hq, hkv, d, sk, sk_valid, q_offset, window = case
    bq, bk, splits, _ = j_fa_t._plan(
        SMS, torch.bfloat16, b, sq * (hq // hkv), hkv, d, sk=sk,
        sk_valid=sk_valid, q_offset=q_offset, window=window)
    if sq > 1:
        assert (bq, splits) == (64, 1)
        assert bk == (j_fa_t.D256_PREFILL_BK if d == 256 else 64)
    else:
        assert (bq, bk) == (16, 64)
        assert b * hkv * splits >= SMS


def _kernel_rounding(q, k, v, *, causal, sk_valid, q_offset=0, window=0,
                     prefix=0, bk=64, split=True):
    """The tensor-core kernel's arithmetic in plain PyTorch, in q's dtype
    (bf16 or fp16): S = Q·Kᵀ of the 16-bit values summed in float32 and
    scaled after the product (log2 units), an online softmax over
    ``bk``-key tiles with exp2, P split into ``hi = T(p)`` and ``lo = T(p -
    hi)`` whose two products with V sum in float32 (``split=False``: P
    rounded once, no ``lo``), ``l`` from the float32 p, and one rounding of
    the output to T."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qf = q.float().reshape(b, sq, hkv, group, d)
    kf, vf = k.float(), v.float()
    sl = torch.tensor(math.log2(math.e) / math.sqrt(d), dtype=torch.float32)
    row = q_offset + torch.arange(sq)
    m = torch.full((b, hkv, group, sq), -1e30)
    l = torch.zeros((b, hkv, group, sq))
    acc = torch.zeros((b, hkv, group, sq, d))
    for k0 in range(0, sk, bk):
        col = torch.arange(k0, min(k0 + bk, sk))
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf[:, col]) * sl
        mask = (col < sk_valid)[None, :].expand(sq, -1)
        if causal:
            mask = mask & ((col[None, :] <= row[:, None])
                           | (col < prefix)[None, :])
        if window:
            mask = mask & (col[None, :] > row[:, None] - window)
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(mask, torch.exp2(s - m_new[..., None]), 0.0)
        hi, lo = _split(p, split, q.dtype)
        l = l * alpha + p.sum(-1)
        acc = (acc * alpha[..., None]
               + torch.einsum("bhgqk,bkhd->bhgqd", hi, vf[:, col])
               + torch.einsum("bhgqk,bkhd->bhgqd", lo, vf[:, col]))
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


# (b, sq, sk, hq, hkv, d, causal, sk_valid, q_offset, window, bk, prefix):
# qwen2's and recurrentgemma's heads in prefill and decode, with the window's
# edge inside a key tile; paligemma's (8 of 256 over one KV head) and
# arctic's (56 over 8) prefills under the prefix-LM mask.
ROUNDING = [
    (2, 80, 150, 12, 2, 128, True, 140, 60, 0, 64, 0),
    (2, 1, 300, 12, 2, 128, True, 201, 200, 0, 64, 0),
    (1, 48, 120, 10, 1, 256, True, 120, 72, 40, 32, 0),
    (2, 1, 200, 10, 1, 256, True, 180, 179, 100, 64, 0),
    (1, 90, 100, 8, 1, 256, True, 90, 0, 0, 32, 40),
    (1, 40, 50, 56, 8, 128, True, 40, 0, 0, 64, 17),
]


# The card's tolerances for the 16-bit kernels, (rtol, atol): both kernel
# and plain version sum in float32 and round once, so they part by one ulp
# of the output's type at most (bf16 2^-7, fp16 2^-10 relative), plus the
# float32 sums' order near zero (2^-10 in bf16, 2^-13 in fp16).
HALF_TOL = {torch.bfloat16: (2**-7, 2**-10), torch.float16: (2**-10, 2**-13)}


def _rounding_error(case, split=True, dtype=torch.bfloat16, scale=1.0):
    """max |model - plain| / (atol + rtol |plain|) (``HALF_TOL``) at a
    ``ROUNDING`` case, over seeded inputs of ``dtype`` (times ``scale``)."""
    b, sq, sk, hq, hkv, d, causal, sk_valid, q_offset, window, bk, prefix = \
        case
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * scale).to(dtype)
               for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                             (b, sk, hkv, d)))
    kw = dict(causal=causal, sk_valid=sk_valid, q_offset=q_offset,
              window=window, prefix=prefix)
    got = _kernel_rounding(q, k, v, bk=bk, split=split, **kw).float()
    want = attend_plain(q, k, v, **kw).float()
    assert torch.isfinite(got).all()
    rtol, atol = HALF_TOL[dtype]
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


@pytest.mark.parametrize("case", ROUNDING, ids=str)
def test_kernel_rounding_model_holds_the_cards_bf16_tolerance(case):
    """The card holds bf16 attention within 2^-10 + 2^-7 |plain|: the
    kernel's rounding (P split into bf16 hi + lo, float32 sums) keeps it
    within one bf16 ulp of the plain version."""
    assert _rounding_error(case) <= 1.0


def test_p_rounded_once_would_leave_the_tolerance():
    """Why P is split: rounded once to bf16 it errs by up to 2^-8 max|v|,
    and the same model then leaves the card's tolerance."""
    assert max(_rounding_error(case, split=False) for case in ROUNDING) > 1


@pytest.mark.parametrize("scale", [1.0, 4.0])
@pytest.mark.parametrize("case", ROUNDING, ids=str)
def test_kernel_rounding_model_holds_the_cards_fp16_tolerance(case, scale):
    """The card holds fp16 attention within 2^-13 + 2^-10 |plain|: P split
    into fp16 hi + lo keeps the kernel within one fp16 ulp of the plain
    version, also where inputs four times larger spread the scores so that
    most p lie below fp16's normal range (2^-14) and many flush to 0 (the
    row's largest p is 1, and l at least 1)."""
    assert _rounding_error(case, dtype=torch.float16, scale=scale) <= 1.0


def test_fp16_p_rounded_once_would_leave_the_tolerance():
    """Why fp16's P is split too: rounded once to fp16 it errs by up to
    2^-11 max|v|, and the model then leaves the card's fp16 tolerance."""
    assert max(_rounding_error(c, split=False, dtype=torch.float16)
               for c in ROUNDING) > 1


# --------------------------------------------------------------------------- #
# The backward (kernel 5b's plain version and the autograd path)              #
# --------------------------------------------------------------------------- #

# (b, sq, hq, hkv, d, mask keywords): causal, non-causal, the prefix-LM mask,
# windows, GQA groups 1, 2 and 6, head dims 16, 80 (hubert's) and 256 under
# a window (recurrentgemma's local attention, 4 heads over one KV head); 40
# and 70 positions over the JAX attention's 32-key chunks, so its chunked,
# checkpointed path (``_attention_chunked``) is what jax.grad differentiates.
BWD_CASES = [
    (2, 40, 2, 2, 16, dict(causal=True)),
    (2, 40, 4, 2, 16, dict(causal=False)),
    (1, 70, 6, 1, 16, dict(causal=True, prefix=37)),
    (2, 40, 4, 2, 16, dict(causal=True, window=16)),
    (1, 70, 6, 1, 16, dict(causal=True, prefix=9, window=20)),
    (1, 40, 4, 4, 80, dict(causal=False)),
    (1, 40, 6, 2, 80, dict(causal=True)),
    (1, 70, 4, 1, 256, dict(causal=True, window=24)),
]


def _bwd_inputs(seed, b, sq, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for shape in
            ((b, sq, hq, d), (b, sq, hkv, d), (b, sq, hkv, d),
             (b, sq, hq, d))]


def _jax_grads(q, k, v, dout, kw):
    """jax.grad of the JAX model's attention (chunk 32) against dout."""
    f = lambda q, k, v: jnp.vdot(
        j_attention(q, k, v, chunk=32, **kw), dout)
    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_backward_plain_and_autograd_match_jax_grad(case):
    """``attend_backward_plain`` (the explicit formula) and the autograd
    path through ``attend`` (on the CPU: ``attend_plain`` then
    ``attend_backward_plain``) against ``jax.grad`` of
    ``repro.models.layers.attention``, within 1e-5 (1 + |jax|)."""
    b, sq, hq, hkv, d, kw = case
    q, k, v, dout = _bwd_inputs(sum(case[:5]), b, sq, hq, hkv, d)
    want = _jax_grads(q, k, v, dout, kw)
    tq, tk, tv, tdo = map(_t, (q, k, v, dout))
    out = attend(tq, tk, tv, **kw)
    plain = j_fa_t.attend_backward_plain(tq, tk, tv, out, tdo, **kw)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    got = torch.autograd.grad(attend(*leaves, **kw), leaves, tdo)
    for grads in (plain, got):
        for g, w in zip(grads, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * (1 + np.abs(w).max()))


def test_attend_goes_through_the_backward_only_when_autograd_needs_it(
        monkeypatch):
    """Serving (no gradient wanted) takes the plain forward alone; a call
    whose inputs require grad takes the autograd function, whose backward
    is ``attend_backward``."""
    calls = []
    real = j_fa_t.attend_backward
    monkeypatch.setattr(j_fa_t, "attend_backward",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v, dout = map(_t, _bwd_inputs(0, 1, 8, 2, 1, 16))
    out = attend(q, k, v, causal=True)
    assert out.grad_fn is None
    with torch.no_grad():
        assert attend(q.requires_grad_(True), k, v, causal=True).grad_fn is None
    out = attend(q, k, v, causal=True)
    assert out.grad_fn is not None
    out.backward(dout)
    assert calls == [1] and q.grad is not None and k.grad is None


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, prefix=5, window=4),
                                dict(causal=True, sk_valid=0),
                                dict(causal=True, sk_valid=7, q_offset=3)],
                         ids=str)
def test_lse_is_each_rows_log_normaliser(kw):
    """``attend_plain_with_lse``: the output with each row's natural
    log-sum-exp of its scaled, masked scores (+inf for a row that sees no
    key), against ``torch.logsumexp`` over the mask written out."""
    q, k, v = (_t(x) for x in _bwd_inputs(1, 2, 9, 4, 2, 16)[:3])
    out, lse = j_fa_t.attend_plain_with_lse(q, k, v, **kw)
    assert torch.equal(out, attend_plain(q, k, v, **kw))
    assert lse.shape == (2, 4, 9) and lse.dtype == torch.float32
    pos = kw.get("q_offset", 0) + torch.arange(9)[:, None]
    col = torch.arange(9)[None, :]
    mask = col < kw.get("sk_valid", 9)
    if kw["causal"]:
        mask = mask & ((col <= pos) | (col < kw.get("prefix", 0)))
    if kw.get("window"):
        mask = mask & (col > pos - kw["window"])
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(2, 9, 2, 2, 16), k) / 4.0
    ref = torch.logsumexp(torch.where(mask, s, -math.inf), dim=-1)
    ref = ref.reshape(2, 4, 9)
    live = mask.any(-1).expand(2, 4, 9)
    assert torch.equal(torch.isfinite(lse), live)
    assert (lse[~live] == math.inf).all()
    torch.testing.assert_close(lse[live], ref[live], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", [
    ("hubert layer, small batch", 1, 40, 16, 16, 80, 40),
    ("one row over many keys", 1, 1, 12, 2, 128, 1062),
    ("two heads, long keys", 1, 200, 2, 1, 80, 1062)], ids=lambda c: c[0])
def test_plan_splits_at_the_cards_training_edge_shapes(case):
    """Shapes the card's backward edge checks run (``chip_smoke.py``
    ``BWD_EDGES``): with so few blocks the forward's plan splits the keys,
    so the merge launch writes ``lse`` there."""
    _, b, sq, hq, hkv, d, sk = case
    _, _, splits, _ = j_fa_t._plan(SMS, torch.float32, b, sq * (hq // hkv), hkv,
                                 d, sk=sk, sk_valid=sk)
    assert splits > 1


# --------------------------------------------------------------------------- #
# Kernel 5b's bf16 rounding, modelled on the CPU                              #
# --------------------------------------------------------------------------- #

# The card holds kernel 5b's bf16 gradients to attend_backward_plain within
# rtol |plain| + atol max(1, max |plain|) (chip_smoke.py ``BWD_BF16_TOL``):
# both sum in fp32, and each gradient is rounded to bf16 once.
BWD_BF16_TOL = (2**-7, 1e-4)
BWD_FP16_TOL = (2**-10, 2**-12)
FP16_SUBNORMAL = 2**-24     # fp16's spacing below 2^-14
# BWD_CASES, then narrow hubert-like (head dim 80, group 1, non-causal) and
# qwen2-like (head dim 128, group 6, causal) calls whose rows and keys are
# not multiples of the kernel's 64-row and 64-key tiles; at head dim 256
# recurrentgemma's heads (10 over one KV head) under a window of 100, whose
# edge falls inside the key tiles (3000 rows in 11 slices, 300 keys), and
# paligemma's (8 over one) under a prefix of 37 (6 slices).
BWD_ROUNDING = BWD_CASES + [
    (1, 300, 2, 2, 80, dict(causal=False)),
    (1, 100, 12, 2, 128, dict(causal=True)),
    (1, 300, 10, 1, 256, dict(causal=True, window=100)),
    (1, 200, 8, 1, 256, dict(causal=True, prefix=37)),
]


def _tile_slices(rows, group, k0, *, kv_lim, causal, q_offset, window,
                 prefix, slices, bk=j_fa_t.BWD256_BK,
                 sub=j_fa_t.BWD256_SUB):
    """The query rows ``[lo, hi)`` of each slice of key tile ``k0`` in
    ``dkdv_256_kernel`` (``csrc/flash_attention_bwd.cu``), its arithmetic in
    Python: the rows that may see a key of the tile, ``[r_lo, r_hi)`` in
    ``rows`` position-major rows of a KV head's group, cut into 32-row ring
    tiles and those into ``slices`` contiguous runs of equal length."""
    r_lo, r_hi = 0, rows if k0 < kv_lim else 0
    if causal and k0 >= prefix:
        first = k0 - q_offset
        r_lo = first * group if first > 0 else 0
    if window > 0:
        end = min(k0 + bk, kv_lim) - 1 + window - q_offset
        r_hi = min(r_hi, end * group if end > 0 else 0)
    nsub = -(-(r_hi - r_lo) // sub) if r_hi > r_lo else 0
    per = -(-nsub // slices)
    out = []
    for s in range(slices):
        t_lo = min(nsub, s * per)
        t_hi = min(nsub, t_lo + per)
        out.append((min(r_hi, r_lo + t_lo * sub),
                    min(r_hi, r_lo + t_hi * sub)))
    return out


def _split(x, split, dtype=torch.bfloat16):
    """x as ``hi = dtype(x)`` and ``lo = dtype(x - hi)`` (``lo`` 0 unless
    ``split``), both as float32."""
    hi = x.to(dtype).float()
    return hi, ((x - hi).to(dtype).float() if split
                else torch.zeros_like(x))


def _ds_exp(m):
    """``flash_common.cuh``'s ``ds_exp``: the largest e <= 100 with ``m·2^e
    < 2^15`` (m >= 0 float32), from m's biased exponent."""
    return (141 - ((m.contiguous().view(torch.int32) >> 23) & 0xFF)).clamp(
        max=100)


def _pow2(e):
    """2^e as float32 (0 below 2^-126), as ``flash_common.cuh``'s ``pow2``."""
    return torch.where(e < -126, 0.0,
                       torch.ldexp(torch.ones(e.shape), e.float()))


def _bwd_kernel_rounding(q, k, v, out, dout, lse, *, causal, sk_valid=None,
                         q_offset=0, window=0, prefix=0, split_p=True,
                         split_ds=True, scale_ds=True, tile=64):
    """Kernel 5b's 16-bit arithmetic in plain PyTorch, in q's dtype T (bf16
    or fp16): the rows of a KV head's group position-major; S = Q·Kᵀ and
    dP = dO·Vᵀ of the 16-bit values summed in float32; P = 2^(S·scale·log2
    e − lse·log2 e) from the forward's ``lse`` and dS = P (dP − D), D =
    rowsum(dO ∘ O), in float32; P and dS split into T ``hi + lo``
    (``split_p``/``split_ds`` False: rounded once); dV and dK summed over
    64-row tiles and dQ over 64-key tiles in float32, dK and dQ scaled at
    the end; one rounding of each gradient to T.  In fp16 (``scale_ds``)
    each tile's dS is split after scaling each row of the split operand (a
    key for dK, a query row for dQ) by 2^e, e lowered to the row's
    :func:`_ds_exp` of the largest |dS| it has met, the row's sum
    multiplied by the change, and 2^-e taken out at the end
    (``scale_rows``).  Head dim 256 (``dkdv_256_kernel``,
    ``dq_256_kernel``): each 64-key tile's dV and dK summed over its slices'
    32-row ring tiles (:func:`_tile_slices`, slices from the wrapper's plan
    for the card), one float32 partial (its own scales) a slice, the
    partials added in slice order; dQ over 32-key tiles."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    rows = sq * group
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    sk_valid = sk if sk_valid is None else sk_valid

    def by_row(t):
        return (t.float().reshape(b, sq, hkv, group, d)
                .permute(0, 2, 1, 3, 4).reshape(b, hkv, rows, d))

    qr, dor = by_row(q), by_row(dout)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))
    l2 = (lse.reshape(b, hkv, group, sq).permute(0, 1, 3, 2)
          .reshape(b, hkv, rows) * log2e)
    dsum = (dor * by_row(out)).sum(-1)
    pos = q_offset + torch.arange(rows) // group
    col = torch.arange(sk)
    mask = (col < sk_valid)[None, :].expand(rows, -1)
    if causal:
        mask = mask & ((col[None, :] <= pos[:, None])
                       | (col < prefix)[None, :])
    if window:
        mask = mask & (col[None, :] > pos[:, None] - window)
    s = torch.einsum("bhrd,bhkd->bhrk", qr, kf)
    p = torch.where(mask, torch.exp2(s * (scale * log2e) - l2[..., None]),
                    0.0)
    dp = torch.einsum("bhrd,bhkd->bhrk", dor, vf)
    ds = torch.where(mask, p * (dp - dsum[..., None]), 0.0)
    half = q.dtype
    scaled = scale_ds and half == torch.float16

    def add(acc, e, x, y, eq, split, axis):
        """acc += x·y (``eq``), x split into T hi + lo; with ``e`` (the rows'
        exponents, None: no scale) x's rows scaled first, ``axis`` the one
        a row's largest |x| is taken over."""
        if e is not None:
            e_new = torch.minimum(e, _ds_exp(x.abs().amax(dim=axis)))
            acc = acc * _pow2(e_new - e)[..., None]
            e = e_new
            x = x * _pow2(e).unsqueeze(axis)
        for part in _split(x, split, half):
            acc = acc + torch.einsum(eq, part, y)
        return acc, e

    def exps(acc):
        return torch.full(acc.shape[:-1], 100) if scaled else None

    def unscale(acc, e):
        return acc if e is None else acc * _pow2(-e)[..., None]

    dv, dk, dq = (torch.zeros_like(t) for t in (vf, kf, qr))
    if d == 256:
        slices = j_fa_t._bwd_slices(SMS, half, b, rows, hkv, d, sk)
        bk = j_fa_t.BWD256_BK
        for k0 in range(0, sk, bk):
            c = slice(k0, k0 + bk)
            for lo, hi in _tile_slices(rows, group, k0, kv_lim=min(sk_valid, sk),
                                       causal=causal, q_offset=q_offset,
                                       window=window, prefix=prefix,
                                       slices=slices):
                pv, pk = torch.zeros_like(dv[:, :, c]), torch.zeros_like(dk[:, :, c])
                e = exps(pk)
                for r0 in range(lo, hi, j_fa_t.BWD256_SUB):
                    r = slice(r0, min(r0 + j_fa_t.BWD256_SUB, hi))
                    pv, _ = add(pv, None, p[:, :, r, c], dor[:, :, r],
                                "bhrk,bhrd->bhkd", split_p, 2)
                    pk, e = add(pk, e, ds[:, :, r, c], qr[:, :, r],
                                "bhrk,bhrd->bhkd", split_ds, 2)
                dv[:, :, c] += pv
                dk[:, :, c] += unscale(pk, e)
        tile = j_fa_t.BWD256_QBK
    else:
        e = exps(dk)
        for r0 in range(0, rows, tile):
            r = slice(r0, r0 + tile)
            dv, _ = add(dv, None, p[:, :, r], dor[:, :, r],
                        "bhrk,bhrd->bhkd", split_p, 2)
            dk, e = add(dk, e, ds[:, :, r], qr[:, :, r], "bhrk,bhrd->bhkd",
                        split_ds, 2)
        dk = unscale(dk, e)
    e = exps(dq)
    for k0 in range(0, sk, tile):
        c = slice(k0, k0 + tile)
        dq, e = add(dq, e, ds[..., c], kf[:, :, c], "bhrk,bhkd->bhrd",
                    split_ds, 3)
    dq = unscale(dq, e)
    dq = ((dq * scale).reshape(b, hkv, sq, group, d).permute(0, 2, 1, 3, 4)
          .reshape(b, sq, hq, d))
    return (dq.to(half), (dk * scale).permute(0, 2, 1, 3).to(half),
            dv.permute(0, 2, 1, 3).to(half))


def _bwd_rounding_errors(case, dtype=torch.bfloat16, dout_scale=1.0,
                         **split):
    """max |model − plain| / bound of dq, dk and dv at a ``BWD_ROUNDING``
    case, over seeded inputs of ``dtype`` (``dout`` times ``dout_scale``):
    bf16's bound rtol |plain| + atol max(1, max |plain|) (``BWD_BF16_TOL``),
    fp16's rtol |plain| + atol max(max |plain|, max |dout|)
    (``BWD_FP16_TOL``) + 2^-24: a gradient's terms are of dout's size even
    where they cancel (one query over one key: dS = dP - D = 0)."""
    b, sq, hq, hkv, d, kw = case
    q, k, v, dout = (_t(x) for x in
                     _bwd_inputs(sum(case[:5]), b, sq, hq, hkv, d))
    q, k, v, dout = (x.to(dtype) for x in (q, k, v, dout * dout_scale))
    out, lse = j_fa_t.attend_plain_with_lse(q, k, v, **kw)
    got = _bwd_kernel_rounding(q, k, v, out, dout, lse, **kw, **split)
    want = j_fa_t.attend_backward_plain(q, k, v, out, dout, **kw)
    errs = []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all()
        if dtype == torch.bfloat16:
            rtol, atol = BWD_BF16_TOL
            bound = rtol * w.abs() + atol * max(1.0, float(w.abs().max()))
        else:
            rtol, atol = BWD_FP16_TOL
            scale = max(float(w.abs().max()), float(dout.abs().max()))
            bound = rtol * w.abs() + atol * scale + FP16_SUBNORMAL
        errs.append(float(((g - w).abs() / bound).max()))
    return errs


@pytest.mark.parametrize("case", BWD_ROUNDING, ids=str)
def test_backward_rounding_model_holds_the_cards_bf16_tolerance(case):
    """Kernel 5b's rounding (P and dS split into bf16 hi + lo, float32
    sums, 64-row and 64-key tiles) keeps dq, dk and dv within the card's
    bf16 tolerance ``BWD_BF16_TOL`` of the plain version."""
    assert max(_bwd_rounding_errors(case)) <= 1.0


@pytest.mark.parametrize("dout_scale", [1.0, 2**-16])
@pytest.mark.parametrize("case", BWD_ROUNDING, ids=str)
def test_backward_rounding_model_holds_the_cards_fp16_tolerance(case,
                                                                dout_scale):
    """Kernel 5b's fp16 rounding (P and dS split into fp16 hi + lo, dS
    scaled a row by a power of two first, float32 sums) keeps dq, dk and dv
    within the card's fp16 tolerance, ``BWD_FP16_TOL`` of each gradient's
    scale plus fp16's subnormal spacing, also for an output gradient of
    2^-16 (a loss's gradient: dS then lies below fp16's normal range)."""
    assert max(_bwd_rounding_errors(case, torch.float16, dout_scale)) <= 1.0


def test_fp16_ds_unscaled_would_leave_the_tolerance():
    """Why fp16's dS is scaled: for an output gradient of 2^-16, dS split as
    it is loses its low bits below 2^-14 and dq and dk leave the card's
    fp16 tolerance."""
    errs = [_bwd_rounding_errors(case, torch.float16, 2**-16,
                                 scale_ds=False) for case in BWD_ROUNDING]
    assert max(max(e[:2]) for e in errs) > 1


@pytest.mark.parametrize("once", ["P", "dS"])
def test_p_or_ds_rounded_once_would_leave_the_tolerance(once):
    """Why both P and dS are split: rounded once to bf16, either takes the
    gradients its product makes (dV for P; dK and dQ for dS) out of the
    card's tolerance, while the other, still split, stays within it."""
    split = dict(split_p=once != "P", split_ds=once != "dS")
    errs = [_bwd_rounding_errors(case, **split) for case in BWD_ROUNDING]
    dq, dk, dv = (max(e[i] for e in errs) for i in range(3))
    if once == "P":
        assert dv > 1 and max(dq, dk) <= 1
    else:
        assert min(dq, dk) > 1 and dv <= 1


# Kernel 5b's head-dim-256 calls whose dK/dV rows the card slices, (b, sq,
# sk, hq, hkv, mask keywords): recurrentgemma-2b's training call, then
# chip_smoke.py's BWD_EDGES (and test_torch_gpu.py's) at head dim 256.
SLICED = [
    (2, 3072, 3072, 10, 1, dict(causal=True, window=2048)),
    (2, 300, 300, 8, 1, dict(causal=True, prefix=256)),
    (1, 90, 90, 4, 2, dict(causal=True, window=16)),
    (1, 300, 300, 10, 1, dict(causal=True, window=100)),
    (2, 100, 300, 8, 1, dict(causal=True, sk_valid=260, q_offset=170)),
    (1, 150, 200, 4, 1, dict(causal=False)),
    (1, 40, 40, 2, 1, dict(causal=True)),
]


@pytest.mark.parametrize("tiles", [(64, 32, 32), (32, 32, 32),
                                   (64, 16, 32), (64, 32, 64)], ids=str)
def test_bwd256_tile_check_refuses_a_kernel_with_other_tiles(monkeypatch,
                                                             tiles):
    """The wrapper launches the head-dim-256 passes only when the built
    kernel reports the tiles its slice plan and this file's rounding model
    take (``repro_flash_attention_bwd256_tile``); any other tile raises.
    The card's own report is held in ``tests/test_torch_gpu.py``."""

    class Lib:
        def repro_flash_attention_bwd256_tile(self, which):
            return tiles[which]

    monkeypatch.setattr(j_fa_t, "library", Lib)
    j_fa_t._check_bwd256_tiles.cache_clear()
    try:
        if tiles == (j_fa_t.BWD256_BK, j_fa_t.BWD256_SUB, j_fa_t.BWD256_QBK):
            j_fa_t._check_bwd256_tiles()
        else:
            with pytest.raises(RuntimeError, match="head-dim-256 tiles"):
                j_fa_t._check_bwd256_tiles()
    finally:
        j_fa_t._check_bwd256_tiles.cache_clear()


@pytest.mark.parametrize("case", SLICED, ids=str)
def test_bwd_slices_cover_every_row_that_sees_a_key_tile_once(case):
    """The dK/dV pass at head dim 256: for every 64-key tile, the slices'
    row ranges (:func:`_tile_slices`, the kernel's arithmetic) hold every
    query row that sees a key of the tile exactly once, and no row twice;
    the plan gives at least one block per SM where the rows allow it, and
    one slice to fp32, other head dims and the smallest call."""
    b, sq, sk, hq, hkv, kw = case
    group, rows = hq // hkv, sq * (hq // hkv)
    causal, prefix, window = kw["causal"], kw.get("prefix", 0), kw.get("window", 0)
    sk_valid, q_offset = kw.get("sk_valid", sk), kw.get("q_offset", 0)
    slices = j_fa_t._bwd_slices(SMS, torch.bfloat16, b, rows, hkv, 256, sk)
    tiles = -(-sk // j_fa_t.BWD256_BK) * b * hkv
    assert 1 <= slices <= max(1, rows // j_fa_t.BWD256_SLICE_ROWS)
    if slices < -(-SMS // tiles):
        assert slices == max(1, rows // j_fa_t.BWD256_SLICE_ROWS)
    else:
        assert tiles * slices >= SMS and (slices == 1
                                          or tiles * (slices - 1) < SMS)
    for dtype, d in ((torch.float32, 256), (torch.bfloat16, 128)):
        assert j_fa_t._bwd_slices(SMS, dtype, b, rows, hkv, d, sk) == 1
    pos = q_offset + torch.arange(sq)[:, None]
    col = torch.arange(sk)[None, :]
    mask = (col < min(sk_valid, sk)).expand(sq, sk)
    if causal:
        mask = mask & ((col <= pos) | (col < prefix))
    if window:
        mask = mask & (col > pos - window)
    row_pos = torch.arange(rows) // group
    for k0 in range(0, sk, j_fa_t.BWD256_BK):
        sees = mask[:, k0:k0 + j_fa_t.BWD256_BK].any(1)[row_pos]
        count = torch.zeros(rows, dtype=torch.int64)
        for lo, hi in _tile_slices(rows, group, k0, kv_lim=min(sk_valid, sk),
                                   causal=causal, q_offset=q_offset,
                                   window=window, prefix=prefix,
                                   slices=slices):
            assert lo <= hi
            count[lo:hi] += 1
        assert count.max() <= 1
        assert bool((count[sees] == 1).all()), f"key tile {k0}"
    if case == SLICED[0]:
        assert slices == 2
    if case == SLICED[-1]:
        assert slices == 1
