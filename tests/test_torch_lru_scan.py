"""The RG-LRU scan kernel's plain PyTorch version against the JAX package's
Pallas kernel in interpret mode, against both packages' sequential oracles
(``ref.lru_scan_ref``), and its final state ``h_fin`` against the JAX model's
``_lru_chunked_jnp``, on small shapes: one step, lengths that are not chunk
multiples, and widths 64 to 256.

Kernel 7's own order of operations, a chunked scan (each chunk from zero,
the carries between chunks, each chunk again from its carry) at
``lru_scan.CHUNK``, is modelled here and held against the Pallas kernel in
interpret mode and ``_lru_chunked_jnp`` at lengths around the chunk; the
wrappers' chunk lengths are held to the sources' ``kChunk``.

float32 throughout; gates in (0.5, 0.999), so ``|h|`` reaches about 20.
Held within ``1e-5 (1 + |ref|)``: only the order of the float operations
differs (a doubling scan against a sequential one).  The CUDA kernel is held
against the same plain version on the card (``tests/test_torch_gpu.py`` and
``chip_smoke.py``).
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _jax_ref  # noqa: F401  (jax 0.9 shim before the JAX package)
import jax
import jax.numpy as jnp

from repro.kernels.lru_scan.ops import lru_scan as j_lru
from repro.kernels.lru_scan.ref import lru_scan_ref as j_ref
from repro.models.blocks import _lru_chunked_jnp
from repro_torch.kernels.lru_scan import (lru_chunked_plain, lru_scan,
                                          lru_scan_chunked, lru_scan_ref)

# The package re-exports a function of the module's name: reach the module.
lru_mod = importlib.import_module("repro_torch.kernels.lru_scan.lru_scan")
CHUNK = lru_mod.CHUNK

TOL = dict(rtol=1e-5, atol=1e-5)   # |got - want| <= 1e-5 (1 + |want|)

_j_lru = jax.jit(j_lru, static_argnames=("chunk", "interpret"))
_j_chunked = jax.jit(_lru_chunked_jnp, static_argnames=("chunk",))


def _inputs(seed, b, s, d):
    """The model's operands: gates ``a`` in (0.5, 0.999), inputs ``b`` of
    unit scale."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (b, s, d)).astype(np.float32)
    x = rng.standard_normal((b, s, d), dtype=np.float32)
    return a, x


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, **TOL)


def _model_chunk(s):
    """The chunk the JAX model's ``rglru_apply`` scans with."""
    return min(256, max(16, s))


# (b, s, d): one step, ragged lengths (37, 300) and widths 64-256.
SHAPES = [(2, 1, 64), (2, 37, 64), (1, 300, 128), (2, 37, 256),
          (1, 300, 256)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_pallas_interpret_and_refs(shape):
    a, x = _inputs(sum(shape), *shape)
    ta, tx = _t(a, x)
    want = np.asarray(_j_lru(a, x, chunk=256, interpret=True))
    h, h_fin = lru_scan_chunked(ta, tx, chunk=_model_chunk(shape[1]))
    _close(h, want)
    _close(h_fin, want[:, -1])
    _close(lru_scan(ta, tx), want)
    _close(lru_scan_ref(ta, tx), j_ref(jnp.asarray(a), jnp.asarray(x)))
    _close(lru_scan(ta, tx, use_kernel=False), want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_final_state_matches_the_model_twin(shape):
    a, x = _inputs(sum(shape) + 1, *shape)
    chunk = _model_chunk(shape[1])
    h_want, fin_want = _j_chunked(a, x, chunk=chunk)
    h, h_fin = lru_chunked_plain(*_t(a, x), chunk)
    _close(h, h_want)
    _close(h_fin, fin_want)


@pytest.mark.parametrize("chunk", [1, 8, 16, 64, 256])
def test_chunk_length_changes_only_the_order_of_the_sums(chunk):
    """The CUDA kernel scans sequentially whatever the model asks for; the
    function is the same for every chunk length."""
    ta, tx = _t(*_inputs(chunk, 2, 45, 64))
    h, h_fin = lru_chunked_plain(ta, tx, chunk)
    want = lru_scan_ref(ta, tx)
    _close(h, want)
    _close(h_fin, want[:, -1])


def test_empty_sequence_gives_a_zero_state():
    ta, tx = _t(*_inputs(0, 2, 0, 64))
    h, h_fin = lru_scan_chunked(ta, tx)
    assert h.shape == (2, 0, 64)
    assert torch.equal(h_fin, torch.zeros((2, 64)))


def test_strided_views_give_the_same_result():
    """The kernel reads a and b through their batch and step strides: a
    column slice of a wider tensor and every second step of a longer one."""
    b, s, d = 2, 21, 64
    a, x = _inputs(5, b, s, d)
    want_h, want_fin = lru_chunked_plain(*_t(a, x), 16)
    wide = torch.zeros((b, s, 3 * d))
    wide[..., d:2 * d] = _t(a)[0]
    long = torch.zeros((b, 2 * s, d))
    long[:, ::2] = _t(x)[0]
    av, xv = wide[..., d:2 * d], long[:, ::2]
    assert not av.is_contiguous() and not xv.is_contiguous()
    h, h_fin = lru_scan_chunked(av, xv, chunk=16)
    _close(h, want_h.numpy())
    _close(h_fin, want_fin.numpy())


def test_lru_scan_rejects_bad_shapes_and_dtypes():
    ta, tx = _t(*_inputs(0, 1, 8, 16))
    with pytest.raises(ValueError, match="need two"):
        lru_scan_chunked(ta, tx[:, :4])
    with pytest.raises(ValueError, match="need two"):
        lru_scan_chunked(ta[0], tx[0])
    with pytest.raises(TypeError, match="one dtype"):
        lru_scan_chunked(ta, tx.double())
    with pytest.raises(TypeError, match="one dtype"):
        lru_scan_chunked(ta.to(torch.int32), tx.to(torch.int32))


CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _kernel7_chunked(a, b, chunk):
    """Kernel 7's chunked scan (``csrc/lru_scan.cu``) in its order of
    operations, on float32 tensors: each chunk's end state ``L`` from zero
    and product of its gates ``Pr`` (steps past the end padded with ``a = 1,
    b = 0``); each chunk's incoming state, walking the chunks from the first
    (``h_in(k + 1) = L_k + Pr_k·h_in(k)``); each chunk again from its
    incoming state.  ``h_fin`` is the last chunk's end state, which the
    padded steps leave as the last step's ``h``."""
    bsz, s, d = a.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s
    ac = F.pad(a, (0, 0, 0, pad), value=1.0).reshape(bsz, nc, chunk, d)
    bc = F.pad(b, (0, 0, 0, pad)).reshape(bsz, nc, chunk, d)
    end, prod = torch.zeros((bsz, nc, d)), torch.ones((bsz, nc, d))
    for u in range(chunk):
        end = ac[:, :, u] * end + bc[:, :, u]
        prod = prod * ac[:, :, u]
    h_in, carry = torch.empty((bsz, nc, d)), torch.zeros((bsz, d))
    for k in range(nc):
        h_in[:, k] = carry
        carry = end[:, k] + prod[:, k] * carry
    hv, steps = h_in, []
    for u in range(chunk):
        hv = ac[:, :, u] * hv + bc[:, :, u]
        steps.append(hv)
    h = torch.stack(steps, 2).reshape(bsz, nc * chunk, d)[:, :s]
    return h, hv[:, -1]


@pytest.mark.parametrize("extra", [0, 1, 2, 3, 4])
def test_kernel7_chunked_order_matches_pallas_interpret_and_the_twin(extra):
    """Lengths 1, CHUNK - 1, CHUNK, CHUNK + 1 and 3 CHUNK + 5 around kernel
    7's chunk: the local / carry / fix-up decomposition against the JAX
    kernel in interpret mode and ``_lru_chunked_jnp``, within 1e-5 (1 +
    |ref|) (float32 in another order); ``h_fin`` is its last step's ``h``
    bit for bit, as the kernel writes it."""
    s = (1, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 5)[extra]
    a, x = _inputs(s + 7, 2, s, 64)
    h, h_fin = _kernel7_chunked(*_t(a, x), CHUNK)
    _close(h, np.asarray(_j_lru(a, x, chunk=256, interpret=True)))
    h_want, fin_want = _j_chunked(a, x, chunk=_model_chunk(s))
    _close(h, h_want)
    _close(h_fin, fin_want)
    assert torch.equal(h_fin, h[:, -1])


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{source} defines no {name}"
    return int(m.group(1))


@pytest.mark.parametrize("source, attr", [("lru_scan.cu", "CHUNK"),
                                          ("lru_scan_bwd.cu", "BWD_CHUNK")])
def test_chunk_lengths_are_the_kernels(source, attr):
    """The wrappers size the kernels' carry scratch by ``CHUNK`` and
    ``BWD_CHUNK``: each must be its source's ``kChunk``."""
    assert getattr(lru_mod, attr) == _constant(source, "kChunk")
