"""The SSD scan kernel's plain PyTorch version against the JAX package's
Pallas kernel in interpret mode, against both packages' sequential oracles
(``ref.ssd_scan_ref``), and its final state ``S_fin`` against the JAX model's
``_ssd_chunked_jnp``, on small shapes: one step, lengths that are not chunk
multiples, and the (N, P) pairs the CUDA kernel is built for.

float32 throughout; atol 1e-5 on values of order one (a few units at most):
only the order of the float sums differs.  The CUDA kernel is held against
the same plain version on the card (``tests/test_torch_gpu.py`` and
``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _jax_ref  # noqa: F401  (jax 0.9 shim before the JAX package)
import jax
import jax.numpy as jnp

from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd
from repro.kernels.ssd_scan.ref import ssd_scan_ref as j_ref
from repro.models.blocks import _ssd_chunked_jnp
from repro_torch.kernels.ssd_scan import (ssd_chunked_plain, ssd_scan,
                                          ssd_scan_chunked, ssd_scan_ref)
from repro_torch.kernels.ssd_scan.ssd_scan import STATE_SHAPES

ATOL = 1e-5

_j_ssd = jax.jit(j_ssd, static_argnames=("chunk", "interpret"))
_j_chunked = jax.jit(_ssd_chunked_jnp, static_argnames=("chunk",))


def _inputs(seed, b, h, s, p, n):
    """Mamba-2's operands: dt > 0 (softplus), A < 0, B and C of unit scale
    over sqrt(N) so that y stays of order one."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, s, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, h, s)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    Bm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    Cm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# (b, h, s, p, n, chunk)
SHAPES = [
    (1, 1, 1, 16, 16, 16),
    (2, 3, 37, 16, 16, 16),
    (1, 2, 64, 32, 32, 32),
    (2, 2, 50, 32, 32, 16),
    (1, 2, 40, 64, 64, 32),
]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_pallas_interpret_and_refs(shape):
    *dims, chunk = shape
    x, dt, A, Bm, Cm = _inputs(sum(shape), *dims)
    tx = _t(x, dt, A, Bm, Cm)
    want = np.asarray(_j_ssd(x, dt, A, Bm, Cm, chunk=chunk, interpret=True))
    y, _ = ssd_scan_chunked(*tx, chunk=chunk)
    _close(y, want)
    _close(ssd_scan(*tx, chunk=chunk), want)
    _close(ssd_scan_ref(*tx), j_ref(*map(jnp.asarray, (x, dt, A, Bm, Cm))))
    _close(ssd_scan(*tx, use_kernel=False), want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_final_state_matches_the_model_twin(shape):
    *dims, chunk = shape
    x, dt, A, Bm, Cm = _inputs(sum(shape) + 1, *dims)
    y_want, s_want = _j_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    y, s_fin = ssd_chunked_plain(*_t(x, dt, A, Bm, Cm), chunk)
    _close(y, y_want)
    _close(s_fin, s_want)


@pytest.mark.parametrize("n, p", STATE_SHAPES)
def test_chunk_length_changes_only_the_sum_order(n, p):
    """The CUDA kernel scans 32-step chunks whatever the model asks for; the
    function is the same for every chunk length."""
    x, dt, A, Bm, Cm = _inputs(n + p, 1, 2, 45, p, n)
    tx = _t(x, dt, A, Bm, Cm)
    y_ref = ssd_scan_ref(*tx)
    y0, s0 = ssd_chunked_plain(*tx, 32)
    for chunk in (8, 16, 64, 128):
        y, s = ssd_chunked_plain(*tx, chunk)
        _close(y, y0)
        _close(s, s0)
    _close(y0, y_ref)


def test_strided_views_give_the_same_result():
    """The model hands the scan views of its projection: x [B, H, S, P] from
    a [B, S, H·P] slice, dt [B, H, S] transposed, B and C column slices."""
    b, h, s, p, n = 2, 3, 21, 16, 16
    x, dt, A, Bm, Cm = _inputs(5, b, h, s, p, n)
    want_y, want_s = ssd_chunked_plain(*_t(x, dt, A, Bm, Cm), 16)
    proj = torch.zeros((b, s, h * p + 2 * n + 3))
    proj[..., :h * p] = _t(x)[0].permute(0, 2, 1, 3).reshape(b, s, h * p)
    proj[..., h * p:h * p + n] = _t(Bm)[0]
    proj[..., h * p + n:h * p + 2 * n] = _t(Cm)[0]
    xv = proj[..., :h * p].reshape(b, s, h, p).transpose(1, 2)
    dtv = _t(dt)[0].transpose(1, 2).contiguous().transpose(1, 2)
    y, s_fin = ssd_scan_chunked(xv, dtv, _t(A)[0], proj[..., h * p:h * p + n],
                                proj[..., h * p + n:h * p + 2 * n], chunk=16)
    _close(y, want_y.numpy())
    _close(s_fin, want_s.numpy())


def test_ssd_scan_rejects_bad_shapes():
    x, dt, A, Bm, Cm = _t(*_inputs(0, 1, 2, 8, 16, 16))
    with pytest.raises(ValueError, match="need x"):
        ssd_scan_chunked(x, dt[:, :1], A, Bm, Cm)
    with pytest.raises(ValueError, match="need x"):
        ssd_scan_chunked(x, dt, A, Bm, Cm[..., :8])
