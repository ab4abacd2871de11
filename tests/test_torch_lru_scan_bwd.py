"""The RG-LRU scan's gradient in the port: the plain backward
(``lru_backward_plain``, the reverse recurrence written out) against
``jax.grad`` of the JAX model's twin ``_lru_chunked_jnp`` and against
``torch.autograd`` through the plain forward ``lru_chunked_plain``; and
``lru_scan_chunked`` under autograd (the ``_LruScan`` function) on the
CPU, which must give the plain backward's bits.  Shapes: one step, lengths
shorter than, equal to and not a multiple of the chunk (the JAX model's and
kernel 7b's 32), widths 64 to 256, with the final state's gradient given and
None.

float32 throughout, on the operands of ``tests/test_torch_lru_scan.py``
(gates in (0.5, 0.999)).  Tolerance: da and db within 1e-5 of each one's
largest element (float32 sums in other orders; a doubling scan against a
sequential one).  Kernel 7b is held against the same plain version on the
card (``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _jax_ref  # noqa: F401  (jax 0.9 shim before the JAX package)
import jax
import jax.numpy as jnp

from repro.models.blocks import _lru_chunked_jnp
from repro_torch.kernels.lru_scan import (lru_backward_plain,
                                          lru_chunked_plain,
                                          lru_scan_backward,
                                          lru_scan_chunked, lru_scan_ref)
from repro_torch.kernels.lru_scan.lru_scan import BWD_CHUNK

TOL = 1e-5   # share of each gradient's largest element


def _inputs(seed, b, s, d):
    """Gates ``a`` in (0.5, 0.999), inputs ``x``, and the gradients ``dh``
    and ``dh_fin``, of unit scale."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (b, s, d)).astype(np.float32)
    x = rng.standard_normal((b, s, d), dtype=np.float32)
    dh = rng.standard_normal((b, s, d), dtype=np.float32)
    dh_fin = rng.standard_normal((b, d), dtype=np.float32)
    return a, x, dh, dh_fin


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _model_chunk(s):
    """The chunk the JAX model's ``rglru_apply`` scans with."""
    return min(256, max(16, s))


def _close(got, want, what=""):
    for name, g, w in zip(("da", "db"), got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w, dtype=np.float64)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        scale = max(np.abs(w).max(initial=0.0), 1e-30)
        err = np.abs(g - w).max(initial=0.0) / scale
        assert err <= TOL, f"{what}{name}: {err}"


# (b, s, d): one step; 31 (shorter than kernel 7b's chunk of 32), 32, 37
# and 300 (ragged), 256 (the model's chunk); widths 64-256.
SHAPES = [(2, 1, 64), (2, 31, 64), (1, 32, 128), (2, 37, 64),
          (1, 256, 128), (1, 300, 256)]


@pytest.mark.parametrize("final", [False, True], ids=["no-dh_fin", "dh_fin"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_jax_grad_of_the_model_twin(shape, final):
    a, x, dh, dh_fin = _inputs(sum(shape), *shape)
    chunk = _model_chunk(shape[1])

    def f(a, x):
        h, h_fin = _lru_chunked_jnp(a, x, chunk)
        out = jnp.sum(h * dh)
        return out + jnp.sum(h_fin * dh_fin) if final else out
    want = jax.grad(f, argnums=(0, 1))(a, x)
    h = lru_scan_ref(*_t(a, x))
    for c in (chunk, BWD_CHUNK):
        got = lru_backward_plain(_t(a)[0], h, *_t(dh),
                                 _t(dh_fin)[0] if final else None, c)
        _close(got, want, f"chunk {c}: ")


@pytest.mark.parametrize("final", [False, True], ids=["no-dh_fin", "dh_fin"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_autograd_of_the_plain_forward(shape, final):
    a, x, dh, dh_fin = _inputs(sum(shape) + 1, *shape)
    ta, tx = (t.requires_grad_(True) for t in _t(a, x))
    tdh, tfin = _t(dh, dh_fin)
    chunk = _model_chunk(shape[1])
    h, h_fin = lru_chunked_plain(ta, tx, chunk)
    loss = (h * tdh).sum() + ((h_fin * tfin).sum() if final else 0.0)
    want = [g.numpy() for g in torch.autograd.grad(loss, (ta, tx))]
    got = lru_backward_plain(ta.detach(), h.detach(), tdh,
                             tfin if final else None, chunk)
    _close(got, want)


@pytest.mark.parametrize("final", [False, True], ids=["no-dh_fin", "dh_fin"])
@pytest.mark.parametrize("shape", SHAPES[1::2], ids=str)
def test_autograd_through_the_wrapper_takes_the_plain_backward(shape, final):
    """``lru_scan_chunked`` on operands that require grad goes through
    ``_LruScan``; on the CPU its gradients are ``lru_scan_backward``'s, bit
    for bit, and an unused final state is a zero gradient."""
    a, x, dh, dh_fin = _inputs(sum(shape) + 2, *shape)
    ta, tx = (t.requires_grad_(True) for t in _t(a, x))
    tdh, tfin = _t(dh, dh_fin)
    chunk = _model_chunk(shape[1])
    h, h_fin = lru_scan_chunked(ta, tx, chunk=chunk)
    assert "LruScan" in type(h.grad_fn).__name__
    loss = (h * tdh).sum() + ((h_fin * tfin).sum() if final else 0.0)
    got = torch.autograd.grad(loss, (ta, tx))
    want = lru_scan_backward(ta.detach(), h.detach(), tdh,
                             tfin if final else None, chunk=chunk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_the_first_step_has_no_gate_gradient():
    """``da_0 = g_0·h_{−1}`` with ``h_{−1} = 0``."""
    a, x, dh, dh_fin = _t(*_inputs(4, 2, 9, 64))
    h = lru_scan_ref(a, x)
    da, db = lru_backward_plain(a, h, dh, dh_fin)
    assert not da[:, 0].any() and db[:, 0].abs().sum() > 0


def test_backward_rejects_bad_gradient_shapes():
    a, x, dh, dh_fin = _t(*_inputs(0, 1, 8, 16))
    with pytest.raises(ValueError, match="need"):
        lru_scan_backward(a, a, dh[:, :4])
    with pytest.raises(ValueError, match="need"):
        lru_scan_backward(a, a, dh, dh_fin[:, :4])
