"""The SSD scan's gradient in the port: the plain backward
(``ssd_backward_plain``, kernel 6b's phases) against ``jax.grad`` of the JAX
model's twin ``_ssd_chunked_jnp`` and against ``torch.autograd`` through the
plain forward ``ssd_chunked_plain``; and ``ssd_scan_chunked`` under autograd
(the ``_SsdScan`` function) on the CPU, which must give the plain backward's
bits.  Shapes: one step, lengths shorter than, equal to and not a multiple
of the chunk, the JAX model's chunk and the kernel's (64), every (N, P) the
CUDA kernels are built for, with the final state's gradient given and None.

Kernel 6b's order of dB's and dC's sums (the terms linear in dG summed over
the heads before one product with C and B) is modelled here and held
against ``jax.grad`` too.

float32 throughout, on the operands of ``tests/test_torch_ssd_scan.py``.
Tolerances, as a share of each gradient's largest element:

- dx, ddt, dB and dC within 1e-5 (measured: below 4.2e-6): float32 sums in
  other orders;
- dA within 1e-4 (measured: up to 1.5e-5 against ``jax.grad``): each head's
  one number sums B·S·N·P products of both signs whose magnitudes exceed
  the sum's, so both packages' float32 rounding, relative to those terms,
  shows larger against the sum.

Kernel 6b is held against the same plain version on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _jax_ref  # noqa: F401  (jax 0.9 shim before the JAX package)
import jax
import jax.numpy as jnp

from repro.models.blocks import _ssd_chunked_jnp
from repro_torch.kernels.ssd_scan import (ssd_backward_plain,
                                          ssd_chunked_plain,
                                          ssd_scan_backward,
                                          ssd_scan_chunked)
from repro_torch.kernels.ssd_scan.ssd_scan import (KERNEL_CHUNK, STATE_SHAPES,
                                                   _chunks, chunk_gram,
                                                   chunk_states,
                                                   state_passing,
                                                   state_passing_backward)

TOL = 1e-5      # dx, ddt, dB, dC: share of the largest element
DA_TOL = 1e-4   # dA (module docstring)
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _inputs(seed, b, h, s, p, n):
    """Mamba-2's operands (dt > 0, A < 0, B and C of unit scale over
    sqrt(N)), an output gradient dy and a final-state gradient dS."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, s, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, h, s)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    Bm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    Cm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    dy = rng.standard_normal((b, h, s, p), dtype=np.float32)
    dS = rng.standard_normal((b, h, n, p), dtype=np.float32)
    return x, dt, A, Bm, Cm, dy, dS


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _model_chunk(s):
    """The chunk the JAX model's ``mamba_apply`` scans with."""
    return min(128, max(16, s))


def _close(got, want, what=""):
    for name, g, w in zip(NAMES, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w, dtype=np.float64)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        scale = max(np.abs(w).max(initial=0.0), 1e-30)
        err = np.abs(g - w).max(initial=0.0) / scale
        assert err <= (DA_TOL if name == "dA" else TOL), f"{what}{name}: {err}"


def _jax_grads(x, dt, A, Bm, Cm, dy, dS, chunk):
    def f(x, dt, A, Bm, Cm):
        y, s_fin = _ssd_chunked_jnp(x, dt, A, Bm, Cm, chunk)
        out = jnp.sum(y * dy)
        return out if dS is None else out + jnp.sum(s_fin * dS)
    return jax.grad(f, argnums=(0, 1, 2, 3, 4))(x, dt, A, Bm, Cm)


# (b, h, s, p, n): one step; 37 and 50 (shorter than the model's chunk of
# 128 and not a multiple of 64); 64 (the kernel's chunk); 130 and 300 (past
# one chunk, ragged); every built (N, P).
SHAPES = [(1, 1, 1, 16, 16), (2, 3, 37, 16, 16), (1, 2, 64, 32, 32),
          (2, 2, 50, 32, 32), (1, 2, 40, 64, 64), (1, 2, 130, 64, 128),
          (2, 2, 300, 64, 128)]


@pytest.mark.parametrize("final", [False, True], ids=["no-dS", "dS"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_jax_grad_of_the_model_twin(shape, final):
    """At the JAX model's chunk and at the kernel's (64): the chunk changes
    only the order of the sums."""
    x, dt, A, Bm, Cm, dy, dS = _inputs(sum(shape), *shape)
    dS = dS if final else None
    want = _jax_grads(x, dt, A, Bm, Cm, dy, dS, _model_chunk(shape[2]))
    for chunk in (_model_chunk(shape[2]), KERNEL_CHUNK):
        got = ssd_backward_plain(*_t(x, dt, A, Bm, Cm, dy),
                                 None if dS is None else _t(dS)[0],
                                 chunk=chunk)
        _close(got, want, f"chunk {chunk}: ")


@pytest.mark.parametrize("final", [False, True], ids=["no-dS", "dS"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_autograd_of_the_plain_forward(shape, final):
    x, dt, A, Bm, Cm, dy, dS = _inputs(sum(shape) + 1, *shape)
    ops = [t.requires_grad_(True) for t in _t(x, dt, A, Bm, Cm)]
    tdy, tdS = _t(dy, dS)
    chunk = _model_chunk(shape[2])
    y, s_fin = ssd_chunked_plain(*ops, chunk)
    loss = (y * tdy).sum() + ((s_fin * tdS).sum() if final else 0.0)
    want = [g.numpy() for g in torch.autograd.grad(loss, ops)]
    got = ssd_backward_plain(*[t.detach() for t in ops], tdy,
                             tdS if final else None, chunk=chunk)
    _close(got, want)


@pytest.mark.parametrize("final", [False, True], ids=["no-dS", "dS"])
@pytest.mark.parametrize("shape", SHAPES[1::2], ids=str)
def test_autograd_through_the_wrapper_takes_the_plain_backward(shape, final):
    """``ssd_scan_chunked`` on operands that require grad goes through
    ``_SsdScan``; on the CPU its gradients are ``ssd_backward_plain``'s,
    bit for bit, and an unused final state is a zero gradient."""
    x, dt, A, Bm, Cm, dy, dS = _inputs(sum(shape) + 2, *shape)
    ops = [t.requires_grad_(True) for t in _t(x, dt, A, Bm, Cm)]
    tdy, tdS = _t(dy, dS)
    chunk = _model_chunk(shape[2])
    y, s_fin = ssd_scan_chunked(*ops, chunk=chunk)
    assert y.grad_fn is not None and "SsdScan" in type(y.grad_fn).__name__
    loss = (y * tdy).sum() + ((s_fin * tdS).sum() if final else 0.0)
    got = torch.autograd.grad(loss, ops)
    want = ssd_scan_backward(*[t.detach() for t in ops], tdy,
                             tdS if final else None, chunk=chunk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_reverse_state_passing_matches_a_loop_over_the_steps():
    """``state_passing_backward``'s gradient of the state after each chunk
    against the recurrence's, step by step: with ``g_t`` the gradient that
    reaches ``S_t`` from the steps after t (``g_{S−1} = dS_fin``),
    ``g_{t−1} = exp(A·dt_t)·(g_t + C_t ⊗ dy_t)``; the state after chunk c is
    ``S_t`` at its last step."""
    b, h, s, p, n, q = 2, 2, 48, 16, 16, 16
    x, dt, A, Bm, Cm, dy, dS = _t(*_inputs(3, b, h, s, p, n))
    nc = s // q
    after = state_passing_backward(
        dy.reshape(b, h, nc, q, p), dt.reshape(b, h, nc, q), A,
        Cm.reshape(b, nc, q, n), dS)
    g = dS.clone()
    for t in range(s - 1, -1, -1):
        if (t + 1) % q == 0:
            torch.testing.assert_close(after[:, :, t // q], g, rtol=1e-5,
                                       atol=1e-5)
        decay = torch.exp(A[None, :] * dt[:, :, t])[..., None, None]
        g = decay * (g + Cm[:, None, t, :, None] * dy[:, :, t, None, :])


def test_every_built_state_shape_is_covered():
    assert {(n, p) for *_, p, n in SHAPES} == set(STATE_SHAPES)


def test_backward_rejects_bad_gradient_shapes():
    x, dt, A, Bm, Cm, dy, dS = _t(*_inputs(0, 1, 2, 8, 16, 16))
    with pytest.raises(ValueError, match="dy"):
        ssd_scan_backward(x, dt, A, Bm, Cm, dy[:, :, :4], chunk=16)
    with pytest.raises(ValueError, match="dS_fin"):
        ssd_scan_backward(x, dt, A, Bm, Cm, dy, dS[..., :8], chunk=16)


def _chunk_pass_dB_dC(x, dt, A, Bm, Cm, dy, dS, chunk):
    """dB and dC in kernel 6b's chunk-pass order: the terms linear in dG
    summed over the heads first, in head order, and multiplied by B and C
    once, dC = (Σ_h dG_h)·B + Σ_h e_h ∘ (dy_h·S_cᵀ) and dB = (Σ_h dG_h)ᵀ·C +
    Σ_h (w_h ∘ x_h)·Ḡ_{c+1}ᵀ, each head's terms added in head order."""
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    xc, dtc, Bc, Cc, dyc = _chunks(x, dt, Bm, Cm, chunk, dy)
    A = A.float()
    q = chunk
    dS_, decay = chunk_states(xc, dtc, A, Bc)
    S_before, _ = state_passing(dS_, decay)
    G_after = state_passing_backward(dyc, dtc, A, Cc, dS)
    G = chunk_gram(Cc, Bc)
    causal = torch.ones((q, q), dtype=torch.bool).tril()
    cdt = torch.cumsum(dtc, dim=-1)
    sum_dG = torch.zeros_like(G)
    eT = torch.zeros_like(Bc)
    wV = torch.zeros_like(Bc)
    for hh in range(h):
        a = A[hh]
        ct = cdt[:, hh]
        seg = a * (ct[..., :, None] - ct[..., None, :])
        M = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
        DM = torch.where(causal, dyc[:, hh] @ xc[:, hh].transpose(-1, -2),
                         0.0) * M
        sum_dG = sum_dG + DM * dtc[:, hh, :, None, :]
        e = torch.exp(a * ct)
        w = torch.exp(a * (ct[..., -1:] - ct)) * dtc[:, hh]
        eT = eT + e[..., None] * (dyc[:, hh] @ S_before[:, hh].transpose(-1, -2))
        wV = wV + (w[..., None] * xc[:, hh]) @ G_after[:, hh].transpose(-1, -2)
    dC = sum_dG @ Bc + eT
    dB = sum_dG.transpose(-1, -2) @ Cc + wV
    sp = dtc.shape[2] * chunk
    return (dB.reshape(b, sp, n)[:, :s], dC.reshape(b, sp, n)[:, :s])


@pytest.mark.parametrize("final", [False, True], ids=["no-dS", "dS"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_chunk_pass_order_of_dB_and_dC_matches_jax_grad(shape, final):
    """Kernel 6b's order of dB's and dC's sums against ``jax.grad`` of the
    twin and against the plain backward, within 1e-5 of each one's largest
    element (float32 in other orders)."""
    x, dt, A, Bm, Cm, dy, dS = _inputs(sum(shape) + 3, *shape)
    dS = dS if final else None
    want = _jax_grads(x, dt, A, Bm, Cm, dy, dS, _model_chunk(shape[2]))
    got = _chunk_pass_dB_dC(*_t(x, dt, A, Bm, Cm, dy),
                            None if dS is None else _t(dS)[0], KERNEL_CHUNK)
    plain = ssd_backward_plain(*_t(x, dt, A, Bm, Cm, dy),
                               None if dS is None else _t(dS)[0],
                               chunk=KERNEL_CHUNK)
    for name, g, w, pl in zip(("dB", "dC"), got, want[3:], plain[3:]):
        w = np.asarray(w, dtype=np.float64)
        scale = max(np.abs(w).max(initial=0.0), 1e-30)
        assert np.abs(g.numpy() - w).max(initial=0.0) / scale <= TOL, name
        assert (g - pl).abs().max() / scale <= TOL, name
