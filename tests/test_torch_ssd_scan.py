"""The SSD scan kernel's plain PyTorch version against the JAX package's
Pallas kernel in interpret mode, against both packages' sequential oracles
(``ref.ssd_scan_ref``), and its final state ``S_fin`` against the JAX model's
``_ssd_chunked_jnp``, on small shapes: one step, lengths that are not chunk
multiples, and the (N, P) pairs the CUDA kernel is built for.  Each of the
plain version's phases (the kernel's) against a loop over the steps, and a
model of the tensor cores' TF32 rounding against the card's tolerance.

float32 throughout; atol 1e-5 on values of order one (a few units at most):
only the order of the float sums differs.  The CUDA kernel is held against
the same plain version on the card (``tests/test_torch_gpu.py`` and
``chip_smoke.py``) within 1e-4 (1 + |plain|).
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
from repro_torch.kernels.ssd_scan.ssd_scan import (KERNEL_CHUNK,
                                                   STATE_SHAPES, chunk_gram,
                                                   chunk_output,
                                                   chunk_states,
                                                   state_passing)

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
    """The CUDA kernel scans chunks of KERNEL_CHUNK steps whatever the model
    asks for; the function is the same for every chunk length."""
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


# --------------------------------------------------------------------------- #
# The kernel's phases, one by one, against a loop over the steps (float64).   #
# --------------------------------------------------------------------------- #

def _padded(q, x, dt, Bm, Cm):
    """The operands padded to whole chunks of q (dt = 0, zeros), float64."""
    pad = -(-x.shape[2] // q) * q - x.shape[2]
    return (np.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0))).astype(np.float64),
            np.pad(dt, ((0, 0), (0, 0), (0, pad))).astype(np.float64),
            np.pad(Bm, ((0, 0), (0, pad), (0, 0))).astype(np.float64),
            np.pad(Cm, ((0, 0), (0, pad), (0, 0))).astype(np.float64))


def _step(S, A, dt, B, x):
    """S_t = exp(A dt_t) S_{t-1} + dt_t B_t (x) x_t over [b, h, N, P]."""
    return (np.exp(A[None, :] * dt)[..., None, None] * S
            + dt[..., None, None] * B[:, None, :, None] * x[:, :, None, :])


@pytest.mark.parametrize("s", [1, 40, KERNEL_CHUNK, KERNEL_CHUNK + 1, 45])
def test_phases_match_the_one_loop_form(s):
    """G, each chunk's own state and decay, the states before each chunk with
    S_fin, and y: each phase of ssd_chunked_plain against the recurrence run
    step by step, at mamba2's N 128, P 64 and the kernel's chunk, at lengths
    of one step, within a chunk, a whole chunk and one step past it."""
    b, h, p, n, q = 1, 2, 64, 128, KERNEL_CHUNK
    x, dt, A, Bm, Cm = _inputs(s + 7, b, h, s, p, n)
    xp, dtp, Bp, Cp = _padded(q, x, dt, Bm, Cm)
    A64 = A.astype(np.float64)
    steps = xp.shape[2]
    nc = steps // q
    xc, Bc, Cc = (torch.from_numpy(t.astype(np.float32)) for t in (xp, Bp, Cp))
    xc = xc.reshape(b, h, nc, q, p)
    Bc, Cc = Bc.reshape(b, nc, q, n), Cc.reshape(b, nc, q, n)
    dtc = torch.from_numpy(dtp.astype(np.float32)).reshape(b, h, nc, q)
    tA = torch.from_numpy(A)

    G = chunk_gram(Cc, Bc)
    want_G = np.zeros((b, nc, q, q))
    for t in range(steps):
        c = t // q
        want_G[:, c, t % q] = np.einsum("bn,bin->bi", Cp[:, t],
                                        Bp[:, c * q:(c + 1) * q])
    _close(G, want_G)

    dS, decay = chunk_states(xc, dtc, tA, Bc)
    want_dS = np.zeros((b, h, nc, n, p))
    for c in range(nc):                    # the recurrence from zero
        S = np.zeros((b, h, n, p))
        for t in range(c * q, (c + 1) * q):
            S = _step(S, A64, dtp[:, :, t], Bp[:, t], xp[:, :, t])
        want_dS[:, :, c] = S
    _close(dS, want_dS)
    _close(decay, np.exp(A64[None, :, None]
                         * dtp.reshape(b, h, nc, q).sum(-1)))

    S_before, S_fin = state_passing(dS, decay)
    want_before = np.zeros((b, h, nc, n, p))
    want_y = np.zeros((b, h, steps, p))
    S = np.zeros((b, h, n, p))
    for t in range(steps):                 # one loop over every step
        if t % q == 0:
            want_before[:, :, t // q] = S
        S = _step(S, A64, dtp[:, :, t], Bp[:, t], xp[:, :, t])
        want_y[:, :, t] = np.einsum("bn,bhnp->bhp", Cp[:, t], S)
    _close(S_before, want_before)
    _close(S_fin, S)

    y = chunk_output(G, xc, dtc, tA, Cc, S_before)
    _close(y.reshape(b, h, steps, p), want_y)
    y_all, s_all = ssd_chunked_plain(*_t(x, dt, A, Bm, Cm), q)
    _close(y_all, want_y[:, :, :s])
    _close(s_all, S)


# --------------------------------------------------------------------------- #
# The kernel's products on the tensor cores: a plain-PyTorch model of TF32.   #
# --------------------------------------------------------------------------- #

SSD_TOL = 1e-4    # the card's check: |kernel - plain| <= 1e-4 (1 + |plain|)


def _tf32(x):
    """cvt.rna.tf32.f32: the float32 bits rounded to a 10-bit mantissa, to
    nearest with ties away from zero (the kernel's integer form of it)."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(
        torch.float32)


def _mm_tf32(a, b):
    """One TF32 product with an fp32 sum: each operand rounded once."""
    return _tf32(a) @ _tf32(b)


def _mm_3xtf32(a, b):
    """The kernel's 3xTF32: hi = tf32(v), lo = tf32(v - hi) for each operand,
    lo·hi + hi·lo + hi·hi summed in fp32 (lo·lo dropped)."""
    ah, bh = _tf32(a), _tf32(b)
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


def _tolerance_used(mm):
    """The largest |model - plain| / (1e-4 (1 + |plain|)) over y and S_fin at
    mamba2's N 128, P 64, the kernel's chunk and the card's input scales."""
    args = _t(*_inputs(17, 2, 4, 256, 64, 128))
    y, s_fin = ssd_chunked_plain(*args, KERNEL_CHUNK)
    y_m, s_m = ssd_chunked_plain(*args, KERNEL_CHUNK, mm=mm)
    return max(float(((got - want).abs()
                      / (SSD_TOL * (1 + want.abs()))).max())
               for got, want in ((y_m, y), (s_m, s_fin)))


def test_tf32_model_rounds_as_cvt_rna():
    one = 1.0 + 2.0 ** -10                           # a TF32 value
    x = torch.tensor([1.0, one, 1 + 2.0 ** -11, 1 + 2.0 ** -12,
                      -(1 + 2.0 ** -11), 3.0 * 2 ** -20], dtype=torch.float32)
    want = torch.tensor([1.0, one, 1 + 2.0 ** -10, 1.0, -(1 + 2.0 ** -10),
                         3.0 * 2 ** -20], dtype=torch.float32)
    assert torch.equal(_tf32(x), want)


def test_three_tf32_products_hold_the_cards_ssd_tolerance():
    """Why the kernel keeps three products: 3xTF32 stays far inside the
    card's 1e-4 (1 + |plain|)."""
    assert _tolerance_used(_mm_3xtf32) < 0.1


def test_one_tf32_product_would_leave_the_cards_ssd_tolerance():
    """One TF32 product errs by 2^-11 of each operand: summed over K = 64 and
    128 it breaks 1e-4 (1 + |plain|), so the kernel may not take it."""
    assert _tolerance_used(_mm_tf32) > 1
