"""Mamba-2 SSD chunked scan on the GPU.

Replaces the TPU kernel ``ssd_scan_chunked``
(``src/repro/kernels/ssd_scan/ssd_scan.py:78``), which is also the function
of the JAX model's prefill twin ``_ssd_chunked_jnp``
(``src/repro/models/blocks.py:250``).  Per head, with state ``S [N, P]``::

    S_t = exp(A·dt_t)·S_{t−1} + dt_t·B_t ⊗ x_t,      y_t = C_t·S_t

The CUDA entry ``repro_ssd_scan`` (``csrc/ssd_scan.cu``) runs the SSD
decomposition over chunks of ``KERNEL_CHUNK`` steps in three launches:
``G = C·Bᵀ`` once per (batch, chunk), shared by the heads; the chunk states
and the state passing, one block walking the chunks of a (batch, head) with
the state on chip; each chunk's output, all chunks in parallel.  Its
products run on the tensor cores in 3xTF32 (each operand split into a TF32
high and low part, three products kept).  It writes the final state
``S_fin [B, H, N, P]`` beside ``y``: the model's prefill keeps it in its
cache.  Inputs are float32 and read through their strides, so the model's
``[B, H, S, P]`` view of its projection goes in without a copy; ``y`` is
returned as a ``[B, H, S, P]`` view of a ``[B, S, H, P]`` tensor, the layout
the model reads back.  What bounds it is in the source's note.

:func:`ssd_chunked_plain` is the plain PyTorch version, which a CPU tensor
takes, in the kernel's phases as four functions (:func:`chunk_gram`,
:func:`chunk_states`, :func:`state_passing`, :func:`chunk_output`; the
kernel runs the middle two in one launch).  The chunk length changes only
the order of the float sums, not the function: the kernel's is
``KERNEL_CHUNK`` whatever ``chunk`` says.

Training: when autograd needs a gradient of any operand,
:func:`ssd_scan_chunked` goes through :class:`_SsdScan`.  Its forward runs
the scan above and, on the card, keeps kernel 6's chunk states; its backward
(:func:`ssd_scan_backward`) launches kernel 6b on a CUDA tensor
(``repro_ssd_scan_bwd``, ``csrc/ssd_scan_bwd.cu``, counted in
``BWD_LAUNCHES``) and takes :func:`ssd_backward_plain` on a CPU tensor, in
the kernel's phases (:func:`state_passing_backward`,
:func:`chunk_backward`, then the sums over heads, batch and chunks).  No
kernel of the JAX package computes it: it replaces XLA's autodiff of
``_ssd_chunked_jnp``.

The launches are PyTorch ops, ``repro_torch::ssd_scan`` and
``ssd_scan_bwd`` (:data:`SSD`, :data:`SSD_BWD`), each with a fake implementation (shapes and dtypes only),
a flop formula (:func:`ssd_flops`) and a DTensor sharding rule
(:func:`register_sharding_rules`), so a trace under ``FakeTensorMode``
(``repro_torch.launch.dryrun``) runs the card's path without a card."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from .._build import define_op, launch, ptr

LAUNCHES = 0       # forward scans that launched kernel 6
BWD_LAUNCHES = 0   # calls of ssd_scan_backward that launched kernel 6b
STATE_SHAPES = ((16, 16), (32, 32), (64, 64), (128, 64))  # (N, P) built
# Kernel 6's chunk (64 and 128 are built).  Kernel 6b reads the states of
# the forward's chunks, so it takes the same chunk; it is built for 64 only.
KERNEL_CHUNK = 64


def chunk_gram(Cc, Bc, mm=torch.matmul):
    """``G = C·Bᵀ`` of each (batch, chunk): Cc, Bc ``[b, nc, Q, N]`` →
    ``[b, nc, Q, Q]``, ``G[t, i] = C_t·B_i``."""
    return mm(Cc, Bc.transpose(-1, -2))


def chunk_states(xc, dtc, A, Bc, mm=torch.matmul):
    """Each chunk's own state, from zero at its start, and its decay: xc
    ``[b, h, nc, Q, P]``, dtc ``[b, h, nc, Q]``, A ``[h]``, Bc ``[b, nc, Q,
    N]`` → ``(dS [b, h, nc, N, P], decay [b, h, nc])`` with ``dS = Σ_i B_i ⊗
    exp(A·(cdt_last − cdt_i))·dt_i·x_i`` and ``decay = exp(A·cdt_last)``."""
    cdt = torch.cumsum(dtc, dim=-1)
    a = A[None, :, None, None]
    last = cdt[..., -1:]
    w = torch.exp(a * (last - cdt)) * dtc                    # [b, h, nc, Q]
    dS = mm(Bc[:, None].transpose(-1, -2), xc * w[..., None])
    return dS, torch.exp(a[..., 0] * last[..., 0])


def state_passing(dS, decay):
    """The state before each chunk and the final state: ``S_0 = 0``,
    ``S_c = decay_{c−1}·S_{c−1} + dS_{c−1}`` → ``(S_before [b, h, nc, N, P],
    S_fin [b, h, N, P])``."""
    S = dS.new_zeros(dS.shape[:2] + dS.shape[3:])
    before = torch.empty_like(dS)
    for c in range(dS.shape[2]):
        before[:, :, c] = S
        S = decay[:, :, c, None, None] * S + dS[:, :, c]
    return before, S


def chunk_output(G, xc, dtc, A, Cc, S_before, mm=torch.matmul):
    """y of each chunk: ``y[t] = Σ_{i≤t} G[t, i]·exp(A·(cdt_t − cdt_i))·dt_i
    ·x_i + exp(A·cdt_t)·C_t·S_before`` → ``[b, h, nc, Q, P]``.  The mask
    comes before the exp, whose argument is positive past the diagonal."""
    q = dtc.shape[-1]
    cdt = torch.cumsum(dtc, dim=-1)
    a = A[None, :, None, None]
    causal = torch.ones((q, q), dtype=torch.bool, device=dtc.device).tril()
    seg = a[..., None] * (cdt[..., :, None] - cdt[..., None, :])
    W = torch.where(causal, G[:, None] * torch.exp(torch.where(causal, seg, 0.0))
                    * dtc[..., None, :], 0.0)                # [b, h, nc, Q, Q]
    Cd = torch.exp(a * cdt)[..., None] * Cc[:, None]         # [b, h, nc, Q, N]
    return mm(W, xc) + mm(Cd, S_before)


def _chunks(x, dt, Bm, Cm, chunk: int, *more):
    """The operands cut into chunks of ``chunk`` steps, the last padded with
    ``dt = 0`` and zeros: ``(xc [b, h, nc, Q, P], dtc [b, h, nc, Q], Bc, Cc
    [b, nc, Q, N], *more)``, each of ``more`` shaped as x."""
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    xc, *mc = (F.pad(t.float(), (0, 0, 0, pad)).reshape(b, h, nc, chunk, p)
               for t in (x, *more))
    dtc = F.pad(dt.float(), (0, pad)).reshape(b, h, nc, chunk)
    Bc, Cc = (F.pad(t.float(), (0, 0, 0, pad)).reshape(b, nc, chunk, n)
              for t in (Bm, Cm))
    return (xc, dtc, Bc, Cc, *mc)


def ssd_chunked_plain(x, dt, A, Bm, Cm, chunk: int, mm=torch.matmul):
    """x [B,H,S,P], dt [B,H,S], A [H], Bm/Cm [B,S,N] → (y [B,H,S,P] float32,
    S_fin [B,H,N,P] float32), in chunks of ``chunk`` steps (the last one
    padded with ``dt = 0``), phase by phase as the kernel runs them.  ``mm``
    computes every product of two operands (the tests pass models of the
    tensor cores' rounding)."""
    b, h, s, p = x.shape
    xc, dtc, Bc, Cc = _chunks(x, dt, Bm, Cm, chunk)
    A = A.float()
    G = chunk_gram(Cc, Bc, mm)
    dS, decay = chunk_states(xc, dtc, A, Bc, mm)
    S_before, S_fin = state_passing(dS, decay)
    y = chunk_output(G, xc, dtc, A, Cc, S_before, mm)
    return y.reshape(b, h, dtc.shape[2] * chunk, p)[:, :, :s], S_fin


def state_passing_backward(dyc, dtc, A, Cc, dS_fin, mm=torch.matmul):
    """The reverse state passing: the gradient of the state after each
    chunk, ``Ḡ_{c+1}`` → ``[b, h, nc, N, P]``, from ``Ḡ_{nc} = dS_fin``
    (None: zero) and ``Ḡ_c = exp(A·cdt_last)·Ḡ_{c+1} + Σ_t exp(A·cdt_t)·C_t
    ⊗ dy_t`` over chunk c's steps."""
    cdt = torch.cumsum(dtc, dim=-1)
    a = A[None, :, None, None]
    decay = torch.exp(a[..., 0] * cdt[..., -1])              # [b, h, nc]
    Ce = torch.exp(a * cdt)[..., None] * Cc[:, None]         # [b, h, nc, Q, N]
    inflow = mm(Ce.transpose(-1, -2), dyc)                   # [b, h, nc, N, P]
    after = torch.empty_like(inflow)
    g = (torch.zeros_like(inflow[:, :, 0]) if dS_fin is None
         else dS_fin.float().expand_as(inflow[:, :, 0]))
    for c in range(inflow.shape[2] - 1, -1, -1):
        after[:, :, c] = g
        g = decay[:, :, c, None, None] * g + inflow[:, :, c]
    return after


def chunk_backward(G, xc, dtc, A, Bc, Cc, S_before, G_after, dyc,
                   mm=torch.matmul):
    """Each chunk's gradients, from the forward's ``G = C·Bᵀ`` and state
    before the chunk ``S_before`` and the gradient of the state after it
    ``G_after`` (:func:`state_passing_backward`): → ``(dx [b, h, nc, Q, P],
    ddt [b, h, nc, Q], dA [b, h, nc], dB, dC [b, h, nc, Q, N])``, dA, dB and
    dC per head and chunk (summed by the caller).  The forward of a chunk
    (:func:`chunk_output`, :func:`chunk_states`) is

        y_t = Σ_{i≤t} G[t,i]·M[t,i]·dt_i·x_i + e_t·C_t·S_before,
        S_after = decay·S_before + Σ_i w_i·B_i ⊗ x_i,

    with ``M[t,i] = exp(A·(cdt_t − cdt_i))``, ``e_t = exp(A·cdt_t)``,
    ``w_i = exp(A·(cdt_last − cdt_i))·dt_i`` and ``decay = exp(A·cdt_last)``.
    Each exponent's gradient goes to ``cdt`` (then to dt by a reverse cumsum
    within the chunk) and to ``A``.  The mask comes before the exp, as in the
    forward: past the diagonal its argument is positive."""
    q = dtc.shape[-1]
    cdt = torch.cumsum(dtc, dim=-1)
    a = A[None, :, None, None]
    last = cdt[..., -1:]
    causal = torch.ones((q, q), dtype=torch.bool, device=dtc.device).tril()
    seg = a[..., None] * (cdt[..., :, None] - cdt[..., None, :])
    M = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
    Gh = G[:, None]                                          # [b, 1, nc, Q, Q]
    W = Gh * M * dtc[..., None, :]
    e = torch.exp(a * cdt)
    ew = torch.exp(a * (last - cdt))
    w = ew * dtc
    decay = torch.exp(a[..., 0] * last[..., 0])              # [b, h, nc]
    DM = torch.where(causal, mm(dyc, xc.transpose(-1, -2)), 0.0) * M
    dG = DM * dtc[..., None, :]                              # dL/dG per head
    U = mm(Bc[:, None], G_after)                             # B·Ḡ [.., Q, P]
    T = mm(dyc, S_before.transpose(-1, -2))                  # dy·Sᵀ [.., Q, N]
    V = mm(xc, G_after.transpose(-1, -2))                    # x·Ḡᵀ [.., Q, N]
    dx = mm(W.transpose(-1, -2), dyc) + w[..., None] * U
    dC = mm(dG, Bc[:, None]) + e[..., None] * T
    dB = mm(dG.transpose(-1, -2), Cc[:, None]) + w[..., None] * V
    de = (Cc[:, None] * T).sum(-1)                           # dL/de_t
    dw = (xc * U).sum(-1)                                    # dL/dw_i
    ddecay = (G_after * S_before).sum((-1, -2))
    R = DM * Gh                                              # dL/dW ∘ W / dt
    dseg = R * dtc[..., None, :]                             # dL/dseg
    row, col = dseg.sum(-1), dseg.sum(-2)
    dZc, dZw, dZd = de * e, dw * w, ddecay * decay
    dcdt = a * (row - col + dZc - dZw)
    dcdt[..., -1] += a[..., 0] * (dZw.sum(-1) + dZd)
    ddt = (R.sum(-2) + dw * ew
           + torch.flip(torch.cumsum(torch.flip(dcdt, (-1,)), -1), (-1,)))
    dA = (((row - col + dZc) * cdt).sum(-1) + (dZw * (last - cdt)).sum(-1)
          + dZd * last[..., 0])
    return dx, ddt, dA, dB, dC


def ssd_backward_plain(x, dt, A, Bm, Cm, dy, dS_fin=None, *, chunk: int,
                       mm=torch.matmul):
    """The SSD scan's gradients, phase by phase as kernel 6b runs them:
    x [B,H,S,P], dt [B,H,S], A [H], Bm/Cm [B,S,N], the output gradient dy
    [B,H,S,P] and the final state's dS_fin [B,H,N,P] (None: zero) → ``(dx,
    ddt, dA, dB, dC)`` float32 in the operands' shapes.  The forward's
    intermediates are computed anew in chunks of ``chunk``: G and the state
    before each chunk; then the reverse state passing
    (:func:`state_passing_backward`), each chunk's gradients
    (:func:`chunk_backward`), and the sums: dB and dC over the heads (B and
    C have no head axis), dA over batch and chunks."""
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    xc, dtc, Bc, Cc, dyc = _chunks(x, dt, Bm, Cm, chunk, dy)
    A = A.float()
    G = chunk_gram(Cc, Bc, mm)
    dS, decay = chunk_states(xc, dtc, A, Bc, mm)
    S_before, _ = state_passing(dS, decay)
    G_after = state_passing_backward(dyc, dtc, A, Cc, dS_fin, mm)
    dx, ddt, dA, dB, dC = chunk_backward(G, xc, dtc, A, Bc, Cc, S_before,
                                         G_after, dyc, mm)
    sp = dtc.shape[2] * chunk
    return (dx.reshape(b, h, sp, p)[:, :, :s],
            ddt.reshape(b, h, sp)[:, :, :s],
            dA.sum((0, 2)),
            dB.sum(1).reshape(b, sp, n)[:, :s],
            dC.sum(1).reshape(b, sp, n)[:, :s])


def _check_operands(x, dt, A, Bm, Cm) -> None:
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    if (tuple(dt.shape) != (b, h, s) or tuple(A.shape) != (h,)
            or tuple(Bm.shape) != (b, s, n) or Cm.shape != Bm.shape):
        raise ValueError(
            f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}: "
            "need x [B,H,S,P], dt [B,H,S], A [H], B and C [B,S,N]")


def _require_kernel_operands(what: str, *ts) -> None:
    """Raise unless every given tensor (None: none) is float32 on CUDA."""
    for t in ts:
        if t is not None and (not t.is_cuda or t.dtype != torch.float32):
            raise ValueError(f"{what}: the kernel takes float32 CUDA "
                             f"tensors, got {t.device} {t.dtype}")


def ssd_scan_chunked(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """The SSD scan with its final state: → ``(y [B,H,S,P], S_fin
    [B,H,N,P])``, both float32.  A CPU tensor takes
    :func:`ssd_chunked_plain` with ``chunk``; a CUDA tensor launches the
    kernels (chunks of ``KERNEL_CHUNK``) or raises.  When autograd needs a
    gradient of any operand the call goes through :class:`_SsdScan` (kernel
    6b backward on the card)."""
    _check_operands(x, dt, A, Bm, Cm)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm)):
        return _SsdScan.apply(x, dt, A, Bm, Cm, chunk)
    return _forward(x, dt, A, Bm, Cm, chunk)[:2]


def _forward(x, dt, A, Bm, Cm, chunk: int):
    """:func:`ssd_scan_chunked` without autograd: ``(y, S_fin, states)``,
    ``states`` kernel 6's ``[B, H, nc, N, P]`` state before each chunk of
    ``KERNEL_CHUNK`` (chunk 0's left unwritten; None on the CPU)."""
    if x.device.type == "cpu":
        return (*ssd_chunked_plain(x, dt, A, Bm, Cm, chunk), None)
    return SSD(x, dt, A, Bm, Cm)


def _ssd_scan(x, dt, A, Bm, Cm):
    """Kernel 6: ``(y, S_fin, states)`` as :func:`_forward` gives them."""
    return _launch(x, dt, A, Bm, Cm)


def _ssd_scan_fake(x, dt, A, Bm, Cm):
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    nc = -(-s // KERNEL_CHUNK)
    f32 = dict(dtype=torch.float32)
    return (x.new_empty((b, s, h, p), **f32).transpose(1, 2),
            x.new_empty((b, h, n, p), **f32),
            x.new_empty((b, h, nc, n, p), **f32))


SSD = define_op("ssd_scan(Tensor x, Tensor dt, Tensor A, Tensor Bm, "
                "Tensor Cm) -> (Tensor, Tensor, Tensor)", _ssd_scan,
                _ssd_scan_fake)


def register_sharding_rules() -> None:
    """Kernels 6 and 6b with DTensor operands: local on the batch (A
    replicated; the backward's dA a partial sum over it) and on the heads
    (B and C replicated; dB and dC partial sums over them)."""
    from .._sharding import register
    ops = torch.ops.repro_torch
    register(ops.ssd_scan.default,
             {"batch": ((0, 0, None, 0, 0), (0, 0, 0)),
              "heads": ((1, 1, 0, None, None), (1, 1, 1))})
    register(ops.ssd_scan_bwd.default,
             {"batch": ((0, 0, None, 0, 0, 0, 0, 0),
                        (0, 0, "partial", 0, 0)),
              "heads": ((1, 1, 0, None, None, 1, 1, 1),
                        (1, 1, 0, "partial", "partial"))})


def _launch(x, dt, A, Bm, Cm):
    global LAUNCHES
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    _require_kernel_operands("ssd_scan", x, dt, A, Bm, Cm)
    for t in (x, Bm, Cm):
        if t.stride(-1) != 1:
            raise ValueError("ssd_scan: x, B and C need a contiguous last dim")
    if (n, p) not in STATE_SHAPES:
        raise ValueError(f"ssd_scan: the kernel is built for (N, P) in "
                         f"{STATE_SHAPES}, got {(n, p)}")
    A = A.contiguous()
    y = torch.empty((b, s, h, p), dtype=torch.float32,
                    device=x.device).transpose(1, 2)
    s_fin = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    q = KERNEL_CHUNK
    nc = -(-s // q)
    g = torch.empty((b, nc, q, q), dtype=torch.float32, device=x.device)
    states = torch.empty((b, h, nc, n, p), dtype=torch.float32,
                         device=x.device)
    launch("repro_ssd_scan", x.device,
           ptr(x), *x.stride()[:3], ptr(dt), *dt.stride(), ptr(A),
           ptr(Bm), *Bm.stride()[:2], ptr(Cm), *Cm.stride()[:2],
           ptr(y), *y.stride()[:3], ptr(s_fin), ptr(g), ptr(states),
           b, h, s, n, p, q)
    LAUNCHES += 1
    return y, s_fin, states


def ssd_flops(x_shape, n: int, *, backward: bool = False) -> int:
    """The floating-point operations of the function kernels 6 and 6b
    compute: the SSD decomposition's matrix products over ``nc = ceil(S /
    Q)`` chunks of the kernels' ``Q = KERNEL_CHUNK`` steps, for x ``[B, H,
    S, P]`` and a state of ``N``.  Forward: ``G = C·Bᵀ`` a (batch, chunk),
    ``2·Q²·N``; a (batch, head, chunk) the diagonal block ``(G∘L)·X``,
    ``2·Q²·P``, its state ``Bᵀ·X``, ``2·Q·N·P``, and the output from the
    state before it ``C·S``, ``2·Q·N·P``: ``2·B·nc·Q²·N + B·H·nc·(2·Q²·P +
    4·Q·N·P)``.  Backward: each forward product's two operand gradients
    (twice the forward) and ``G`` again.  The decays' and the state
    passing's elementwise work is not counted."""
    b, h, s, p = x_shape
    q = KERNEL_CHUNK
    nc = -(-s // q)
    gram = 2 * b * nc * q * q * n
    fwd = gram + b * h * nc * (2 * q * q * p + 4 * q * n * p)
    return 2 * fwd + gram if backward else fwd


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _(x_shape, dt_shape, A_shape, B_shape, C_shape, *args, out_shape=None,
      **kwargs) -> int:
    return ssd_flops(x_shape, B_shape[-1])


def ssd_scan_backward(x, dt, A, Bm, Cm, dy, dS_fin=None, *, states=None,
                      chunk: int = 128):
    """The SSD scan's gradients ``(dx, ddt, dA, dB, dC)``, float32, from its
    operands, the output gradient ``dy [B,H,S,P]`` and the final state's
    ``dS_fin [B,H,N,P]`` (None: zero).  A CPU tensor takes
    :func:`ssd_backward_plain` with ``chunk``; a CUDA tensor launches kernel
    6b or raises.  On the card ``states`` is kernel 6's buffer of the state
    before each chunk of ``KERNEL_CHUNK`` steps, from the forward on the same
    operands (``dy`` is made last-dim contiguous first: autograd may hand in
    a strided one)."""
    _check_operands(x, dt, A, Bm, Cm)
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    if tuple(dy.shape) != (b, h, s, p) or (
            dS_fin is not None and tuple(dS_fin.shape) != (b, h, n, p)):
        raise ValueError(f"ssd_scan_backward: dy {tuple(dy.shape)} and "
                         f"dS_fin: need [B,H,S,P] and [B,H,N,P] or None")
    if x.device.type == "cpu":
        return ssd_backward_plain(x, dt, A, Bm, Cm, dy, dS_fin, chunk=chunk)
    q = KERNEL_CHUNK
    nc = -(-s // q)
    if states is None or tuple(states.shape) != (b, h, nc, n, p):
        raise ValueError(f"ssd_scan_backward: kernel 6b needs kernel 6's "
                         f"states of chunks of {q} steps, [B,H,nc,N,P] = "
                         f"{[b, h, nc, n, p]}")
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    if dS_fin is not None:
        dS_fin = dS_fin.contiguous()
    return SSD_BWD(x, dt, A, Bm, Cm, dy, dS_fin, states)


def _ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dS_fin, states):
    """Kernel 6b: ``(dx, ddt, dA, dB, dC)`` as :func:`ssd_scan_backward`
    gives them."""
    return _launch_bwd(x, dt, A, Bm, Cm, dy, dS_fin, states)


def _ssd_scan_bwd_fake(x, dt, A, Bm, Cm, dy, dS_fin, states):
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    f32 = dict(dtype=torch.float32)
    return (x.new_empty((b, s, h, p), **f32).transpose(1, 2),
            x.new_empty((b, h, s), **f32), x.new_empty((h,), **f32),
            x.new_empty((b, s, n), **f32), x.new_empty((b, s, n), **f32))


SSD_BWD = define_op(
    "ssd_scan_bwd(Tensor x, Tensor dt, Tensor A, Tensor Bm, Tensor Cm, "
    "Tensor dy, Tensor? dS_fin, Tensor states) -> (Tensor, Tensor, Tensor, "
    "Tensor, Tensor)", _ssd_scan_bwd, _ssd_scan_bwd_fake)


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
def _(x_shape, dt_shape, A_shape, B_shape, *args, out_shape=None,
      **kwargs) -> int:
    return ssd_flops(x_shape, B_shape[-1], backward=True)


def _launch_bwd(x, dt, A, Bm, Cm, dy, dS_fin, states):
    global BWD_LAUNCHES
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    q = KERNEL_CHUNK
    nc = -(-s // q)
    _require_kernel_operands("ssd_scan_backward", x, dt, A, Bm, Cm, dy,
                             states, dS_fin)
    for t in (x, Bm, Cm):
        if t.stride(-1) != 1:
            raise ValueError("ssd_scan_backward: x, B and C need a "
                             "contiguous last dim")
    if (n, p) not in STATE_SHAPES:
        raise ValueError(f"ssd_scan_backward: the kernel is built for (N, P) "
                         f"in {STATE_SHAPES}, got {(n, p)}")
    A = A.contiguous()
    dev = x.device
    dx = torch.empty((b, s, h, p), dtype=torch.float32,
                     device=dev).transpose(1, 2)
    ddt = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    dB = torch.empty((b, s, n), dtype=torch.float32, device=dev)
    dC = torch.empty_like(dB)
    dA = torch.empty((h,), dtype=torch.float32, device=dev)
    if s == 0:
        return dx, ddt, dA.zero_(), dB, dC
    dstates = torch.empty_like(states)
    dA_part = torch.empty((b, h, nc), dtype=torch.float32, device=dev)
    launch("repro_ssd_scan_bwd", dev,
           ptr(x), *x.stride()[:3], ptr(dt), *dt.stride(), ptr(A),
           ptr(Bm), *Bm.stride()[:2], ptr(Cm), *Cm.stride()[:2],
           ptr(dy), *dy.stride()[:3], ptr(dS_fin), ptr(states),
           ptr(dstates), ptr(dx), *dx.stride()[:3], ptr(ddt), ptr(dB),
           ptr(dC), ptr(dA_part), ptr(dA), b, h, s, n, p, q)
    BWD_LAUNCHES += 1
    return dx, ddt, dA, dB, dC


class _SsdScan(torch.autograd.Function):
    """:func:`ssd_scan_chunked` with its gradient: kernel 6 (keeping its
    chunk states) then kernel 6b on CUDA, the plain versions on the CPU.  No
    ``try`` falls back."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        y, s_fin, states = _forward(x, dt, A, Bm, Cm, chunk)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, states)
        return y, s_fin

    @staticmethod
    def backward(ctx, dy, dS_fin):
        x, dt, A, Bm, Cm, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x, dtype=torch.float32)
        grads = ssd_scan_backward(x, dt, A, Bm, Cm, dy, dS_fin,
                                  states=states, chunk=ctx.chunk)
        return (*grads, None)
