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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._build import launch, ptr

LAUNCHES = 0   # calls of ssd_scan_chunked that launched the CUDA kernels
STATE_SHAPES = ((16, 16), (32, 32), (64, 64), (128, 64))  # (N, P) built
KERNEL_CHUNK = 64   # the kernel's chunk (64 and 128 are built)


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


def ssd_chunked_plain(x, dt, A, Bm, Cm, chunk: int, mm=torch.matmul):
    """x [B,H,S,P], dt [B,H,S], A [H], Bm/Cm [B,S,N] → (y [B,H,S,P] float32,
    S_fin [B,H,N,P] float32), in chunks of ``chunk`` steps (the last one
    padded with ``dt = 0``), phase by phase as the kernel runs them.  ``mm``
    computes every product of two operands (the tests pass models of the
    tensor cores' rounding)."""
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    xc = F.pad(x.float(), (0, 0, 0, pad)).reshape(b, h, nc, chunk, p)
    dtc = F.pad(dt.float(), (0, pad)).reshape(b, h, nc, chunk)
    Bc, Cc = (F.pad(t.float(), (0, 0, 0, pad)).reshape(b, nc, chunk, n)
              for t in (Bm, Cm))
    A = A.float()
    G = chunk_gram(Cc, Bc, mm)
    dS, decay = chunk_states(xc, dtc, A, Bc, mm)
    S_before, S_fin = state_passing(dS, decay)
    y = chunk_output(G, xc, dtc, A, Cc, S_before, mm)
    return y.reshape(b, h, nc * chunk, p)[:, :, :s], S_fin


def ssd_scan_chunked(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """The SSD scan with its final state: → ``(y [B,H,S,P], S_fin
    [B,H,N,P])``, both float32.  A CPU tensor takes
    :func:`ssd_chunked_plain` with ``chunk``; a CUDA tensor launches the
    kernels (chunks of ``KERNEL_CHUNK``) or raises."""
    global LAUNCHES
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    if (tuple(dt.shape) != (b, h, s) or tuple(A.shape) != (h,)
            or tuple(Bm.shape) != (b, s, n) or Cm.shape != Bm.shape):
        raise ValueError(
            f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}: "
            "need x [B,H,S,P], dt [B,H,S], A [H], B and C [B,S,N]")
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, dt, A, Bm, Cm, chunk)
    for t in (x, dt, A, Bm, Cm):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"ssd_scan: the kernel takes float32 CUDA "
                             f"tensors, got {t.device} {t.dtype}")
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
    return y, s_fin
