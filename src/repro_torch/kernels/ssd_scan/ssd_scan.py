"""Mamba-2 SSD chunked scan on the GPU.

Replaces the TPU kernel ``ssd_scan_chunked``
(``src/repro/kernels/ssd_scan/ssd_scan.py:78``), which is also the function
of the JAX model's prefill twin ``_ssd_chunked_jnp``
(``src/repro/models/blocks.py:250``).  Per head, with state ``S [N, P]``::

    S_t = exp(A·dt_t)·S_{t−1} + dt_t·B_t ⊗ x_t,      y_t = C_t·S_t

The CUDA entry ``repro_ssd_scan`` (``csrc/ssd_scan.cu``) runs one block per
(batch, head) that loops over 32-step chunks with the state held on chip for
the whole sequence, and writes the final state ``S_fin [B, H, N, P]`` beside
``y``: the model's prefill keeps it in its cache.  Inputs are float32 and read
through their strides, so the model's ``[B, H, S, P]`` view of its projection
goes in without a copy; ``y`` is returned as a ``[B, H, S, P]`` view of a
``[B, S, H, P]`` tensor, the layout the model reads back.  What bounds it is
in the source's note.

:func:`ssd_chunked_plain` is the plain PyTorch version (``_ssd_chunked_jnp``'s
chunked form with the final state), which a CPU tensor takes.  The chunk
length changes only the order of the float sums, not the function: the
kernel's is 32 whatever ``chunk`` says.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._build import launch, ptr

LAUNCHES = 0   # calls of ssd_scan_chunked that launched the CUDA kernel
STATE_SHAPES = ((16, 16), (32, 32), (64, 64), (128, 64))  # (N, P) built


def ssd_chunked_plain(x, dt, A, Bm, Cm, chunk: int):
    """x [B,H,S,P], dt [B,H,S], A [H], Bm/Cm [B,S,N] → (y [B,H,S,P] float32,
    S_fin [B,H,N,P] float32), scanning chunks of ``chunk`` steps (the last
    one padded with ``dt = 0``)."""
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    x = F.pad(x.float(), (0, 0, 0, pad))
    dt = F.pad(dt.float(), (0, pad))
    Bm = F.pad(Bm.float(), (0, 0, 0, pad))
    Cm = F.pad(Cm.float(), (0, 0, 0, pad))
    A = A.float()
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    S = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xb, db, Bb, Cb = x[:, :, sl], dt[:, :, sl], Bm[:, sl], Cm[:, sl]
        cdt = torch.cumsum(db, dim=-1)                              # [b,h,C]
        G = torch.einsum("bin,bjn->bij", Cb, Bb)                    # [b,C,C]
        seg = A[None, :, None, None] * (cdt[..., :, None] - cdt[..., None, :])
        M = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
        W = G[:, None] * M * db[..., None, :]                       # [b,h,C,C]
        y_intra = torch.einsum("bhij,bhjp->bhip", W, xb)
        decay_t = torch.exp(A[None, :, None] * cdt)                 # [b,h,C]
        y_carry = decay_t[..., None] * torch.einsum("bin,bhnp->bhip", Cb, S)
        wt = torch.exp(A[None, :, None] * (cdt[..., -1:] - cdt)) * db
        S = (torch.exp(A[None, :] * cdt[..., -1])[..., None, None] * S
             + torch.einsum("bin,bhip->bhnp", Bb, xb * wt[..., None]))
        ys.append(y_intra + y_carry)
    y = torch.cat(ys, dim=2) if ys else x
    return y[:, :, :s], S


def ssd_scan_chunked(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """The SSD scan with its final state: → ``(y [B,H,S,P], S_fin
    [B,H,N,P])``, both float32.  A CPU tensor takes
    :func:`ssd_chunked_plain` with ``chunk``; a CUDA tensor launches the
    kernel or raises."""
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
    launch("repro_ssd_scan", x.device,
           ptr(x), *x.stride()[:3], ptr(dt), *dt.stride(), ptr(A),
           ptr(Bm), *Bm.stride()[:2], ptr(Cm), *Cm.stride()[:2],
           ptr(y), *y.stride()[:3], ptr(s_fin), b, h, s, n, p)
    LAUNCHES += 1
    return y, s_fin
