"""RG-LRU linear recurrence on the GPU.

Replaces the TPU kernel ``lru_scan_chunked``
(``src/repro/kernels/lru_scan/lru_scan.py:57``), which is also the function
of the JAX model's prefill twin ``_lru_chunked_jnp``
(``src/repro/models/blocks.py:397``)::

    h_t = a_t ⊙ h_{t−1} + b_t        over [B, S, D], h_{−1} = 0

The CUDA entry ``repro_lru_scan`` (``csrc/lru_scan.cu``) runs one thread per
(batch, channel) over the whole sequence, and writes the final state
``h_fin [B, D]`` beside ``h``: the model's prefill keeps it in its cache.
Inputs are float32 and read through their strides (the width contiguous).
What bounds it is in the source's note.

:func:`lru_chunked_plain` is the plain PyTorch version (``_lru_chunked_jnp``'s
chunked doubling scan, with the final state), which a CPU tensor takes.  The
chunk length changes only the order of the float operations, not the
function: the kernel's scan is sequential whatever ``chunk`` says.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._build import launch, ptr

LAUNCHES = 0   # calls of lru_scan_chunked that launched the CUDA kernel


def lru_chunked_plain(a, b, chunk: int):
    """a, b [B, S, D] → (h [B, S, D] float32, h_fin [B, D] float32), scanning
    chunks of ``chunk`` steps by doubling, the carry ``h`` between chunks (the
    last chunk padded with the identity ``a = 1, b = 0``)."""
    bsz, s, d = a.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s
    a = F.pad(a.float(), (0, 0, 0, pad), value=1.0)
    b = F.pad(b.float(), (0, 0, 0, pad))
    h = torch.zeros((bsz, d), dtype=torch.float32, device=a.device)
    hs = []
    for c in range(nc):
        av, bv = a[:, c * chunk:(c + 1) * chunk], b[:, c * chunk:(c + 1) * chunk]
        sft = 1
        while sft < chunk:
            # (a, b) composed with its predecessor ``sft`` steps back; the
            # first ``sft`` steps compose with the identity, which leaves
            # them as they are.
            a_prev = torch.cat([torch.ones_like(av[:, :sft]), av[:, :-sft]], 1)
            b_prev = torch.cat([torch.zeros_like(bv[:, :sft]), bv[:, :-sft]], 1)
            av, bv = a_prev * av, b_prev * av + bv
            sft *= 2
        hc = av * h[:, None] + bv
        h = hc[:, -1]
        hs.append(hc)
    out = torch.cat(hs, dim=1) if hs else a
    return out[:, :s], h


def lru_scan_chunked(a, b, *, chunk: int = 256):
    """The recurrence with its final state: → ``(h [B, S, D], h_fin [B,
    D])``, both float32.  A CPU tensor takes :func:`lru_chunked_plain` with
    ``chunk``; a CUDA tensor launches the kernel or raises."""
    global LAUNCHES
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"lru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)}: need two [B, S, D] tensors")
    if a.dtype != b.dtype or not a.is_floating_point():
        raise TypeError(f"lru_scan: a and b must be floats of one dtype, got "
                        f"{a.dtype} and {b.dtype}")
    if a.device.type == "cpu":
        return lru_chunked_plain(a, b, chunk)
    for t in (a, b):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"lru_scan: the kernel takes float32 CUDA "
                             f"tensors, got {t.device} {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError("lru_scan: the width must be contiguous")
    bsz, s, d = a.shape
    h = torch.empty((bsz, s, d), dtype=torch.float32, device=a.device)
    h_fin = torch.empty((bsz, d), dtype=torch.float32, device=a.device)
    launch("repro_lru_scan", a.device, ptr(a), a.stride(0), a.stride(1),
           ptr(b), b.stride(0), b.stride(1), ptr(h), ptr(h_fin), bsz, s, d)
    LAUNCHES += 1
    return h, h_fin
