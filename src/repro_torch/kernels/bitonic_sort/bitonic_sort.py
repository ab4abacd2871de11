"""Bitonic sorting network (the PSRS local-sort hot spot) on the GPU.

Replaces the TPU kernel ``bitonic_sort_rows``
(``src/repro/kernels/bitonic_sort/bitonic_sort.py:44``), which sorts each row
of ``[rows, n]`` inside VMEM.  The CUDA kernel (``csrc/bitonic_sort.cu``,
entry ``repro_bitonic_sort_rows``) runs the same network — ascending iff bit
``stage+1`` of the element index is 0 — as one shared-memory pass over
8192-element segments plus one global pass per larger stride; its source
note gives the bound and the pass count.

:func:`bitonic_network` is the plain PyTorch version of that arithmetic: the
CPU path of :func:`bitonic_sort_rows`, and what ``chip_smoke.py`` holds the
kernel against on the card.
"""

from __future__ import annotations

import torch

from .._build import launch, ptr, require_cuda

LAUNCHES = 0   # calls of bitonic_sort_rows that launched the CUDA kernel


def bitonic_network(x: torch.Tensor) -> torch.Tensor:
    """Ascending bitonic sort of the last axis of ``[..., n]`` in plain
    PyTorch; ``n`` must be a power of two."""
    *lead, n = x.shape
    if n & (n - 1):
        raise ValueError(f"n={n} must be a power of two")
    log_n = n.bit_length() - 1
    for stage in range(log_n):
        for sub in range(stage, -1, -1):
            stride = 1 << sub
            groups = n // (2 * stride)
            xr = x.reshape(*lead, groups, 2, stride)
            a, b = xr[..., 0, :], xr[..., 1, :]
            # Ascending iff bit (stage+1) of the element index is 0: constant
            # within a group, alternating with period 2^(stage-sub) in group
            # index.
            g = torch.arange(groups, device=x.device)[:, None]
            asc = ((g >> (stage - sub)) & 1) == 0
            lo = torch.minimum(a, b)
            hi = torch.maximum(a, b)
            x = torch.stack([torch.where(asc, lo, hi),
                             torch.where(asc, hi, lo)], dim=-2)
            x = x.reshape(*lead, n)
    return x


def bitonic_sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Sort each row of ``[rows, n]`` ascending; ``n`` must be a power of
    two.  A CPU tensor takes the plain version; a CUDA tensor (int32, rows
    contiguous, any row stride) launches the kernel into a new tensor."""
    global LAUNCHES
    rows, n = x.shape
    if n & (n - 1):
        raise ValueError(f"n={n} must be a power of two")
    if x.device.type == "cpu":
        return bitonic_network(x)
    require_cuda("bitonic_sort_rows", x)
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    launch("repro_bitonic_sort_rows", x.device, ptr(x), x.stride(0), ptr(out),
           rows, n)
    LAUNCHES += 1
    return out
