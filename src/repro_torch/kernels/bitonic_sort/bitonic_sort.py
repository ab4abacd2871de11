"""The PSRS local sort (its hot spot) on the GPU: a stable LSD radix sort.

Replaces the TPU kernel ``bitonic_sort_rows``
(``src/repro/kernels/bitonic_sort/bitonic_sort.py:44``), which sorts each row
of ``[rows, n]`` with a bitonic network inside VMEM.  Any sort gives the same
int32 rows.  On the card a row of more than 2^13 keys takes the radix kernel
(``csrc/radix_sort.cu``, entry ``repro_radix_sort_rows``): four stable passes
of 8-bit digits of the sign-flipped key, each an upsweep of tile counts, a
scan and a stably ranked scatter; its source note gives the bound and the
traffic.  A row of 2^13 keys or fewer fits one shared-memory segment and
takes the bitonic kernel's single pass (``csrc/bitonic_sort.cu``, entry
``repro_bitonic_sort_rows``) instead.

:func:`radix_sort_plain` is the plain PyTorch version of the radix passes:
the CPU path of :func:`bitonic_sort_rows`, and what ``chip_smoke.py`` holds
the kernel against on the card.  :func:`bitonic_network` stays the plain
version of the k-way merge's tile sort (kernel 3), which runs the network.
"""

from __future__ import annotations

import torch

from .._build import launch, ptr, require_cuda

LAUNCHES = 0   # calls of bitonic_sort_rows that launched a CUDA kernel
SMEM_ROW_KEYS = 1 << 13   # rows up to this take the one shared-memory pass
# Radix tiles of RADIX_THREADS x RADIX_KEYS_PER_THREAD keys: (32, 256) is
# built with (16, 256) and (8, 512), which scripts/radix_ssd_tiles.py times.
RADIX_KEYS_PER_THREAD = 32
RADIX_THREADS = 256
RADIX_PASSES = 4          # 8-bit digits of an int32 key


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


def radix_key(x: torch.Tensor) -> torch.Tensor:
    """The unsigned 32-bit image of each key, as int64, whose order is the
    keys' order: ``uint32(x) ^ 0x80000000`` for int32 keys (the kernel's);
    for float32 keys the sign bit flipped on positives and every bit on
    negatives (NaNs after +inf, -0.0 before +0.0)."""
    if x.dtype == torch.int32:
        return (x.to(torch.int64) & 0xFFFFFFFF) ^ 0x80000000
    if x.dtype == torch.float32:
        b = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        return torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b ^ 0x80000000)
    raise TypeError(f"radix sort: int32 or float32 keys, got {x.dtype}")


def radix_pass(x: torch.Tensor, d: int) -> torch.Tensor:
    """One stable pass of the LSD radix sort: each row of ``x`` reordered by
    digit ``d`` (bits ``8d .. 8d+7`` of :func:`radix_key`), keys of equal
    digit in their input order."""
    digit = (radix_key(x) >> (8 * d)) & 0xFF
    order = torch.argsort(digit, dim=-1, stable=True)
    return torch.gather(x, -1, order)


def radix_sort_plain(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of each row of ``x [rows, n]`` (int32, or float32 on
    the CPU) in plain PyTorch, by the kernel's four stable passes, least
    significant digit first."""
    for d in range(RADIX_PASSES):
        x = radix_pass(x, d)
    return x


def bitonic_sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Sort each row of ``[rows, n]`` ascending; ``n`` must be a power of
    two.  A CPU tensor takes :func:`radix_sort_plain`; a CUDA tensor (int32,
    rows contiguous, any row stride) launches a kernel into a new tensor:
    the radix sort for ``n > SMEM_ROW_KEYS``, else the bitonic kernel's one
    shared-memory pass (a choice by size between two kernels)."""
    global LAUNCHES
    rows, n = x.shape
    if n & (n - 1):
        raise ValueError(f"n={n} must be a power of two")
    if x.device.type == "cpu":
        return radix_sort_plain(x)
    require_cuda("bitonic_sort_rows", x)
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    if n <= SMEM_ROW_KEYS:
        launch("repro_bitonic_sort_rows", x.device, ptr(x), x.stride(0),
               ptr(out), rows, n)
    else:
        kpt, threads = RADIX_KEYS_PER_THREAD, RADIX_THREADS
        tiles = -(-n // (threads * kpt))
        tmp = torch.empty_like(out)
        # hist [rows, 4, 256], then counts [rows, 256, tiles] (uint32 words)
        scratch = torch.empty(rows * 256 * (RADIX_PASSES + tiles),
                              dtype=torch.int32, device=x.device)
        launch("repro_radix_sort_rows", x.device, ptr(x), x.stride(0),
               ptr(out), ptr(tmp), ptr(scratch), rows, n, kpt, threads)
    LAUNCHES += 1
    return out
