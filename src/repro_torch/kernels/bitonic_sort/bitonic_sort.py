"""The PSRS local sort (its hot spot) on the GPU: a stable LSD radix sort.

Replaces the TPU kernel ``bitonic_sort_rows``
(``src/repro/kernels/bitonic_sort/bitonic_sort.py:44``), which sorts each row
of ``[rows, n]`` with a bitonic network inside VMEM.  Any sort gives the same
integer rows.  On the card a row of more than 2^13 keys takes the radix
kernel (``csrc/radix_sort.cu``, entry ``repro_radix_sort_rows``): one stable
pass of 8-bit digits of the key's order-preserving image a byte of the key,
each an upsweep of tile counts, a scan and a stably ranked scatter; its
source note gives the bound and the traffic.  A row of 2^13 keys or fewer
fits one shared-memory segment and takes the bitonic kernel's single pass
(``csrc/bitonic_sort.cu``, entry ``repro_bitonic_sort_rows``) instead.

Keys of every dtype of 1, 2 or 4 bytes (:data:`.._build.KEY_KINDS`: bool,
int8, uint8, int16, uint16, int32, uint32, float16, bfloat16, float32), in
``jnp.sort``'s order, which ``torch.sort(stable=True)`` also gives: the two
zeros tie and keep their input order, and every NaN, of either sign and
any payload, ties after ``+inf`` (:func:`radix_key`,
``csrc/sort_keys.cuh``).  The keys moved are the input's own bits.  JAX
with x64 off makes no 8-byte keys; they raise.

:func:`radix_sort_plain` is the plain PyTorch version of the radix passes:
the CPU path of :func:`bitonic_sort_rows`, and what ``chip_smoke.py`` holds
the kernel against on the card.  :func:`bitonic_network` stays the plain
version of the k-way merge's tile sort (kernel 3), which runs the network.
"""

from __future__ import annotations

import torch

from .._build import KEY_KINDS, launch, ptr, require_kind

LAUNCHES = 0   # calls of bitonic_sort_rows that launched a CUDA kernel
SMEM_ROW_KEYS = 1 << 13   # rows up to this take the one shared-memory pass
# Radix tiles of RADIX_THREADS x RADIX_KEYS_PER_THREAD keys: (32, 256) is
# built with (16, 256) and (8, 512), which scripts/radix_ssd_tiles.py times.
RADIX_KEYS_PER_THREAD = 32
RADIX_THREADS = 256
RADIX_PASSES = 4          # 8-bit digits of an int32 key (a pass a byte)
# Each dtype's signed view of its own width: where torch's CPU kernels lack
# an unsigned (or bool) dtype, the plain versions move the bits through it.
_SIGNED_VIEW = {1: torch.int8, 2: torch.int16, 4: torch.int32}
# The float dtypes' (sign bit, bits of +inf, bits of the positive quiet NaN).
_FLOAT_BITS = {torch.float32: (1 << 31, 0x7F800000, 0x7FC00000),
               torch.float16: (1 << 15, 0x7C00, 0x7E00),
               torch.bfloat16: (1 << 15, 0x7F80, 0x7FC0)}


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


def key_width(dtype: torch.dtype) -> int:
    """The bytes of a sort key of ``dtype`` (one digit pass each); raises
    ``TypeError`` for a dtype the sort does not take."""
    if dtype not in KEY_KINDS:
        raise TypeError(f"sort: keys of 1, 2 or 4 bytes (bool, int8, uint8, "
                        f"int16, uint16, int32, uint32, float16, bfloat16, "
                        f"float32), got {dtype}"
                        + (" (JAX with x64 off makes no 8-byte keys)"
                           if dtype.itemsize == 8 else ""))
    return dtype.itemsize


def radix_key(x: torch.Tensor) -> torch.Tensor:
    """The unsigned image of each key, as int64, whose order is the keys'
    order (the kernels', ``csrc/sort_keys.cuh``): ``uint32(x) ^ 0x80000000``
    for int32 keys, the sign bit of its width flipped for the other signed
    ones, the bits as they are for unsigned ones and bool; for a float key,
    -0 taken as +0 and every NaN as the positive quiet NaN, then every bit
    flipped on a negative and the sign bit on a positive (NaNs after +inf,
    the zeros equal)."""
    width = key_width(x.dtype)
    ones = (1 << 8 * width) - 1
    b = x.view(_SIGNED_VIEW[width]).to(torch.int64) & ones
    if x.dtype in _FLOAT_BITS:
        sign, inf, nan = _FLOAT_BITS[x.dtype]
        mag = b & (sign - 1)
        b = torch.where(mag > inf, nan, torch.where(mag == 0, 0, b))
        return torch.where(b >= sign, b ^ ones, b ^ sign)
    if x.dtype.is_signed:
        return b ^ (1 << 8 * width - 1)
    return b


def radix_pass(x: torch.Tensor, d: int) -> torch.Tensor:
    """One stable pass of the LSD radix sort: each row of ``x`` reordered by
    digit ``d`` (bits ``8d .. 8d+7`` of :func:`radix_key`), keys of equal
    digit in their input order.  The keys move through their signed view
    (torch's CPU gather takes no uint16 or uint32)."""
    digit = (radix_key(x) >> (8 * d)) & 0xFF
    order = torch.argsort(digit, dim=-1, stable=True)
    signed = _SIGNED_VIEW[x.dtype.itemsize]
    return torch.gather(x.view(signed), -1, order).view(x.dtype)


def radix_sort_plain(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of each row of ``x [rows, n]`` (every dtype of
    :func:`key_width`) in plain PyTorch, by the kernel's stable passes, one
    a byte of the key, least significant digit first."""
    for d in range(key_width(x.dtype)):
        x = radix_pass(x, d)
    return x


def bitonic_sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Sort each row of ``[rows, n]`` ascending; ``n`` must be a power of
    two.  A CPU tensor takes :func:`radix_sort_plain`; a CUDA tensor (keys
    of 1, 2 or 4 bytes, :func:`key_width`; rows contiguous, any row stride)
    launches a kernel into a new tensor: the radix sort for ``n >
    SMEM_ROW_KEYS``, else the bitonic kernel's one shared-memory pass (a
    choice by size between two kernels).  The kernels read the keys as they
    lie, whatever their dtype."""
    global LAUNCHES
    rows, n = x.shape
    if n & (n - 1):
        raise ValueError(f"n={n} must be a power of two")
    width = key_width(x.dtype)
    if x.device.type == "cpu":
        return radix_sort_plain(x)
    kind = require_kind("bitonic_sort_rows", KEY_KINDS, x)
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    if n <= SMEM_ROW_KEYS:
        launch("repro_bitonic_sort_rows", x.device, ptr(x), x.stride(0),
               ptr(out), rows, n, kind)
    else:
        kpt, threads = RADIX_KEYS_PER_THREAD, RADIX_THREADS
        tiles = -(-n // (threads * kpt))
        tmp = torch.empty_like(out)
        # hist [rows, passes, 256], then counts [rows, 256, tiles] (uint32
        # words), a pass a byte of the key
        scratch = torch.empty(rows * 256 * (width + tiles),
                              dtype=torch.int32, device=x.device)
        launch("repro_radix_sort_rows", x.device, ptr(x), x.stride(0),
               ptr(out), ptr(tmp), ptr(scratch), rows, n, kpt, threads, kind)
    LAUNCHES += 1
    return out
