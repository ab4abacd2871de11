"""Tile sort of the k-way merge (the PSRS merge stage) on the GPU.

Replaces the TPU kernel ``merge_tile_grid``
(``src/repro/kernels/kway_merge/kway_merge.py:65``): after the exact
splitting and compact gather in :mod:`.ops`, every output tile of
``tiles [G, tile]`` holds exactly its tile's elements, and what is left is
ordering each row.  The CUDA entry ``repro_kway_tile_sort``
(``csrc/bitonic_sort.cu``) sorts one tile per block entirely in shared memory
(256 int32 is 1 KiB) with a bitonic network — all ``k·G`` tiles of a round
in one launch; a tile larger than a shared-memory segment takes the
network's global passes.  (The PSRS local sort, which once shared this
network, is a radix sort on the card: ``csrc/radix_sort.cu``.)

:func:`sort_tile_rows` is the plain PyTorch version (the network of
:func:`repro_torch.kernels.bitonic_sort.bitonic_network`).
"""

from __future__ import annotations

import torch

from .._build import launch, ptr, require_cuda
from ..bitonic_sort.bitonic_sort import bitonic_network

LAUNCHES = 0   # calls of merge_tile_grid that launched the CUDA kernel


# The plain version: the same network as the local sort's, on each row
# (the JAX package's name for it).
sort_tile_rows = bitonic_network


def merge_tile_grid(tiles: torch.Tensor) -> torch.Tensor:
    """Order each compactly gathered output tile of ``tiles [G, tile]``.  A
    CPU tensor takes :func:`sort_tile_rows`; a CUDA int32 tensor launches
    the kernel into a new tensor."""
    global LAUNCHES
    G, tile = tiles.shape
    if tile & (tile - 1):
        raise ValueError(f"tile={tile} must be a power of two")
    if tiles.device.type == "cpu":
        return sort_tile_rows(tiles)
    tiles = tiles.contiguous()
    require_cuda("merge_tile_grid", tiles)
    out = torch.empty_like(tiles)
    launch("repro_kway_tile_sort", tiles.device, ptr(tiles), ptr(out), G,
           tile)
    LAUNCHES += 1
    return out
