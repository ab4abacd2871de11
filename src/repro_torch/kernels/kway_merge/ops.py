"""Public k-way merge wrapper, batched over the round's contexts.

``kway_merge(buckets [k, v, cap], counts [k, v], rcap=...)`` returns, per
context, the lowest ``rcap`` elements of the count-masked buckets, ascending,
plus the total received count and an overflow flag — the PSRS merge-stage
contract, bit identical to :func:`.ref.kway_merge_ref` and to the JAX
package's ``kway_merge`` (the output is unique).

Routes, chosen by size alone:

* **Fused** (a segment of :func:`.kway_merge.segment_tiles` tiles fits
  shared memory: every tile up to ``SEGMENT_KEYS`` keys, the default 256
  included): two launches that read the buckets where they lie.
  :func:`.kway_merge.exact_splitters` finds every bucket's exact start at
  the boundary of every ``S``-th output tile, and
  :func:`.kway_merge.merge_segments` merges each segment of ``S`` tiles in
  one block (its windows into shared memory, merged there pairwise).  No
  masked copy of the buckets and no index tensor is made.  A CPU tensor
  runs their plain versions.
* **Gather** (a larger tile): the JAX package's pipeline,
  :func:`gather_tiles` (the count mask, the exact splitters at every tile
  boundary, the compact gather into ``[k·G, tile]``) and
  :func:`.kway_merge.merge_tile_grid`, one launch for all tiles.
* ``use_kernel=False`` takes the gather route with the plain network
  :func:`.kway_merge.sort_tile_rows` on any device.

The exact splitters (arxiv 0910.2582): for a boundary rank ``r`` a 32-step
MSB-first search over the biased value domain finds ``t_r = max u: #{x < u}
< r``, and the duplicates of ``t_r`` are handed out greedily in bucket order
(:func:`.kway_merge.split_search`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .kway_merge import (MERGE_KINDS, biased, coarse_ranks, compact_gather,
                         exact_splitters, mask_buckets, merge_segments,
                         merge_tile_grid, segment_tiles, sort_tile_rows,
                         split_search, unbiased)


def kway_merge(
    buckets: torch.Tensor,              # [k, v, cap] (or [v, cap]); row j
                                        # ascending in its first counts[j]
    counts: torch.Tensor,               # [k, v] (or [v]) valid lanes
    *,
    rcap: int,
    tile: int = 256,
    fill,
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge each context's ``v`` sorted buckets into their lowest ``rcap``
    elements.

    Returns ``(merged [k, rcap], total [k], overflow [k])`` (no leading
    ``k`` for 2-D ``buckets``): ``total`` is the int32 ``counts`` sum and
    ``overflow`` flags ``total > rcap``.  ``fill`` must be the dtype maximum
    (the PSRS boundary sentinel): masked lanes must sort to every row's
    tail.  Buckets are int32 or uint32 (fill ``0xFFFFFFFF``), as the JAX
    package's ``kway_merge`` takes them.
    """
    if buckets.dim() == 2:
        merged, total, over = kway_merge(
            buckets[None], counts[None], rcap=rcap, tile=tile, fill=fill,
            use_kernel=use_kernel)
        return merged[0], total[0], over[0]
    _check(buckets, rcap=rcap, tile=tile, fill=fill)
    k, v, cap = buckets.shape
    counts = counts.to(torch.int32)
    total = counts.sum(dim=1, dtype=torch.int32)
    overflow = (total > rcap).to(torch.int32)
    S = segment_tiles(v, tile) if use_kernel else 0
    if S:
        ranks = coarse_ranks(rcap, tile, S, v * cap, buckets.device)
        starts = exact_splitters(buckets, counts, ranks)
        merged = merge_segments(buckets, counts, starts, rcap=rcap,
                                tile=tile, seg_tiles=S)
        return merged, total, overflow
    tiles, _, _ = gather_tiles(buckets, counts, rcap=rcap, tile=tile,
                               fill=fill)
    merged = merge_tile_grid(tiles) if use_kernel else sort_tile_rows(tiles)
    return merged.reshape(k, -1)[:, :rcap], total, overflow


def _check(buckets: torch.Tensor, *, rcap: int, tile: int, fill) -> None:
    if buckets.dim() != 3:
        raise ValueError(
            f"buckets must be [k, v, cap], got {tuple(buckets.shape)}")
    if buckets.dtype not in MERGE_KINDS:
        raise ValueError(
            f"kway_merge supports int32 and uint32 buckets, got "
            f"{buckets.dtype} (the exact-splitter search runs in the biased "
            "32-bit value domain)")
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"tile={tile} must be a power of two")
    if rcap < 1:
        raise ValueError(f"rcap={rcap} must be >= 1")
    fmax = torch.iinfo(buckets.dtype).max
    if int(fill) != fmax:
        raise ValueError(
            f"fill={fill!r} must be the dtype maximum {fmax}: masked lanes "
            "must sort to every bucket's tail for the windows to be "
            "ascending")


def gather_tiles(buckets: torch.Tensor, counts: torch.Tensor, *, rcap: int,
                 tile: int, fill) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The gather route's steps before the tile sort on ``[k, v, cap]``
    buckets: returns ``(tiles [k·G, tile], total [k], overflow [k])``, each
    row of ``tiles`` a permutation of its output tile's elements
    (``G = ceil(rcap/tile)`` tiles per context) — the tile sort's input,
    in the buckets' dtype (the steps run on the :func:`.kway_merge.biased`
    images)."""
    _check(buckets, rcap=rcap, tile=tile, fill=fill)
    dtype = buckets.dtype
    buckets = biased(buckets)
    k, v, cap = buckets.shape
    dev = buckets.device

    counts = counts.to(torch.int32)
    total = counts.sum(dim=1, dtype=torch.int32)
    overflow = (total > rcap).to(torch.int32)

    masked = mask_buckets(buckets, counts)
    n_all = v * cap                          # fill lanes are elements too
    G = -(-rcap // tile)
    ranks = torch.clamp(torch.arange(G + 1, device=dev) * tile, max=n_all)
    starts = split_search(masked, ranks)     # [k, G+1, v]
    return unbiased(compact_gather(masked, starts, tile), dtype), total, \
        overflow
