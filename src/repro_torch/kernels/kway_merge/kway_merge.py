"""The k-way merge of the PSRS merge stage on the GPU.

Replaces the TPU kernel ``merge_tile_grid``
(``src/repro/kernels/kway_merge/kway_merge.py:65``) together with the exact
splitting and compact gather around it (``ops.py:98-221`` of the JAX
package).  The function: per context, the lowest ``rcap`` elements of the
count-masked buckets ``[k, v, cap]`` (lanes at or past ``counts[j]`` are
``INT_MAX``), ascending.  The CUDA source is ``csrc/kway_merge.cu``; its
note gives the design, why it merges, and the bound.

* :func:`exact_splitters` (entry ``repro_kway_splitters``) finds each
  bucket's exact start at the boundary of every ``S``-th output tile, the
  coarse ranks of :func:`coarse_ranks`, reading the buckets where they lie.
* :func:`merge_segments` (entry ``repro_kway_merge_segments``) takes one
  segment of ``S`` tiles a block: it loads the segment's windows (each
  bucket's keys between two coarse starts) into shared memory, merges them
  there pairwise, and writes the segment into ``merged [k, rcap]``; a
  segment at or past the context's valid total is written as ``INT_MAX``
  unread.  :func:`segment_tiles` chooses ``S``: ``SEGMENT_KEYS`` keys, and
  shared memory for two blocks an SM.
* :func:`merge_tile_grid` (entry ``repro_kway_tile_sort``) sorts the rows of
  compactly gathered tiles ``[G, tile]``, the counterpart of the TPU kernel
  on the gather route (``ops.gather_tiles``): a warp-register bitonic sort
  for tiles of 1024 or fewer, ``csrc/bitonic_sort.cu``'s passes above.

Each has a plain PyTorch version that a CPU tensor takes
(:func:`exact_splitters_plain`, :func:`merge_segments_plain`,
:func:`sort_tile_rows`); the plain versions of the first two follow the
kernels' decomposition (coarse starts, windows, the merge of each segment),
so the CPU tests reach every segment edge.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .._build import launch, ptr, require_cuda
from ..bitonic_sort.bitonic_sort import bitonic_network

LAUNCHES = 0           # calls of merge_tile_grid that launched its kernel
SPLIT_LAUNCHES = 0     # calls of exact_splitters that launched its kernel
SEGMENT_LAUNCHES = 0   # calls of merge_segments that launched its kernel

INT_MAX = 2**31 - 1
_BIAS = 1 << 31
SEGMENT_KEYS = 1 << 13      # keys a segment holds at most (two 32 KiB buffers)
SEGMENT_SMEM = 113 * 1024   # shared bytes a segment block may use: two an SM
SPLIT_WARPS = 4             # warps a splitter block (kSplitWarps)
SMEM_MAX = 227 * 1024       # shared bytes a block can have on Hopper

# The plain version of the tile sort: the same network as the local sort's,
# on each row (the JAX package's name for it).
sort_tile_rows = bitonic_network


def segment_smem_bytes(seg_tiles: int, tile: int, v: int) -> int:
    """Shared memory of one segment block (``csrc/kway_merge.cu``): two
    merge buffers of ``S·tile`` keys, the window bases, the coarse starts
    and the counts."""
    return 4 * (2 * seg_tiles * tile + 3 * v + 1)


def segment_tiles(v: int, tile: int) -> int:
    """Tiles a segment of :func:`merge_segments`: the largest power of two
    whose segment holds at most ``SEGMENT_KEYS`` keys and fits
    ``SEGMENT_SMEM``; 0 when not even one tile does, and the merge takes
    the gather route."""
    S = SEGMENT_KEYS // tile
    while S and segment_smem_bytes(S, tile, v) > SEGMENT_SMEM:
        S //= 2
    return S


def n_segments(rcap: int, tile: int, seg_tiles: int) -> int:
    """Segments of ``seg_tiles`` tiles that cover ``rcap`` output keys:
    ``C = ceil(G / S)``, ``G = ceil(rcap / tile)``."""
    G = -(-rcap // tile)
    return -(-G // seg_tiles)


def coarse_ranks(rcap: int, tile: int, seg_tiles: int, n_all: int,
                 device) -> torch.Tensor:
    """The segments' boundary ranks ``min(min(c·S, G)·tile, n_all)`` for
    ``c = 0..C`` (:func:`n_segments`) as int64 ``[C + 1]``."""
    G = -(-rcap // tile)
    c = torch.arange(n_segments(rcap, tile, seg_tiles) + 1,
                     dtype=torch.int64, device=device)
    return torch.clamp(torch.clamp(c * seg_tiles, max=G) * tile, max=n_all)


def mask_buckets(buckets: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The buckets with every lane at or past its count set to ``INT_MAX``
    (a copy)."""
    lane = torch.arange(buckets.shape[-1], device=buckets.device)
    return torch.where(lane < counts[..., None].to(torch.int64), buckets,
                       torch.tensor(INT_MAX, dtype=torch.int32,
                                    device=buckets.device))


def split_search(rows: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Exact starts of ``rows [k, v, N]`` (ascending int32) at the ranks
    ``[R]``: ``starts [k, R, v]``, ``starts[c, r]`` summing to ``ranks[r]``.

    The MSB-first search of the biased value domain finds each rank's
    boundary ``t = max u: #{x < u} < r``, then the duplicates of ``t`` are
    handed out greedily in bucket order.  Candidates ``u`` live in int64
    (``[0, 2^32)``), and each count is a ``searchsorted`` of the int32 query
    ``u - 2^31`` into the int32 rows: ``int64(x) + 2^31`` keeps the order of
    the JAX package's biased uint32 domain, without a 64-bit copy of the
    rows."""
    k, v, _ = rows.shape
    R = ranks.shape[0]

    def count(u, right=False):                       # u [k, R] → [k, v, R]
        q = (u - _BIAS).to(torch.int32)[:, None, :].expand(k, v, R)
        return torch.searchsorted(rows, q.contiguous(), right=right)

    u = torch.zeros((k, R), dtype=torch.int64, device=rows.device)
    for i in range(32):
        cand = u | (1 << (31 - i))
        u = torch.where(count(cand).sum(dim=1) < ranks, cand, u)
    lo = count(u)                                    # elements < t
    dups = count(u, right=True) - lo                 # elements == t
    need = ranks - lo.sum(dim=1, keepdim=True)
    cum = torch.cumsum(dups, dim=1) - dups           # exclusive prefix
    take = torch.minimum(torch.clamp(need - cum, min=0), dups)
    return (lo + take).transpose(1, 2)


def exact_splitters_plain(buckets: torch.Tensor, counts: torch.Tensor,
                          ranks: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`exact_splitters`: :func:`split_search` over
    the count-masked buckets."""
    return split_search(mask_buckets(buckets, counts),
                        ranks.to(torch.int64)).to(torch.int32).contiguous()


def exact_splitters(buckets: torch.Tensor, counts: torch.Tensor,
                    ranks: torch.Tensor) -> torch.Tensor:
    """Each bucket's exact start at the global ranks ``ranks [R]`` (int64,
    at most ``v·cap``) of the count-masked ``buckets [k, v, cap]``:
    ``starts [k, R, v]``, ``starts[c, r]`` summing to ``ranks[r]``, the
    duplicates of each rank's boundary key given to the buckets in order, as
    the JAX package's ``_exact_starts`` gives them.  A CPU tensor takes
    :func:`exact_splitters_plain`; CUDA int32 buckets whose rows are
    contiguous launch the kernel (any context and bucket strides; counts
    ``[k, v]`` with contiguous rows)."""
    global SPLIT_LAUNCHES
    if buckets.device.type == "cpu":
        return exact_splitters_plain(buckets, counts, ranks)
    k, v, cap = _require_buckets("exact_splitters", buckets, counts)
    if ranks.device != buckets.device or ranks.dtype != torch.int64 \
            or ranks.dim() != 1 or not ranks.is_contiguous():
        raise ValueError("exact_splitters: ranks must be a contiguous int64 "
                         f"[R] tensor on {buckets.device}")
    if SPLIT_WARPS * 3 * v * 4 > SMEM_MAX:
        raise ValueError(f"exact_splitters: v={v} buckets do not fit the "
                         "search's shared memory")
    R = ranks.shape[0]
    starts = torch.empty((k, R, v), dtype=torch.int32, device=buckets.device)
    launch("repro_kway_splitters", buckets.device, ptr(buckets),
           buckets.stride(0), buckets.stride(1), ptr(counts),
           counts.stride(0), ptr(ranks), R, k, v, cap, ptr(starts))
    SPLIT_LAUNCHES += 1
    return starts


def compact_gather(masked: torch.Tensor, starts: torch.Tensor,
                   width: int) -> torch.Tensor:
    """Rows ``[k·R, width]``: row ``(c, r)`` holds the windows
    ``[starts[c, r, j], starts[c, r+1, j])`` of the ascending rows
    ``masked [k, v, cap]``, concatenated in bucket order, ``INT_MAX`` past
    their total (``starts [k, R + 1, v]``, windows of at most ``width``
    keys in all).  Slot ``s`` belongs to the window whose exclusive prefix
    of lengths covers it."""
    k, v, cap = masked.shape
    starts = starts.to(torch.int64)
    lens = starts[:, 1:] - starts[:, :-1]                        # [k, R, v]
    R = lens.shape[1]
    cum = torch.cumsum(lens, dim=2) - lens
    slot = torch.arange(width, device=masked.device).expand(k, R, width)
    slot = slot.contiguous()
    own = torch.searchsorted(cum.contiguous(), slot, right=True) - 1
    off = slot - torch.gather(cum, 2, own)
    valid = off < torch.gather(lens, 2, own)
    pos = torch.gather(starts[:, :-1], 2, own) + off
    flat = own * cap + torch.clamp(pos, 0, cap - 1)
    rows = torch.gather(masked.reshape(k, v * cap), 1, flat.reshape(k, -1))
    fill = torch.tensor(INT_MAX, dtype=torch.int32, device=masked.device)
    return torch.where(valid, rows.reshape(k, R, width), fill).reshape(
        k * R, width)


def merge_segments_plain(buckets: torch.Tensor, counts: torch.Tensor,
                         starts: torch.Tensor, *, rcap: int, tile: int,
                         seg_tiles: int) -> torch.Tensor:
    """Plain version of :func:`merge_segments`, as the kernel runs: each
    segment's windows between its coarse starts packed in bucket order
    (:func:`compact_gather`), merged (here one ``torch.sort`` of the
    segment), and the segments at or past the valid total written as
    ``INT_MAX``."""
    k, _, cap = buckets.shape
    K = seg_tiles * tile                             # keys a segment
    C = n_segments(rcap, tile, seg_tiles)
    keys = compact_gather(mask_buckets(buckets, counts), starts, K)
    merged = torch.sort(keys, dim=-1).values.reshape(k, C, K)
    total = torch.clamp(counts.to(torch.int64), 0, cap).sum(dim=1)
    fill_only = (torch.arange(C, device=buckets.device) * K)[None, :] \
        >= total[:, None]
    merged = torch.where(fill_only[..., None],
                         torch.tensor(INT_MAX, dtype=torch.int32,
                                      device=buckets.device), merged)
    return merged.reshape(k, -1)[:, :rcap]


def merge_segments(buckets: torch.Tensor, counts: torch.Tensor,
                   starts: torch.Tensor, *, rcap: int, tile: int,
                   seg_tiles: int) -> torch.Tensor:
    """``merged [k, rcap]``: the lowest ``rcap`` keys of each context's
    count-masked buckets, ascending, from :func:`exact_splitters`'s starts
    at :func:`coarse_ranks` (``seg_tiles`` tiles of ``tile`` keys a
    segment).  A CPU tensor takes :func:`merge_segments_plain`; on CUDA a
    segment must fit one block's shared memory
    (:func:`segment_smem_bytes`)."""
    global SEGMENT_LAUNCHES
    if buckets.device.type == "cpu":
        return merge_segments_plain(buckets, counts, starts, rcap=rcap,
                                    tile=tile, seg_tiles=seg_tiles)
    k, v, cap = _require_buckets("merge_segments", buckets, counts)
    if rcap < 1 or tile < 1 or seg_tiles < 1 \
            or segment_smem_bytes(seg_tiles, tile, v) + 8 > SMEM_MAX:
        raise ValueError(f"merge_segments: rcap={rcap}, {seg_tiles} tiles of "
                         f"{tile} keys and v={v} do not fit one block")
    C = n_segments(rcap, tile, seg_tiles)
    require_cuda("merge_segments", starts)
    if tuple(starts.shape) != (k, C + 1, v) or not starts.is_contiguous():
        raise ValueError(f"merge_segments: starts must be [{k}, {C + 1}, "
                         f"{v}], contiguous")
    out = torch.empty((k, rcap), dtype=torch.int32, device=buckets.device)
    launch("repro_kway_merge_segments", buckets.device, ptr(buckets),
           buckets.stride(0), buckets.stride(1), ptr(counts),
           counts.stride(0), ptr(starts), ptr(out), k, v, cap, rcap, tile,
           seg_tiles)
    SEGMENT_LAUNCHES += 1
    return out


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


def _require_buckets(name: str, buckets: torch.Tensor,
                     counts: torch.Tensor) -> Tuple[int, int, int]:
    """Raise unless ``buckets`` is CUDA int32 ``[k, v, cap]`` with
    contiguous rows and ``counts`` int32 ``[k, v]`` beside it; returns
    ``(k, v, cap)``."""
    require_cuda(name, buckets, counts)
    if buckets.dim() != 3:
        raise ValueError(f"{name}: buckets must be [k, v, cap], got "
                         f"{tuple(buckets.shape)}")
    k, v, cap = buckets.shape
    if cap >= 2**31:
        raise ValueError(f"{name}: cap={cap} must be below 2^31")
    if tuple(counts.shape) != (k, v) or counts.device != buckets.device:
        raise ValueError(f"{name}: counts must be [{k}, {v}] on "
                         f"{buckets.device}")
    return k, v, cap
