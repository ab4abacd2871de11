"""Public k-way merge wrapper: exact splitting + compact gather + tile sort
(``ops.py:98-221`` of the JAX package), batched over the round's contexts.

``kway_merge(buckets [k, v, cap], counts [k, v], rcap=...)`` returns, per
context, the lowest ``rcap`` elements of the count-masked buckets, ascending,
plus the total received count and an overflow flag — the PSRS merge-stage
contract, bit identical to :func:`.ref.kway_merge_ref`.

Pipeline (plain PyTorch around one kernel launch):

1. **Mask** lanes at/past ``counts[j]`` to ``fill`` (the dtype maximum), so
   each row is ascending and the fill lanes are ordinary elements.
2. **Exact splitters** (arxiv 0910.2582): for every output tile boundary
   rank ``r = g·tile`` a 32-step MSB-first search over the biased value
   domain finds ``t_r = max u: #{x < u} < r``; the duplicates of ``t_r`` are
   handed out greedily in bucket order.  The candidates ``u | 1 << (31-i)``
   live in int64 (``[0, 2^32)``), and each count is a ``searchsorted`` of
   the int32 query ``u - 2^31`` into the int32 rows — ``int64(x) + 2^31``
   keeps the order of the JAX package's biased uint32 domain exactly,
   without a 64-bit copy of the buckets.
3. **Compact gather**: tile ``g``'s window lengths sum to exactly ``tile``,
   so the windows concatenate (owner bucket by ``searchsorted`` over the
   exclusive length prefix) into one dense row per tile.
4. **Tile sort**: :func:`.kway_merge.merge_tile_grid` — one launch for all
   ``k·G`` tiles — or, with ``use_kernel=False``, its plain network
   :func:`.kway_merge.sort_tile_rows` on any device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .kway_merge import merge_tile_grid, sort_tile_rows

_BIAS = 1 << 31


def _exact_starts(rows: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Per-bucket window starts for global ``ranks [R]`` over ``[k, v, cap]``
    ascending int32 rows: ``starts[b, r, j]`` with
    ``Σ_j starts[b, r, j] = ranks[r]``."""
    k, v, _ = rows.shape
    R = ranks.shape[0]

    def search(u, right=False):             # u [k, R] biased → [k, v, R]
        q = (u - _BIAS).to(torch.int32)[:, None, :].expand(k, v, R)
        return torch.searchsorted(rows, q.contiguous(), right=right)

    u = torch.zeros((k, R), dtype=torch.int64, device=rows.device)
    for i in range(32):
        cand = u | (1 << (31 - i))
        u = torch.where(search(cand).sum(dim=1) < ranks, cand, u)

    lo = search(u)                          # [k, v, R] elements < t
    hi = search(u, right=True)              # [k, v, R] elements <= t
    dups = hi - lo
    need = ranks - lo.sum(dim=1, keepdim=True)        # duplicates of t
    cum = torch.cumsum(dups, dim=1) - dups            # exclusive prefix
    take = torch.minimum(torch.clamp(need - cum, min=0), dups)
    return (lo + take).transpose(1, 2)                # [k, R, v]


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
    tail.  This slice supports int32 buckets only.
    """
    if buckets.dim() == 2:
        merged, total, over = kway_merge(
            buckets[None], counts[None], rcap=rcap, tile=tile, fill=fill,
            use_kernel=use_kernel)
        return merged[0], total[0], over[0]
    tiles, total, overflow = gather_tiles(buckets, counts, rcap=rcap,
                                          tile=tile, fill=fill)
    merged = merge_tile_grid(tiles) if use_kernel else sort_tile_rows(tiles)
    k = buckets.shape[0]
    return merged.reshape(k, -1)[:, :rcap], total, overflow


def gather_tiles(buckets: torch.Tensor, counts: torch.Tensor, *, rcap: int,
                 tile: int, fill) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Steps 1-3 of :func:`kway_merge` on ``[k, v, cap]`` buckets: returns
    ``(tiles [k·G, tile], total [k], overflow [k])``, each row of ``tiles``
    a permutation of its output tile's elements (``G = ceil(rcap/tile)``
    tiles per context) — the tile sort's input."""
    if buckets.dim() != 3:
        raise ValueError(
            f"buckets must be [k, v, cap], got {tuple(buckets.shape)}")
    k, v, cap = buckets.shape
    if buckets.dtype != torch.int32:
        raise ValueError(
            f"kway_merge supports int32 buckets, got {buckets.dtype} (the "
            "exact-splitter search runs in the biased 32-bit value domain)")
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"tile={tile} must be a power of two")
    if rcap < 1:
        raise ValueError(f"rcap={rcap} must be >= 1")
    fmax = torch.iinfo(torch.int32).max
    if int(fill) != fmax:
        raise ValueError(
            f"fill={fill!r} must be the dtype maximum {fmax}: masked lanes "
            "must sort to every bucket's tail for the windows to be "
            "ascending")
    dev = buckets.device

    counts = counts.to(torch.int32)
    total = counts.sum(dim=1, dtype=torch.int32)
    overflow = (total > rcap).to(torch.int32)

    lane = torch.arange(cap, device=dev)
    masked = torch.where(lane < counts[..., None], buckets,
                         torch.tensor(fmax, dtype=torch.int32, device=dev))

    n_all = v * cap                          # fill lanes are elements too
    G = -(-rcap // tile)
    ranks = torch.clamp(torch.arange(G + 1, device=dev) * tile, max=n_all)
    starts = _exact_starts(masked, ranks)    # [k, G+1, v]

    # Compact gather: slot s of tile g belongs to the bucket whose exclusive
    # length prefix covers s.
    lens = starts[:, 1:] - starts[:, :-1]                        # [k, G, v]
    cum = torch.cumsum(lens, dim=2) - lens
    slot = torch.arange(tile, device=dev).expand(k, G, tile).contiguous()
    own = torch.searchsorted(cum.contiguous(), slot, right=True) - 1
    off = slot - torch.gather(cum, 2, own)
    valid = off < torch.gather(lens, 2, own)     # only the last tile is short
    pos = torch.gather(starts[:, :-1], 2, own) + off
    flat = own * cap + torch.clamp(pos, 0, cap - 1)
    tiles = torch.gather(masked.reshape(k, n_all), 1,
                         flat.reshape(k, G * tile)).reshape(k, G, tile)
    tiles = torch.where(valid, tiles,
                        torch.tensor(fmax, dtype=torch.int32, device=dev))

    return tiles.reshape(k * G, tile), total, overflow
