"""Plain oracle for the tiled k-way merge.

Semantics the kernel path must reproduce bit for bit: mask every lane at or
past its bucket's count to ``fill``, sort the whole ``v·cap`` population
flat, and keep the lowest ``rcap`` values (``fill``-padded when the
population is smaller than ``rcap``).
"""

from __future__ import annotations

import torch

_MIN = -2**31


def kway_merge_ref(buckets: torch.Tensor, counts: torch.Tensor, *,
                   rcap: int, fill) -> torch.Tensor:
    """Lowest ``rcap`` of the masked ``[..., v, cap]`` buckets, ascending.
    uint32 buckets (fill ``0xFFFFFFFF``) run as int32 images ``x ^ 2^31``,
    which torch's CPU ``where`` takes."""
    if buckets.dtype == torch.uint32:
        f = int(fill) ^ (1 << 31)
        out = kway_merge_ref(buckets.view(torch.int32) ^ _MIN, counts,
                             rcap=rcap, fill=f - (1 << 32) if f >> 31 else f)
        return (out ^ _MIN).view(torch.uint32)
    *lead, v, cap = buckets.shape
    lane = torch.arange(cap, device=buckets.device)
    masked = torch.where(lane < counts[..., None].to(torch.int64), buckets,
                         torch.tensor(fill, dtype=buckets.dtype,
                                      device=buckets.device))
    flat = torch.sort(masked.reshape(*lead, v * cap), dim=-1).values
    if flat.shape[-1] >= rcap:
        return flat[..., :rcap]
    pad = torch.full((*lead, rcap - flat.shape[-1]), fill,
                     dtype=buckets.dtype, device=buckets.device)
    return torch.cat([flat, pad], dim=-1)
