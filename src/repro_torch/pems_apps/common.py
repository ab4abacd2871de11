"""Shared helpers for BSP applications: destination grouping for Alltoallv
message assembly (the "bucketising" every CGM algorithm performs), batched
over a round's contexts."""

from __future__ import annotations

from typing import Tuple

import torch

INT_MAX = torch.iinfo(torch.int32).max


def group_by_dest(
    values: torch.Tensor,     # [k, n] or [k, n, w] payloads
    dests: torch.Tensor,      # [k, n] destination VP ids in [0, v)
    v: int,
    cap: int,
    fill=0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack per-element payloads into per-destination message slots, for
    each of the ``k`` contexts.

    Returns ``(msgs [k, v, cap(, w)], counts [k, v] int32, slot_pos [k, n],
    ok [k])`` where ``slot_pos[b, i]`` is the position of element ``i``
    inside message ``msgs[b, dests[b, i]]`` and ``ok`` is False where a
    destination received more than ``cap`` elements (capacity overflow — the
    caller's ω bound was violated; the overflowing slots then hold one of the
    colliding values)."""
    k, n = dests.shape
    dev = dests.device
    dests = dests.to(torch.int64)
    order = torch.argsort(dests, dim=1, stable=True)
    sorted_d = torch.gather(dests, 1, order)
    # Start offset of each destination group in the sorted order.
    start = torch.searchsorted(
        sorted_d, torch.arange(v, device=dev).expand(k, v).contiguous())
    pos_sorted = torch.arange(n, device=dev) - torch.gather(start, 1, sorted_d)
    rows = torch.arange(k, device=dev)[:, None]
    # Each destination's count is the distance between its group's start
    # and the next one's: no bincount, which on a CUDA tensor reads its
    # largest value back to the host and so keeps it from queueing another
    # card's rounds meanwhile.
    counts = torch.diff(start, dim=1, append=torch.full(
        (k, 1), n, dtype=start.dtype, device=dev)).to(torch.int32)
    ok = counts.max(dim=1).values <= cap

    payload = values if values.dim() > 2 else values[..., None]
    w = payload.shape[2]
    msgs = torch.full((k, v, cap, w), fill, dtype=payload.dtype, device=dev)
    safe_pos = torch.clamp(pos_sorted, max=cap - 1)  # clamp on overflow
    msgs.index_put_((rows.expand(k, n), sorted_d, safe_pos),
                    torch.gather(payload, 1,
                                 order[..., None].expand(k, n, w)))

    # slot position for each *original* element.
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=dev).expand(k, n))
    slot_pos = torch.gather(safe_pos, 1, inv)

    if values.dim() == 2:
        msgs = msgs[..., 0]
    return msgs, counts, slot_pos, ok


def take_from_slots(msgs: torch.Tensor, dests: torch.Tensor,
                    slot_pos: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`group_by_dest` for response routing, for each of
    the ``k`` contexts: element ``i`` of context ``b`` gets ``msgs[b,
    dests[b, i], slot_pos[b, i]]``.  ``msgs`` is ``[k, v, cap(, w)]``,
    ``dests``/``slot_pos`` ``[k, n]``; returns ``[k, n(, w)]``."""
    rows = torch.arange(dests.shape[0], device=dests.device)[:, None]
    return msgs[rows, dests.to(torch.int64), slot_pos.to(torch.int64)]
