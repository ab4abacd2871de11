"""Oracles for direct delivery: masked transpose (+ fused counts)."""

from typing import Optional, Tuple

import torch


def deliver_ref(msgs: torch.Tensor, counts: torch.Tensor, *,
                fill=0) -> torch.Tensor:
    v, _, omega = msgs.shape
    t = msgs.transpose(0, 1)                    # [dst, src, ω]
    ct = counts.transpose(0, 1)                 # [dst, src]
    lane = torch.arange(omega, device=msgs.device)[None, None, :]
    return torch.where(lane < ct[..., None], t,
                       torch.tensor(fill, dtype=msgs.dtype,
                                    device=msgs.device))


def deliver_fused_ref(
    msgs: torch.Tensor,
    counts: Optional[torch.Tensor] = None,
    counts_payload: Optional[torch.Tensor] = None,
    *,
    fill=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Oracle for :func:`..ops.deliver_fused`: plain transpose when ``fill``
    is ``None``, masked transpose otherwise, plus the transposed counts
    payload."""
    if fill is None:
        out = msgs.transpose(0, 1).contiguous()
    else:
        out = deliver_ref(msgs, counts, fill=fill)
    ct = (None if counts_payload is None
          else counts_payload.transpose(0, 1).contiguous())
    return out, ct
