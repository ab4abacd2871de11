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


def assemble_proc_ref(
    msgs: torch.Tensor,                       # [s, P, d, ω]
    counts: Optional[torch.Tensor] = None,    # [s, P, d]
    counts_payload: Optional[torch.Tensor] = None,  # [s, P, d]
    *,
    fill=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Oracle for :func:`..alltoallv_deliver.assemble_proc_tiles`: stage the
    chunk into destination order — ``out[p, d, j] = msgs[j, p, d]`` — with
    the optional source-side boundary mask and transposed counts payload."""
    out = torch.movedim(msgs, 0, 2)           # [P, d, s, ω]
    if fill is not None:
        cm = torch.movedim(counts, 0, 2)      # [P, d, s]
        lane = torch.arange(msgs.shape[-1], device=msgs.device)
        out = torch.where(lane < cm[..., None], out,
                          torch.tensor(fill, dtype=msgs.dtype,
                                       device=msgs.device))
    ct = None
    if counts_payload is not None:
        ct = torch.movedim(counts_payload, 0, 2).contiguous()
    return out.contiguous(), ct
