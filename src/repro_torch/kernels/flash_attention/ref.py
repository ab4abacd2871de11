"""Oracle for flash attention (GQA, causal/full, length-masked), the port of
``repro/kernels/flash_attention/ref.py``."""

from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, scale: float | None = None,
                  sk_valid: int | None = None) -> torch.Tensor:
    """q [B, Hq, Sq, d], k/v [B, Hkv, Sk, d] → [B, Hq, Sq, d]."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    sk_valid = sk if sk_valid is None else sk_valid

    kr = torch.repeat_interleave(k, group, dim=1).float()
    vr = torch.repeat_interleave(v, group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    col = torch.arange(sk, device=q.device)
    mask = (col < sk_valid)[None, :]
    if causal:
        mask = mask & (col[None, :] <= torch.arange(sq, device=q.device)[:, None])
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0.0, 1.0, denom)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)
