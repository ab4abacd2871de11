"""LR schedules: the port of ``repro/optim/schedule.py``."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``floor`` of peak; returns the
    multiplicative lr scale (a float32 0-d tensor) for
    ``adamw_update(lr_scale=...)``.  Step 0 gives 0: the first step moves no
    parameter."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos
