"""Uniform int32 keys over the whole int32 range."""

from __future__ import annotations

import torch

INT_MIN, INT_MAX = -2**31, 2**31 - 1


def rand_int32(shape, gen: torch.Generator) -> torch.Tensor:
    """Uniform int32 keys over the whole int32 range, made on ``gen``'s
    device.  Frozen copy of ``chip_smoke.py``'s ``rand_int32`` (its
    ``"random"`` kind, as PR 12-34 made the PSRS keys), kept here so that a
    later change to that script does not move the yardstick."""
    x = torch.randint(INT_MIN, INT_MAX + 1, shape, generator=gen,
                      device=gen.device, dtype=torch.int64)
    return x.to(torch.int32)


def keys(n: int, gen: torch.Generator) -> torch.Tensor:
    return rand_int32((n,), gen)
