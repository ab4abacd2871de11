"""Public sort wrapper: pads to a power of two with the dtype's maximum so
the padding sorts to the tail, then slices it off (``ops.py:27-45`` of the
JAX package).  ``use_kernel=False`` is the ``torch.sort`` reference route."""

from __future__ import annotations

import torch

from .bitonic_sort import bitonic_sort_rows


def sort(x: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    """Ascending sort of the last axis of a 1-D or 2-D tensor."""
    if not use_kernel:
        return torch.sort(x, dim=-1).values
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    rows, n = x.shape
    n_pad = _next_pow2(n)
    if n_pad != n:
        x = torch.cat([x, torch.full((rows, n_pad - n), _max_of(x.dtype),
                                     dtype=x.dtype, device=x.device)], dim=1)
    out = bitonic_sort_rows(x)[:, :n]
    return out[0] if squeeze else out


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _max_of(dtype: torch.dtype):
    if dtype.is_floating_point:
        return torch.finfo(dtype).max
    return torch.iinfo(dtype).max
