"""Public sort wrapper: pads to a power of two with a key that sorts after
every real one, then slices it off (``ops.py:27-45`` of the JAX package).
``use_kernel=False`` is the ``torch.sort`` reference route.

The order is ``jnp.sort``'s (the JAX package's default route), which
``torch.sort(stable=True)`` also gives: the two zeros tie in input order,
and every NaN ties after ``+inf``.  The pad is NaN for floats and the
maximum for integers (``True`` for bool): it ties with the largest key a
row can hold, and the sort is stable, so it stays after every real key,
NaNs and ``+inf`` included.  (The JAX package's Pallas route pads float
rows with ``finfo.max``, which sorts before ``+inf``, so a padded row loses
its ``+inf`` there; the port follows ``jnp.sort``.)"""

from __future__ import annotations

import torch

from .bitonic_sort import bitonic_sort_rows


def sort(x: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    """Ascending sort of the last axis of a 1-D or 2-D tensor."""
    if not use_kernel:
        return torch.sort(x, dim=-1, stable=True).values
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    rows, n = x.shape
    n_pad = _next_pow2(n)
    if n_pad != n:
        x = torch.cat([x, torch.full((rows, n_pad - n), _pad_of(x.dtype),
                                     dtype=x.dtype, device=x.device)], dim=1)
    out = bitonic_sort_rows(x)[:, :n]
    return out[0] if squeeze else out


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _pad_of(dtype: torch.dtype):
    """A key that ties with the largest key of ``dtype``: NaN, the integer
    maximum, or ``True``."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max
