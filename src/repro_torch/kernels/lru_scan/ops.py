"""The JAX package's ``ops.lru_scan`` signature
(``repro/kernels/lru_scan/ops.py``; returns ``h`` only, in ``a``'s dtype),
kept only so the parity tests can call both packages alike: no code of the
port calls it, and model code must not (the model calls
:func:`~.lru_scan.lru_scan_chunked`).  The CUDA kernel handles a length that
is not a multiple of the chunk itself, so nothing is padded;
``use_kernel=False`` is the sequential oracle route."""

from __future__ import annotations

from .lru_scan import lru_scan_chunked
from .ref import lru_scan_ref


def lru_scan(a, b, *, chunk: int = 256, use_kernel: bool = True):
    """Gated linear recurrence h_t = a_t⊙h_{t−1} + b_t over [B, S, D]."""
    if not use_kernel:
        return lru_scan_ref(a, b)
    return lru_scan_chunked(a, b, chunk=chunk)[0].to(a.dtype)
