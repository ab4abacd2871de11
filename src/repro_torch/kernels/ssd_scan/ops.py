"""The JAX package's ``ops.ssd_scan`` signature
(``repro/kernels/ssd_scan/ops.py``; returns ``y`` only), kept only so the
parity tests can call both packages alike: no code of the port calls it, and
model code must not (the model calls :func:`~.ssd_scan.ssd_scan_chunked`).  The CUDA kernel
handles a length that is not a multiple of its chunk itself (the steps past
the end are the ``dt = 0`` identity the JAX wrapper pads with);
``use_kernel=False`` is the sequential oracle route."""

from __future__ import annotations

from .ref import ssd_scan_ref
from .ssd_scan import ssd_scan_chunked


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128, use_kernel: bool = True):
    """Mamba-2 SSD scan: x [B,H,S,P], dt [B,H,S], A [H], Bm/Cm [B,S,N] →
    y [B,H,S,P]."""
    if not use_kernel:
        return ssd_scan_ref(x, dt, A, Bm, Cm)
    return ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=chunk)[0]
