"""Aligned, reusable host buffers for O_DIRECT transfers (the port's own
copy of the JAX package's ``io/aligned.py``; numpy only).

O_DIRECT requires the user buffer, the file offset, and the transfer length
to all be aligned to the device's logical block size.  numpy gives no
alignment guarantee, so :func:`aligned_empty` over-allocates and slices to a
4 KiB boundary, and :class:`AlignedPool` recycles those buffers across
requests — the ``odirect`` driver's workers acquire/release per transfer instead of
allocating, exactly the reusable-buffer structure of STXXL-style engines.
"""

from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np

ALIGN = 4096   # conservative logical block size (covers 512e and 4Kn disks)


def align_down(x: int, align: int = ALIGN) -> int:
    return x - (x % align)


def align_up(x: int, align: int = ALIGN) -> int:
    return x + (-x % align)


def aligned_empty(nbytes: int, align: int = ALIGN) -> np.ndarray:
    """An uninitialised uint8 buffer whose data pointer is ``align``-aligned
    (and whose length is an exact multiple of ``align``)."""
    nbytes = align_up(max(nbytes, 1), align)
    try:
        raw = np.empty(nbytes + align, np.uint8)
    except MemoryError as e:
        raise MemoryError(
            f"cannot allocate a {nbytes + align:,}-byte aligned I/O bounce "
            "buffer (O_DIRECT pool); lower io_queue_depth or the transfer "
            "chunk size, or free host memory") from e
    off = (-raw.ctypes.data) % align
    buf = raw[off:off + nbytes]
    assert buf.ctypes.data % align == 0
    return buf


class AlignedPool:
    """Thread-safe free list of aligned buffers, bucketed by size.

    ``acquire`` returns a buffer of at least ``nbytes`` (rounded up to the
    alignment); ``release`` returns it for reuse.  The pool holds at most
    ``max_per_size`` free buffers per size class so a queue-depth burst does
    not pin memory forever.
    """

    def __init__(self, align: int = ALIGN, max_per_size: int = 32):
        self.align = align
        self.max_per_size = max_per_size
        self._lock = threading.Lock()
        self._free: Dict[int, List[np.ndarray]] = {}

    def acquire(self, nbytes: int) -> np.ndarray:
        size = align_up(max(nbytes, 1), self.align)
        with self._lock:
            bucket = self._free.get(size)
            if bucket:
                return bucket.pop()
        return aligned_empty(size, self.align)

    def release(self, buf: np.ndarray) -> None:
        with self._lock:
            bucket = self._free.setdefault(buf.nbytes, [])
            if len(bucket) < self.max_per_size:
                bucket.append(buf)
