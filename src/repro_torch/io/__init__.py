"""repro_torch.io — the asynchronous file I/O engine of the port (PEMS2 §5.1).

An io_uring-style submission/completion-queue engine
(:class:`~repro_torch.io.engine.IOEngine`) over three positional-I/O
drivers: page-cached ``buffered``, page-cache-bypassing ``odirect`` (4
KiB-aligned buffer pool, buffered fallback with a warning where the
filesystem refuses it) and an ``mmap`` adapter.  The backing tier
``tier="file"`` (:class:`repro_torch.core.FileBacking`) streams through it.

The drivers live in :mod:`repro_torch.core.backing`, the one module of the
port where raw ``os.open``/``os.preadv``/``os.pwritev`` and ``np.memmap``
are allowed (the ``block-api-only`` lint rule); they are re-exported here
under the JAX package's ``repro.io`` names, resolved on first access
because :mod:`repro_torch.core.backing` itself imports this package.
Checksums, fault injection and the sanitizer come with ``ROADMAP.md`` queue
1 item 6.
"""

from .aligned import ALIGN, AlignedPool, aligned_empty, align_down, align_up
from .engine import IOEngine, IORequest, TRANSIENT_ERRNOS

_DRIVER_NAMES = ("BufferedFile", "IO_DRIVERS", "MmapFile", "ODirectFile",
                 "ensure_file_size", "open_file")


def __getattr__(name: str):
    if name in _DRIVER_NAMES:
        from ..core import backing
        return getattr(backing, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ALIGN",
    "AlignedPool",
    "BufferedFile",
    "IOEngine",
    "IORequest",
    "IO_DRIVERS",
    "MmapFile",
    "ODirectFile",
    "TRANSIENT_ERRNOS",
    "aligned_empty",
    "align_down",
    "align_up",
    "ensure_file_size",
    "open_file",
]
