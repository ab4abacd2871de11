"""repro_torch.io — the asynchronous file I/O engine of the port (PEMS2 §5.1).

An io_uring-style submission/completion-queue engine
(:class:`~repro_torch.io.engine.IOEngine`) over three positional-I/O
drivers: page-cached ``buffered``, page-cache-bypassing ``odirect`` (4
KiB-aligned buffer pool, buffered fallback with a warning where the
filesystem refuses it) and an ``mmap`` adapter.  The backing tier
``tier="file"`` (:class:`repro_torch.core.FileBacking`) and the checkpoint
manager stream through it.

Robustness layers on the same path: transient-error retries with bounded
exponential backoff in the engine, a deterministic fault-injecting driver
wrapper (:mod:`.faults`, ``io_driver="faulty:<inner>"``), per-block CRC
sidecars that detect torn writes (:mod:`.checksum`), and a runtime in-flight
race sanitizer (:mod:`.sanitize`, ``io_driver="sanitize:<inner>"``).

The drivers and the durable ``.npy`` helpers (:mod:`.npyio`) live in
:mod:`repro_torch.core.backing`, the one module of the port where raw
``os.open``/``os.preadv``/``os.pwritev``, ``np.memmap`` and binary ``open``
are allowed (the ``block-api-only`` lint rule); they are re-exported here
under the JAX package's ``repro.io`` names, resolved on first access
because :mod:`repro_torch.core.backing` itself imports this package.
"""

from .aligned import ALIGN, AlignedPool, aligned_empty, align_down, align_up
from .checksum import (
    CHECK_BLOCK,
    CHECKSUM_ALGO,
    ChecksumSidecar,
    IntegrityError,
    crc_bytes,
)
from .engine import IOEngine, IORequest, TRANSIENT_ERRNOS
from .faults import FaultSpec, FaultyFile
from .sanitize import SanitizeFinding, SanitizingFile, collect_findings

_DRIVER_NAMES = ("BufferedFile", "IO_DRIVERS", "MmapFile", "ODirectFile",
                 "ensure_file_size", "open_file")
_NPYIO_NAMES = ("create_npy_memmap", "fsync_file", "load_npy_mmap",
                "save_npy_durable")


def __getattr__(name: str):
    if name in _DRIVER_NAMES or name in _NPYIO_NAMES:
        from ..core import backing
        return getattr(backing, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ALIGN",
    "AlignedPool",
    "BufferedFile",
    "CHECK_BLOCK",
    "CHECKSUM_ALGO",
    "ChecksumSidecar",
    "FaultSpec",
    "FaultyFile",
    "IntegrityError",
    "IOEngine",
    "IORequest",
    "IO_DRIVERS",
    "MmapFile",
    "ODirectFile",
    "SanitizeFinding",
    "SanitizingFile",
    "TRANSIENT_ERRNOS",
    "aligned_empty",
    "align_down",
    "align_up",
    "collect_findings",
    "crc_bytes",
    "create_npy_memmap",
    "ensure_file_size",
    "fsync_file",
    "load_npy_mmap",
    "open_file",
    "save_npy_durable",
]
