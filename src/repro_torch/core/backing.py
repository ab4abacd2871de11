"""Backing tiers of the port: the external memory made real, and the
positional-I/O drivers under them.

The device tier keeps all ``v`` contexts in one ``[v, words]`` tensor on the
card.  A backing tier holds that population off the card instead — in host
RAM (``tier="host"``), in an ``np.memmap``-backed file (``tier="memmap"``),
or in a plain file reached only through the :class:`~repro_torch.io.IOEngine`
(``tier="file"``: ``pread``/``pwrite`` submission queues over a ``buffered``,
``odirect`` or ``mmap`` driver) — and the executor swaps one round's ``k``
contexts through the card at a time (``executor._run_tiered``).

Every backing exposes the same block API (``read_block``/``write_block``
over a row range with an optional column selection, plus ``drain``/
``flush``), so the executor and the host-side collectives are tier-agnostic.
``read_block(..., out=)`` fills a caller's buffer (the executor's pinned
staging buffer) instead of allocating; ``write_block`` returns the engine
requests it left in flight (``wait=False``), which hold views of the
caller's ``value`` until they complete.

The files hold the JAX package's bytes: ``[v, words]`` uint32 words, row
after row, so a backing file written by ``repro.core.backing`` reopens here
by path (create-or-reuse keeps its contents) and the other way round.  The
numpy arrays stay ``uint32``; :class:`TieredStore` hands fields out as CPU
tensors of the field's dtype.

With ``checksum=True`` a disk backing keeps a CRC sidecar
(:mod:`repro_torch.io.checksum`) beside its file and verifies every read;
``io_driver="faulty:<inner>"`` injects the faults of a ``fault_spec``
(:mod:`repro_torch.io.faults`) and ``"sanitize:<inner>"`` records in-flight
races (:mod:`repro_torch.io.sanitize`).

This module is the port's copy of the JAX package's ``core/backing.py`` and
``io/drivers.py``: every raw ``os.open``/``os.preadv``/``os.pwritev``,
``np.memmap`` and binary ``open`` of the port lives here, the one place the
``block-api-only`` lint rule allows them outside ``repro/io/`` — the
checksum sidecar's header and map, and the checkpoint layer's ``.npy``
files (:mod:`repro_torch.io.npyio`), included.
"""

from __future__ import annotations

import errno as _errno
import os
import tempfile
import warnings
import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..io.aligned import ALIGN, AlignedPool, align_down, align_up
from ..io.checksum import ChecksumSidecar, span_plan
from ..io.engine import IOEngine
from ..io.faults import FaultSpec, FaultyFile, split_shard_clause
from ..io.sanitize import SanitizingFile
from .context import WORD, ContextLayout, as_dtype

TIERS = ("device", "host", "memmap", "file")
IO_DRIVERS = ("buffered", "odirect", "mmap")

_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
              torch.uint32: np.uint32}


def np_dtype(dtype) -> np.dtype:
    """The numpy dtype of a (4-byte) field dtype."""
    return np.dtype(_NP_DTYPES[as_dtype(dtype)])


# --------------------------------------------------------------------------- #
# Positional-I/O drivers (the JAX package's io/drivers.py)                     #
# --------------------------------------------------------------------------- #

def _io_error(e: OSError, op: str, path, driver: str, offset: int,
              nbytes: int) -> OSError:
    """Re-raise helper: same errno (so the engine's transient/permanent
    classification still works), with op/offset/size/driver context and a
    hint for ENOSPC."""
    code = _errno.errorcode.get(e.errno, str(e.errno))
    msg = (f"{op} of {nbytes:,} bytes at offset {offset:,} on {path!r} "
           f"({driver} driver) failed: [{code}] {e.strerror or e}")
    if e.errno == _errno.ENOSPC:
        msg += (" — the filesystem holding this backing file is out of "
                "space; free space or point backing_path at a larger volume")
    out = OSError(e.errno, msg)
    out.__cause__ = e
    return out


def ensure_file_size(path: str, size: int) -> None:
    """Create ``path`` or extend it to ``size`` bytes — never truncate, so a
    caller-provided backing file holding real data keeps its contents."""
    try:
        if not os.path.exists(path):
            with open(path, "wb") as f:
                f.truncate(size)
        elif os.path.getsize(path) < size:
            with open(path, "r+b") as f:
                f.truncate(size)
    except OSError as e:
        code = _errno.errorcode.get(e.errno, str(e.errno))
        msg = (f"cannot create/extend backing file {path!r} to {size:,} "
               f"bytes: [{code}] {e.strerror or e}")
        if e.errno == _errno.ENOSPC:
            msg += (" — the filesystem is out of space; free space or point "
                    "backing_path at a larger volume")
        raise OSError(e.errno, msg) from e


class BufferedFile:
    """Positional buffered I/O (page-cached ``preadv``/``pwritev``)."""

    driver = "buffered"
    align = 1
    fallback = False

    def __init__(self, path: str, size: Optional[int] = None):
        self.path = path
        if size is not None:
            ensure_file_size(path, size)
        self.fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)

    def pread_into(self, offset: int, out) -> int:
        """Fill the writable buffer ``out`` from ``offset``; returns the
        syscall-level byte count."""
        mv = memoryview(out).cast("B")
        try:
            return _buffered_pread(self.fd, mv, offset)
        except OSError as e:
            raise _io_error(e, "read", self.path, self.driver, offset,
                            len(mv))

    def pwrite(self, offset: int, data) -> int:
        mv = memoryview(np.ascontiguousarray(data)).cast("B")
        try:
            return _buffered_pwrite(self.fd, mv, offset)
        except OSError as e:
            raise _io_error(e, "write", self.path, self.driver, offset,
                            len(mv))

    def flush(self) -> None:
        os.fsync(self.fd)

    def close(self) -> None:
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None


class ODirectFile:
    """``O_DIRECT`` positional I/O with an aligned bounce-buffer pool.

    Unaligned requests widen to the enclosing 4 KiB block range; unaligned
    writes first read the boundary blocks (read-modify-write) so
    neighbouring bytes survive.  The engine serialises requests whose
    aligned block ranges overlap, which makes the RMW safe under
    concurrency.  ``pread_into``/``pwrite`` return the aligned byte count.
    Where the filesystem refuses ``O_DIRECT`` (tmpfs, some network mounts)
    the driver falls back to buffered I/O with a ``RuntimeWarning`` and
    ``fallback=True``.
    """

    driver = "odirect"

    def __init__(self, path: str, size: Optional[int] = None):
        self.path = path
        if size is not None:
            # O_DIRECT transfers are whole blocks: keep the physical file an
            # exact multiple of the alignment so tail blocks stay in bounds.
            ensure_file_size(path, align_up(size, ALIGN))
        self.pool = AlignedPool(ALIGN)
        self.fallback = False
        self.align = ALIGN
        direct = getattr(os, "O_DIRECT", None)   # absent off-Linux
        if direct is None:
            self.fd = None
            self._fall_back(OSError("os.O_DIRECT not available on this "
                                    "platform"))
            return
        try:
            self.fd = os.open(path, os.O_RDWR | os.O_CREAT | direct, 0o644)
            # Some filesystems accept the flag at open() and fail at the
            # first transfer — probe with one aligned block read.
            probe = self.pool.acquire(ALIGN)
            try:
                os.preadv(self.fd, [probe], 0)
            finally:
                self.pool.release(probe)
        except OSError as e:
            self._fall_back(e)

    def _fall_back(self, err: OSError) -> None:
        warnings.warn(
            f"O_DIRECT unsupported on {self.path!r} ({err}); falling back "
            "to buffered I/O — cold-storage numbers will include the page "
            "cache",
            RuntimeWarning,
            stacklevel=3,
        )
        if getattr(self, "fd", None) is not None:
            try:
                os.close(self.fd)
            except OSError:
                pass
        self.fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
        self.fallback = True
        self.align = 1

    def pread_into(self, offset: int, out) -> int:
        mv = memoryview(out).cast("B")
        n = len(mv)
        try:
            if self.fallback:
                return _buffered_pread(self.fd, mv, offset)
            a0 = align_down(offset, ALIGN)
            a1 = align_up(offset + n, ALIGN)
            buf = self.pool.acquire(a1 - a0)
            try:
                got = os.preadv(self.fd, [buf[:a1 - a0]], a0)
                if got < a1 - a0:           # short read past the data tail
                    buf[got:a1 - a0] = 0
                mv[:] = buf[offset - a0:offset - a0 + n]
            finally:
                self.pool.release(buf)
            return a1 - a0
        except OSError as e:
            raise _io_error(e, "read", self.path, self.driver, offset, n)

    def pwrite(self, offset: int, data) -> int:
        src = memoryview(np.ascontiguousarray(data)).cast("B")
        n = len(src)
        try:
            if self.fallback:
                return _buffered_pwrite(self.fd, src, offset)
            a0 = align_down(offset, ALIGN)
            a1 = align_up(offset + n, ALIGN)
            buf = self.pool.acquire(a1 - a0)
            syscall = a1 - a0
            try:
                if a0 < offset:             # head block is partially ours
                    os.preadv(self.fd, [buf[:ALIGN]], a0)
                    syscall += ALIGN
                tail = a1 - ALIGN
                if (offset + n < a1
                        and tail >= a0 + (ALIGN if a0 < offset else 0)):
                    os.preadv(self.fd, [buf[tail - a0:a1 - a0]], tail)
                    syscall += ALIGN
                buf[offset - a0:offset - a0 + n] = src
                written = 0
                view = buf[:a1 - a0]
                while written < len(view):
                    written += os.pwritev(self.fd, [view[written:]],
                                          a0 + written)
            finally:
                self.pool.release(buf)
            return syscall
        except OSError as e:
            raise _io_error(e, "write", self.path, self.driver, offset, n)

    def flush(self) -> None:
        os.fsync(self.fd)

    def close(self) -> None:
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None


class MmapFile:
    """``np.memmap`` adapter: the memmap path behind the engine interface,
    so one submission/completion code path serves all drivers.  ``mm=``
    wraps an existing flat uint8 array instead of opening ``path`` (the
    checkpoint layer streams chunks into a memmap this way)."""

    driver = "mmap"
    align = 1
    fallback = False

    def __init__(self, path: Optional[str] = None,
                 size: Optional[int] = None, mm: Optional[np.ndarray] = None):
        if mm is not None:
            self.path = getattr(mm, "filename", None)
            self.mm = mm
            return
        ensure_file_size(path, size)
        self.path = path
        self.mm = np.memmap(path, dtype=np.uint8, mode="r+",
                            shape=(os.path.getsize(path),))

    def pread_into(self, offset: int, out) -> int:
        mv = np.frombuffer(memoryview(out).cast("B"), np.uint8)
        mv[:] = self.mm[offset:offset + mv.size]
        return mv.size

    def pwrite(self, offset: int, data) -> int:
        src = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        self.mm[offset:offset + src.size] = src
        return src.size

    def flush(self) -> None:
        if isinstance(self.mm, np.memmap):
            self.mm.flush()

    def close(self) -> None:
        self.flush()
        self.mm = None


def open_file(path: str, size: Optional[int], driver: str,
              fault_spec: Optional[str] = None):
    """Driver factory: ``buffered`` | ``odirect`` | ``mmap``, or any of
    them wrapped for fault injection as ``faulty:<inner>`` (``fault_spec``
    selects what to inject, :mod:`repro_torch.io.faults`) and/or for
    in-flight race detection as ``sanitize:<inner>``
    (:mod:`repro_torch.io.sanitize`); wrappers compose left to right, e.g.
    ``sanitize:faulty:buffered``."""
    if driver.startswith("sanitize:"):
        inner = open_file(path, size, driver.split(":", 1)[1], fault_spec)
        return SanitizingFile(inner)
    if driver.startswith("faulty:"):
        inner = open_file(path, size, driver.split(":", 1)[1])
        return FaultyFile(inner, FaultSpec.parse(fault_spec))
    if fault_spec is not None:
        raise ValueError(
            f"fault_spec requires a 'faulty:<driver>' io driver, got "
            f"{driver!r}")
    if driver == "buffered":
        return BufferedFile(path, size)
    if driver == "odirect":
        return ODirectFile(path, size)
    if driver == "mmap":
        return MmapFile(path, size)
    raise ValueError(
        f"unknown io driver {driver!r} (choose from {IO_DRIVERS}, "
        "'faulty:<driver>', or 'sanitize:<driver>')")


def _buffered_pread(fd: int, mv: memoryview, offset: int) -> int:
    total = 0
    while total < len(mv):
        n = os.preadv(fd, [mv[total:]], offset + total)
        if n == 0:
            mv[total:] = bytes(len(mv) - total)
            break
        total += n
    return len(mv)


def _buffered_pwrite(fd: int, mv: memoryview, offset: int) -> int:
    total = 0
    while total < len(mv):
        total += os.pwritev(fd, [mv[total:]], offset + total)
    return total


# --------------------------------------------------------------------------- #
# Raw file helpers of the checksum sidecar and the checkpoint layer            #
# --------------------------------------------------------------------------- #

def read_head(path: str, n: int) -> Optional[Tuple[bytes, int]]:
    """The first ``n`` bytes of ``path`` and its size, or ``None`` when it
    cannot be read (a sidecar that does not exist yet)."""
    try:
        with open(path, "rb") as f:
            head = f.read(n)
        return head, os.path.getsize(path)
    except OSError:
        return None


def create_sized_file(path: str, head: bytes, size: int) -> None:
    """(Re)create ``path`` holding ``head``, extended sparse to ``size``
    bytes."""
    with open(path, "wb") as f:
        f.write(head)
        f.truncate(size)


def map_words(path: str, dtype, offset: int, shape) -> np.memmap:
    """A writable ``np.memmap`` of ``shape`` ``dtype`` at byte ``offset``
    of ``path``."""
    return np.memmap(path, dtype=dtype, mode="r+", offset=offset,
                     shape=shape)


def fsync_file(path: str) -> None:
    """fsync an existing file by path (after a memmap flush, whose
    ``msync`` alone does not guarantee metadata durability)."""
    with open(path, "rb+") as f:
        os.fsync(f.fileno())


def save_npy_durable(path: str, arr: np.ndarray) -> None:
    """``np.save`` + flush + fsync: the array is on stable storage when
    this returns (the caller owns any atomic rename above it)."""
    with open(path, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())


def create_npy_memmap(path: str, dtype, shape) -> np.memmap:
    """A writable ``.npy``-format memmap at ``path`` (header included), for
    chunked writes that never stage the whole array in RAM."""
    return np.lib.format.open_memmap(path, mode="w+", dtype=dtype,
                                     shape=shape)


def load_npy_mmap(path: str) -> np.ndarray:
    """A read-only memmap view of a ``.npy`` file: the bounded-memory
    source of chunked restores."""
    return np.load(path, mmap_mode="r")


# --------------------------------------------------------------------------- #
# Backings                                                                     #
# --------------------------------------------------------------------------- #

def shard_row_ranges(m: int, r0: int, r1: int):
    """Split the global row range ``[r0, r1)`` at ``m``-row shard boundaries.

    Yields ``(p, a, b)`` per overlapped shard ``p`` with ``[a, b)`` the
    global sub-range it owns — the one row-addressing convention shared by
    :class:`ShardedBacking`, the executor's per-shard ledger accounting, and
    the tiered collectives."""
    for p in range(r0 // m, (r1 - 1) // m + 1):
        yield p, max(r0, p * m), min(r1, (p + 1) * m)


class ColRuns:
    """A column selection as its contiguous word runs, worked out once: the
    executor hands one to every round's block calls instead of a word-index
    array (the declared fields of a PSRS superstep at full scale are some
    10^8 words, whose runs would otherwise be found anew each call)."""

    __slots__ = ("runs", "n")

    def __init__(self, runs: List[Tuple[int, int, int]], n: int):
        self.runs = runs
        self.n = n

    @classmethod
    def of(cls, cols, words: int) -> "ColRuns":
        return cls(*_cols_runs(cols, words))


def _cols_runs(cols, words: int) -> Tuple[List[Tuple[int, int, int]], int]:
    """Normalise a column selection into contiguous word runs.

    Returns ``(runs, n)`` where each run is ``(out_start, word_start,
    nwords)`` — ``out_start`` indexing the packed destination, ``word_start``
    the context row — and ``n`` is the packed width.  ``cols`` may be
    ``None`` (everything), a unit-step slice, a sorted word-index array, or
    a :class:`ColRuns` (the executor's live/sliced selections).
    """
    if cols is None:
        return [(0, 0, words)], words
    if isinstance(cols, ColRuns):
        return cols.runs, cols.n
    if isinstance(cols, slice):
        start, stop, step = cols.indices(words)
        if step != 1:
            raise ValueError("column slices must be unit-step")
        return [(0, start, stop - start)], stop - start
    idx = np.asarray(cols)
    n = int(idx.size)
    if n == 0:
        return [], 0
    breaks = np.flatnonzero(np.diff(idx) != 1) + 1
    starts = np.concatenate([[0], breaks])
    ends = np.concatenate([breaks, [n]])
    return [(int(s), int(idx[s]), int(e - s))
            for s, e in zip(starts, ends)], n


def _check_out(out: np.ndarray, rows: int, n: int) -> None:
    if (out.dtype != np.uint32 or out.shape != (rows, n)
            or not out.flags.c_contiguous):
        raise ValueError(
            f"read_block out= must be a C-contiguous [{rows}, {n}] uint32 "
            f"array, got {out.dtype} {out.shape}")


class _ArrayBacking:
    """Shared block API for backings that expose a ``[v, words]`` ndarray."""

    arr: np.ndarray
    checksum: Optional[ChecksumSidecar] = None

    def read_block(self, r0: int, r1: int, cols=None,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        """Rows ``[r0, r1)`` with the selected columns, as a contiguous
        uint32 host copy — into ``out`` when given — copied run by run
        straight from the array."""
        rows = self.arr[r0:r1]
        runs, n = _cols_runs(cols, self.words)
        if out is None:
            out = np.empty((r1 - r0, n), np.uint32)
        else:
            _check_out(out, r1 - r0, n)
        for j, w0, nw in runs:
            out[:, j:j + nw] = rows[:, w0:w0 + nw]
        return out

    def write_block(self, r0: int, r1: int, value, cols=None,
                    wait: bool = True) -> list:
        """Write rows ``[r0, r1)``, run by run; ``value`` may broadcast
        along rows.  Synchronous here, so nothing is left in flight
        (``[]``); ``wait`` exists for the engine-backed tier."""
        value = np.asarray(value)
        if value.ndim < 2:
            value = value[None]
        for j, w0, nw in _cols_runs(cols, self.words)[0]:
            self.arr[r0:r1, w0:w0 + nw] = value[:, j:j + nw]
        return []

    def drain(self) -> None:
        pass


class HostBacking(_ArrayBacking):
    """Backing tier in host RAM: a ``[v, words]`` uint32 ndarray.  The
    executor stages each round through pinned buffers on its way to and
    from the card."""

    tier = "host"
    disk = False
    path: Optional[str] = None

    def __init__(self, v: int, words: int):
        self.v = v
        self.words = words
        self.arr = np.zeros((v, words), np.uint32)

    @property
    def nbytes(self) -> int:
        return self.arr.nbytes

    def flush(self) -> None:  # symmetry with the disk backings
        pass


class MemmapBacking(_ArrayBacking):
    """Backing tier on disk: ``np.memmap`` over a (sparse) backing file.

    The file is created sparse at exactly ``v·μ`` bytes — the PEMS2 disk
    requirement (§6.3).  A caller-provided ``path`` has create-or-reuse
    semantics: an existing file's contents are preserved (only extended when
    too small), so resuming from a populated backing file never zeroes it.
    Without a ``path`` a temporary file is created and unlinked when the
    backing is garbage-collected.  A memmap cannot be pinned, so the
    executor gathers each round from it into a pinned buffer.

    ``checksum=True`` keeps a CRC sidecar (``<path>.crc``): reads verify
    the segments they touch, writes re-record them (verifying the pre-image
    of a segment they cover only in part).  A fresh sidecar is seeded from
    zeros for a new file and recomputed for an adopted one.
    """

    tier = "memmap"
    disk = True

    def __init__(self, v: int, words: int, path: Optional[str] = None,
                 checksum: bool = False):
        owns = path is None
        if path is None:
            fd, path = tempfile.mkstemp(prefix="pems_ctx_", suffix=".bin")
            os.close(fd)
        self.path = path
        self.v = v
        self.words = words
        self.rowbytes = words * WORD
        existed = os.path.exists(path) and os.path.getsize(path) > 0
        ensure_file_size(path, v * words * WORD)   # sparse; never truncates
        self.arr = np.memmap(path, dtype=np.uint32, mode="r+",
                             shape=(v, words))
        if checksum:
            self.checksum = ChecksumSidecar(path, v, self.rowbytes)
            if self.checksum.fresh:
                if existed:        # adopt pre-existing data as it is
                    self.recompute_checksums()
                else:              # a fresh sparse file reads as zeros
                    self.checksum.seed_zero()
        if owns:
            self._finalizer = weakref.finalize(self, _unlink_quiet, path)
            weakref.finalize(self, _unlink_quiet, path + ".crc")

    @property
    def nbytes(self) -> int:
        return self.arr.nbytes

    def flush(self) -> None:
        self.arr.flush()
        if self.checksum is not None:
            self.checksum.flush()

    def _spans(self, cols):
        cs = self.checksum
        if cols is None:
            return [(0, cs.nseg - 1, [])]
        runs, _ = _cols_runs(cols, self.words)
        ranges = [(w0 * WORD, (w0 + nw) * WORD) for _, w0, nw in runs]
        return span_plan(ranges, cs.chk, self.rowbytes)

    def read_block(self, r0: int, r1: int, cols=None,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        if self.checksum is not None:
            cs, rb = self.checksum, self.arr.view(np.uint8)
            for s0, s1, _ in self._spans(cols):
                b0 = s0 * cs.chk
                b1 = min(self.rowbytes, (s1 + 1) * cs.chk)
                for i in range(r0, r1):
                    cs.verify_span(i, s0, rb[i, b0:b1])
        return super().read_block(r0, r1, cols, out)

    def write_block(self, r0: int, r1: int, value, cols=None,
                    wait: bool = True) -> list:
        if self.checksum is None:
            return super().write_block(r0, r1, value, cols, wait)
        cs, rb = self.checksum, self.arr.view(np.uint8)
        spans = self._spans(cols)
        # Verify partially covered boundary segments before folding them
        # into fresh checksums: a torn block must never be blessed.
        for _, _, partial in spans:
            for s in partial:
                b0, b1 = cs.seg_bounds(s)
                for i in range(r0, r1):
                    cs.verify_span(i, s, rb[i, b0:b1])
        super().write_block(r0, r1, value, cols, wait)
        for s0, s1, _ in spans:
            b0 = s0 * cs.chk
            b1 = min(self.rowbytes, (s1 + 1) * cs.chk)
            for i in range(r0, r1):
                cs.set_span(i, s0, rb[i, b0:b1])
        return []

    def recompute_checksums(self) -> None:
        """Re-bless every row's CRCs from the bytes on disk (recovery: after
        a crash the sidecar may record intended-but-torn writes for rows the
        resume is about to regenerate anyway)."""
        if self.checksum is None:
            return
        self.checksum.set_rows(0, self.arr.view(np.uint8))
        self.checksum.flush()
        self.checksum.fresh = False


class FileBacking:
    """Backing tier behind the :class:`~repro_torch.io.IOEngine`: the
    ``[v, words]`` population lives in a plain file reached only through
    positional ``pread``/``pwrite`` submissions.

    Reads/writes decompose into contiguous byte runs (whole row blocks for
    full swaps, split into ``chunk_bytes`` requests; per-row field runs for
    sliced/live column selections) and ride the engine's bounded submission
    queue.  ``write_block(wait=False)`` leaves the writeback in flight and
    returns its requests: they read from views of ``value`` until they
    complete, so the caller must not reuse ``value``'s memory before then
    (the executor waits on them before it refills a staging buffer).  The
    requests are the JAX package's, one for one, so the engine's
    ``syscall_*`` counters equal its.

    ``checksum=True`` keeps a CRC sidecar as :class:`MemmapBacking` does:
    whole rows are verified after they are read and their CRCs recorded
    when their write is submitted; column runs widen to checksum-segment
    bounds.  ``fault_spec`` is handed to a ``faulty:`` driver.
    """

    tier = "file"
    disk = True

    # Contiguous spans are split into requests of this size so a single big
    # swap still exercises (and benefits from) the submission queue.
    chunk_bytes = 1 << 20

    def __init__(self, v: int, words: int, path: Optional[str] = None,
                 io_driver: str = "buffered", io_queue_depth: int = 8,
                 stats=None, ledger=None, checksum: bool = False,
                 fault_spec: Optional[str] = None, io_retries: int = 2,
                 io_backoff_s: float = 0.002):
        owns = path is None
        if path is None:
            fd, path = tempfile.mkstemp(prefix="pems_ctx_", suffix=".bin")
            os.close(fd)
        self.path = path
        self.v = v
        self.words = words
        self.rowbytes = words * WORD
        self.io_driver = io_driver
        existed = os.path.exists(path) and os.path.getsize(path) > 0
        self.file = open_file(path, v * words * WORD, io_driver,
                              fault_spec=fault_spec)
        self.engine = IOEngine(self.file, queue_depth=io_queue_depth,
                               stats=stats, ledger=ledger,
                               retries=io_retries, backoff_s=io_backoff_s)
        self.checksum = None
        if checksum:
            self.checksum = ChecksumSidecar(path, v, self.rowbytes)
            if self.checksum.fresh:
                if existed:        # adopt pre-existing data as it is
                    self.recompute_checksums()
                else:              # a fresh sparse file reads as zeros
                    self.checksum.seed_zero()
        self._finalizer = weakref.finalize(
            self, _close_quiet, self.engine, path if owns else None)

    @property
    def nbytes(self) -> int:
        return self.v * self.rowbytes

    def _whole_rows_cheaper(self, runs) -> bool:
        """On an aligned driver (odirect) every per-row run widens to at
        least one whole block per direction, and sub-block rows share
        blocks (serialised RMW).  When whole rows cost no more than the
        per-run aligned requests would, move whole rows instead."""
        align = self.file.align
        return align > 1 and bool(runs) and self.rowbytes <= len(runs) * align

    # ------------------------------------------------------------- block API
    def read_block(self, r0: int, r1: int, cols=None,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        runs, n = _cols_runs(cols, self.words)
        rows = r1 - r0
        if out is None:
            out = np.empty((rows, n), np.uint32)
        else:
            _check_out(out, rows, n)
        if cols is not None and self._whole_rows_cheaper(runs):
            whole = self._read_rows(r0, r1, np.empty((rows, self.words),
                                                     np.uint32))
            if self.checksum is not None:
                self.checksum.verify_rows(r0, whole.view(np.uint8))
            for j, w0, nw in runs:
                out[:, j:j + nw] = whole[:, w0:w0 + nw]
            return out
        if cols is None:
            self._read_rows(r0, r1, out)
            if self.checksum is not None:
                self.checksum.verify_rows(r0, out.view(np.uint8))
            return out
        if self.checksum is not None:
            return self._read_cols_checksummed(r0, r1, runs, out)
        reqs = []
        for i in range(rows):
            base = (r0 + i) * self.rowbytes
            for j, w0, nw in runs:
                reqs.append(self.engine.submit_read(
                    base + w0 * WORD, out[i, j:j + nw].view(np.uint8)))
        self.engine.wait(reqs)
        return out

    def _read_rows(self, r0: int, r1: int, out: np.ndarray) -> np.ndarray:
        """Whole rows ``[r0, r1)`` into ``out`` as chunked engine reads, not
        verified (``read_block`` verifies; ``recompute_checksums`` must
        not)."""
        flat = out.reshape(-1).view(np.uint8)
        base = r0 * self.rowbytes
        total = (r1 - r0) * self.rowbytes
        reqs = []
        for o in range(0, total, self.chunk_bytes):
            nb = min(self.chunk_bytes, total - o)
            reqs.append(self.engine.submit_read(base + o, flat[o:o + nb]))
        self.engine.wait(reqs)
        return out

    def _read_cols_checksummed(self, r0: int, r1: int, runs,
                               out: np.ndarray) -> np.ndarray:
        """Column-run reads widened to checksum-segment bounds, so every
        returned byte is covered by a verified segment."""
        cs = self.checksum
        ranges = [(w0 * WORD, (w0 + nw) * WORD) for _, w0, nw in runs]
        spans = span_plan(ranges, cs.chk, self.rowbytes)
        reqs, bufs = [], []
        for i in range(r1 - r0):
            base = (r0 + i) * self.rowbytes
            for s0, s1, _ in spans:
                b0 = s0 * cs.chk
                b1 = min(self.rowbytes, (s1 + 1) * cs.chk)
                scr = np.empty(b1 - b0, np.uint8)
                reqs.append(self.engine.submit_read(base + b0, scr))
                bufs.append((i, s0, b0, scr))
        self.engine.wait(reqs)
        for i, s0, b0, scr in bufs:
            cs.verify_span(r0 + i, s0, scr)
            hi = b0 + len(scr)
            for j, w0, nw in runs:
                rb0, rb1 = w0 * WORD, (w0 + nw) * WORD
                lo2, hi2 = max(rb0, b0), min(rb1, hi)
                if lo2 < hi2:
                    src = scr[lo2 - b0:hi2 - b0].view(np.uint32)
                    o0 = j + (lo2 - rb0) // WORD
                    out[i, o0:o0 + src.size] = src
        return out

    def write_block(self, r0: int, r1: int, value, cols=None,
                    wait: bool = True) -> list:
        """Write rows ``[r0, r1)`` (``value`` may broadcast along rows);
        returns the requests left in flight — ``[]`` when ``wait``."""
        runs, n = _cols_runs(cols, self.words)
        rows = r1 - r0
        value = np.broadcast_to(np.asarray(value), (rows, n))
        if cols is not None and self._whole_rows_cheaper(runs):
            # Read-modify-write whole rows: cheaper than per-run aligned
            # RMW on every row, and immune to shared-boundary-block
            # serialisation.  Callers never write the same rows
            # concurrently (rounds/collectives touch disjoint row ranges).
            whole = self.read_block(r0, r1, None)      # verified
            for j, w0, nw in runs:
                whole[:, w0:w0 + nw] = value[:, j:j + nw]
            return self.write_block(r0, r1, whole, None, wait=wait)
        if cols is not None and self.checksum is not None:
            return self._write_cols_checksummed(r0, r1, value, runs, n,
                                                wait)
        # Fire-and-forget writebacks auto-reap their completions (errors
        # still surface at the superstep's drain); waited writes are reaped
        # by wait() itself.  Either way the completion list stays bounded.
        reqs = []
        if cols is None:
            buf = np.ascontiguousarray(value)
            if self.checksum is not None:
                # Record the intended CRCs at submission: a write that dies
                # midway leaves a detectable mismatch behind.
                self.checksum.set_rows(r0, buf.view(np.uint8))
            flat = buf.reshape(-1).view(np.uint8)
            base = r0 * self.rowbytes
            total = rows * self.rowbytes
            for o in range(0, total, self.chunk_bytes):
                nb = min(self.chunk_bytes, total - o)
                reqs.append(self.engine.submit_write(
                    base + o, flat[o:o + nb], auto_reap=not wait))
        else:
            for i in range(rows):
                base = (r0 + i) * self.rowbytes
                for j, w0, nw in runs:
                    reqs.append(self.engine.submit_write(
                        base + w0 * WORD,
                        np.ascontiguousarray(value[i, j:j + nw]),
                        auto_reap=not wait))
        if wait:
            self.engine.wait(reqs)
            return []
        return reqs

    def _write_cols_checksummed(self, r0: int, r1: int, value, runs, n,
                                wait: bool) -> list:
        """Column-run writes at checksum-segment granularity: the new bytes
        come from ``value``; partially covered boundary segments read (and
        verify) their pre-image first, so neighbouring bytes survive under a
        CRC that was never blessed over torn data.  Each request writes a
        scratch buffer of its own."""
        cs = self.checksum
        rows = r1 - r0
        vb = np.ascontiguousarray(value).view(np.uint8).reshape(
            rows, n * WORD)
        ranges = [(w0 * WORD, (w0 + nw) * WORD) for _, w0, nw in runs]
        spans = span_plan(ranges, cs.chk, self.rowbytes)
        pre_reqs, items = [], []
        for i in range(rows):
            base = (r0 + i) * self.rowbytes
            for s0, s1, partial in spans:
                b0 = s0 * cs.chk
                b1 = min(self.rowbytes, (s1 + 1) * cs.chk)
                buf = np.empty(b1 - b0, np.uint8)
                for s in partial:
                    p0, p1 = cs.seg_bounds(s)
                    pre_reqs.append(self.engine.submit_read(
                        base + p0, buf[p0 - b0:p1 - b0]))
                items.append((i, s0, b0, buf, partial))
        if pre_reqs:
            self.engine.wait(pre_reqs)
        wreqs = []
        for i, s0, b0, buf, partial in items:
            row = r0 + i
            for s in partial:
                p0, p1 = cs.seg_bounds(s)
                cs.verify_span(row, s, buf[p0 - b0:p1 - b0])
            hi = b0 + len(buf)
            for j, w0, nw in runs:
                rb0, rb1 = w0 * WORD, (w0 + nw) * WORD
                lo2, hi2 = max(rb0, b0), min(rb1, hi)
                if lo2 < hi2:
                    buf[lo2 - b0:hi2 - b0] = vb[
                        i, j * WORD + (lo2 - rb0):j * WORD + (hi2 - rb0)]
            cs.set_span(row, s0, buf)
            wreqs.append(self.engine.submit_write(
                row * self.rowbytes + b0, buf, auto_reap=not wait))
        if wait:
            self.engine.wait(wreqs)
            return []
        return wreqs

    def recompute_checksums(self) -> None:
        """Re-bless every row's CRCs from the bytes on disk (recovery: after
        a crash the sidecar may record intended-but-torn writes for rows the
        resume is about to regenerate anyway)."""
        if self.checksum is None:
            return
        step = max(1, self.chunk_bytes // self.rowbytes)
        for r in range(0, self.v, step):
            r1 = min(self.v, r + step)
            rows = self._read_rows(r, r1, np.empty((r1 - r, self.words),
                                                   np.uint32))
            self.checksum.set_rows(r, rows.view(np.uint8))
        self.checksum.flush()
        self.checksum.fresh = False

    def drain(self) -> None:
        self.engine.drain()

    def flush(self) -> None:
        self.engine.fsync()
        if self.checksum is not None:
            self.checksum.flush()

    def close(self) -> None:
        self._finalizer()


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _close_quiet(engine, unlink_path: Optional[str]) -> None:
    try:
        engine.close()
    except Exception:
        pass
    if unlink_path is not None:
        _unlink_quiet(unlink_path)
        _unlink_quiet(unlink_path + ".crc")


class ShardedBacking:
    """The parallel disk model (thesis §6.3): ``P`` disjoint ``v/P``-row
    shards, one per real processor, each a full backing of its own.

    Shard ``p`` owns rows ``[p·m, (p+1)·m)`` of the global population in its
    own file (``<path>.shard<p>``, or a private temp file when no path is
    given) and, on ``tier="file"``, its own engine and driver — ``P``
    submission queues.  Per-shard ``stats``/``ledger`` objects
    (``shard_stats``/``shard_ledgers``) receive each shard's measured
    traffic.  The block API takes *global* row ranges and splits them at
    shard boundaries; there is deliberately no whole-population ``arr``.

    Fault injection composes with sharding: a ``fault_spec`` carrying a
    ``shard=N`` clause reaches shard ``N``'s driver only, and the other
    shards drop ``faulty`` from their driver chain — the single-disk-failure
    model that per-process recovery is built for.
    """

    def __init__(self, tier: str, v: int, words: int, nshards: int,
                 path: Optional[str] = None, *,
                 io_driver: Optional[str] = None, io_queue_depth: int = 8,
                 shard_stats=None, shard_ledgers=None, checksum: bool = False,
                 fault_spec: Optional[str] = None, io_retries: int = 2,
                 io_backoff_s: float = 0.002):
        if tier not in ("host", "memmap", "file"):
            raise ValueError(f"cannot shard tier {tier!r}")
        if nshards < 1 or v % nshards:
            raise ValueError(
                f"v={v} must divide into nshards={nshards} equal row shards")
        self.tier = tier
        self.v = v
        self.words = words
        self.rowbytes = words * WORD
        self.P = nshards
        self.m = v // nshards
        self.path = path
        target, spec = split_shard_clause(fault_spec)
        if target is not None and target >= nshards:
            raise ValueError(
                f"fault_spec targets shard {target} but only "
                f"{nshards} shards exist")
        self.shards = []
        for p in range(nshards):
            sp = None if path is None else f"{path}.shard{p}"
            drv, fs = io_driver, None
            if "faulty" in (io_driver or "").split(":")[:-1]:
                if target is None or target == p:
                    fs = spec or None
                else:
                    # Healthy shards run without the injector; the other
                    # wrappers of the chain (sanitize:) stay on.
                    drv = ":".join(w for w in io_driver.split(":")
                                   if w != "faulty")
            self.shards.append(make_backing(
                tier, self.m, words, sp, io_driver=drv,
                io_queue_depth=io_queue_depth,
                stats=None if shard_stats is None else shard_stats[p],
                ledger=None if shard_ledgers is None else shard_ledgers[p],
                checksum=checksum, fault_spec=fs,
                io_retries=io_retries, io_backoff_s=io_backoff_s))
            eng = getattr(self.shards[p], "engine", None)
            if eng is not None:
                eng.name = f"shard{p}"
        self.disk = self.shards[0].disk

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.shards)

    @property
    def checksum(self):
        """The shards' sidecars as a tuple, or ``None`` when no shard is
        checksummed (truthiness as for a single backing)."""
        cs = tuple(s.checksum for s in self.shards)
        return cs if any(c is not None for c in cs) else None

    # ------------------------------------------------------------- block API
    def read_block(self, r0: int, r1: int, cols=None,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        """Global rows ``[r0, r1)``, concatenated across shard boundaries
        (or each shard's rows straight into its slice of ``out``)."""
        ranges = list(shard_row_ranges(self.m, r0, r1))
        if out is not None:
            _check_out(out, r1 - r0, _cols_runs(cols, self.words)[1])
            for p, a, b in ranges:
                self.shards[p].read_block(a - p * self.m, b - p * self.m,
                                          cols, out=out[a - r0:b - r0])
            return out
        parts = [self.shards[p].read_block(a - p * self.m, b - p * self.m,
                                           cols)
                 for p, a, b in ranges]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)

    def write_block(self, r0: int, r1: int, value, cols=None,
                    wait: bool = True) -> list:
        """Write global rows ``[r0, r1)``; ``value`` may broadcast along
        rows (a ``[1, n]`` block lands in every row, as for bcast).
        Returns the requests left in flight."""
        val = np.asarray(value)
        bcast = val.ndim < 2 or val.shape[0] == 1
        reqs = []
        for p, a, b in shard_row_ranges(self.m, r0, r1):
            sub = val if bcast else val[a - r0:b - r0]
            reqs += self.shards[p].write_block(
                a - p * self.m, b - p * self.m, sub, cols, wait=wait)
        return reqs

    def drain(self) -> None:
        for s in self.shards:
            s.drain()

    def drain_shard(self, p: int) -> None:
        self.shards[p].drain()

    def flush(self) -> None:
        for s in self.shards:
            s.flush()

    def flush_shard(self, p: int) -> None:
        """Durability for one shard only: the per-process recovery commit
        (a stage run with ``procs=[p]`` writes nothing outside shard p)."""
        self.shards[p].flush()

    def recompute_checksums(self, shard: Optional[int] = None) -> None:
        """Re-bless CRCs from the bytes on disk — every shard, or just one
        (per-process recovery touches only the failed shard's sidecar)."""
        for s in self.shards if shard is None else [self.shards[shard]]:
            if s.checksum is not None:
                s.recompute_checksums()

    def close(self) -> None:
        for s in self.shards:
            close = getattr(s, "close", None)
            if close is not None:
                close()


def make_backing(tier: str, v: int, words: int,
                 path: Optional[str] = None, *,
                 P: int = 1,
                 io_driver: Optional[str] = None, io_queue_depth: int = 8,
                 stats=None, ledger=None,
                 shard_stats=None, shard_ledgers=None,
                 checksum: bool = False,
                 fault_spec: Optional[str] = None, io_retries: int = 2,
                 io_backoff_s: float = 2e-3):
    """Construct a backing for ``v`` rows of ``words`` uint32 words.

    ``P > 1`` returns a :class:`ShardedBacking` — one inner backing (and on
    the file tier one engine) per process, billing ``shard_stats[p]`` /
    ``shard_ledgers[p]``.  ``P == 1`` returns the plain single backing,
    billing ``stats``/``ledger``; a leading ``shard=`` clause in
    ``fault_spec`` is stripped (there is only one shard to target).
    ``checksum`` keeps CRC sidecars on the disk tiers (the host tier has
    none)."""
    if tier == "device":
        raise ValueError("tier='device' has no backing store")
    if P > 1:
        return ShardedBacking(tier, v, words, P, path,
                              io_driver=io_driver,
                              io_queue_depth=io_queue_depth,
                              shard_stats=shard_stats,
                              shard_ledgers=shard_ledgers,
                              checksum=checksum, fault_spec=fault_spec,
                              io_retries=io_retries,
                              io_backoff_s=io_backoff_s)
    _, fault_spec = split_shard_clause(fault_spec)
    if tier == "host":
        return HostBacking(v, words)
    if tier == "memmap":
        return MemmapBacking(v, words, path, checksum=checksum)
    if tier == "file":
        return FileBacking(v, words, path,
                           io_driver=io_driver or "buffered",
                           io_queue_depth=io_queue_depth,
                           stats=stats, ledger=ledger, checksum=checksum,
                           fault_spec=fault_spec or None,
                           io_retries=io_retries,
                           io_backoff_s=io_backoff_s)
    raise ValueError(f"unknown backing tier {tier!r} (choose from {TIERS})")


# --------------------------------------------------------------------------- #
# Store                                                                        #
# --------------------------------------------------------------------------- #

class TieredStore:
    """Host/disk-resident context store with the :class:`ContextStore` field
    API.  It mutates its backing in place and returns ``self``, as the
    port's device store does.

    ``field``/``field_rows`` return CPU tensors of the field's dtype (the
    result lives where the population lives); ``with_field``/
    ``with_field_rows`` accept CPU or CUDA tensors, or numpy arrays.  With a
    ``ledger`` (the executor passes its own) every field access on a disk
    backing (``memmap`` and ``file``) records the measured disk traffic;
    under a :class:`ShardedBacking` pass ``shard_ledgers`` too, and the
    traffic is split at shard boundaries and billed to the owning shard.
    Callers of the backing's block API account for themselves.
    """

    def __init__(self, layout: ContextLayout, backing, ledger=None,
                 shard_ledgers=None):
        self.layout = layout
        self.backing = backing
        self.ledger = ledger
        self.shard_ledgers = shard_ledgers

    @property
    def tier(self) -> str:
        return self.backing.tier

    @property
    def on_disk(self) -> bool:
        """Whether field traffic is physical disk traffic (ledger-counted)."""
        return self.backing.disk

    @property
    def data(self) -> torch.Tensor:
        """The full ``[v, words]`` population as an int32 CPU tensor over
        the backing's memory (the port's store words).  Only
        array-addressable tiers (host/memmap) have one; the ``file`` tier
        and a sharded backing are reached through the block API."""
        return torch.from_numpy(self.backing.arr.view(np.int32))

    @property
    def v(self) -> int:
        return self.backing.v

    @property
    def mu_bytes(self) -> int:
        return self.layout.mu_bytes

    def _account(self, r0: int, r1: int, row_bytes: int, write: bool) -> None:
        """Bill ``(r1-r0)·row_bytes`` of field traffic to the owning
        ledger(s)."""
        if not self.on_disk:
            return
        if self.shard_ledgers is not None and hasattr(self.backing, "m"):
            for p, a, b in shard_row_ranges(self.backing.m, r0, r1):
                led = self.shard_ledgers[p]
                if led is not None:
                    (led.add_disk_write if write
                     else led.add_disk_read)((b - a) * row_bytes)
            return
        if self.ledger is not None:
            (self.ledger.add_disk_write if write
             else self.ledger.add_disk_read)((r1 - r0) * row_bytes)

    def field(self, name: str) -> torch.Tensor:
        """A field across all contexts → ``[v, *shape]`` CPU tensor."""
        return self.field_rows(name, 0, self.v)

    def field_rows(self, name: str, r0: int, r1: int) -> torch.Tensor:
        """A field for contexts ``[r0, r1)`` → ``[r1-r0, *shape]`` CPU
        tensor (the per-process collectives read one shard's rows)."""
        off = self.layout.offset(name)
        f = self.layout.field(name)
        w = self.backing.read_block(r0, r1, cols=slice(off, off + f.words))
        self._account(r0, r1, f.words * WORD, write=False)
        return torch.from_numpy(w.view(np_dtype(f.dtype))).reshape(
            (r1 - r0,) + f.shape)

    def with_field(self, name: str, value) -> "TieredStore":
        """Write a field across all contexts (in place; returns ``self``)."""
        return self.with_field_rows(name, 0, value, rows=self.v)

    def with_field_rows(self, name: str, r0: int, value,
                        rows: Optional[int] = None) -> "TieredStore":
        """Write a field for contexts ``[r0, r0+rows)`` (in place; returns
        ``self``).  ``rows`` defaults to ``value``'s leading dimension;
        ``value`` is converted to the field's dtype."""
        off = self.layout.offset(name)
        f = self.layout.field(name)
        w = _field_words(value, f)
        if rows is None:
            rows = w.size // f.words
        self.backing.write_block(r0, r0 + rows, w.reshape(rows, f.words),
                                 cols=slice(off, off + f.words))
        self._account(r0, r0 + rows, f.words * WORD, write=True)
        return self

    def load_rows(self, r0: int, words: np.ndarray) -> None:
        """Write whole rows ``[r0, r0 + len(words))`` from ``[rows, words]``
        uint32 words: loading a population (an ``init_fn``'s contexts, a
        store carried over from the JAX package), deliberately outside the
        ledger, whose closed forms cover the algorithm's supersteps and not
        the one-time load of its input (the JAX package's ``init``)."""
        self.backing.write_block(r0, r0 + words.shape[0], words)

    def field_bytes(self, name: str) -> int:
        return self.layout.field_bytes(name)

    def flush(self) -> None:
        self.backing.flush()


def _field_words(value, f) -> np.ndarray:
    """``value`` converted to field ``f``'s dtype, as flat uint32 words."""
    if isinstance(value, torch.Tensor):
        value = value.detach().to(device="cpu", dtype=f.dtype)
        value = value.contiguous().view(torch.int32).numpy()
    else:
        value = np.asarray(value).astype(np_dtype(f.dtype), copy=False)
    return np.ascontiguousarray(value).reshape(-1).view(np.uint32)
