"""Per-block CRC sidecars: torn-write detection for the disk backings (the
port's copy of the JAX package's ``io/checksum.py``).

A crash, or an injected fault, can leave a block half new and half old: a
torn write.  Without integrity metadata the next read silently merges the
two generations.  This module keeps one CRC per ``CHECK_BLOCK``-byte segment
of every context row in a sidecar file next to the backing file
(``<path>.crc``), so a torn write is detected at the first read:

* segments are within-row: the grid restarts at every row start, so two rows
  never share a checksum block, and writes to disjoint row ranges (rounds,
  collectives) need no extra locking;
* a write covering a segment completely recomputes its CRC from the new bytes
  alone; a write covering one partially read-modify-writes it, verifying the
  pre-image first so a torn block is never blessed into a new checksum;
* CRCs are recorded at submission (the intended contents), so a write that
  dies midway leaves a mismatch behind by construction.

The checksum is CRC32C when the ``crc32c`` module is importable, else the
standard library's ``zlib.adler32``; the sidecar header records which wrote
it, and a sidecar written with an algorithm this interpreter lacks is
refused.  The file format (``PEMSCRC2``, a 64-byte header, then ``[v,
nseg]`` uint32 entries) is the JAX package's, so a sidecar written by either
package verifies under the other.  The header and map I/O live in
:mod:`repro_torch.core.backing`, the port's one home of raw file access.
"""

from __future__ import annotations

import errno
from typing import List, Optional, Sequence, Tuple

import numpy as np

try:                                    # SSE4.2/NEON Castagnoli when present
    from crc32c import crc32c as _crc

    CHECKSUM_ALGO = "crc32c"
    _ALGO_ID = 1
except ImportError:                     # fastest standard-library checksum
    from zlib import adler32 as _crc

    CHECKSUM_ALGO = "adler32"
    _ALGO_ID = 2

_ALGO_NAMES = {0: "crc32", 1: "crc32c", 2: "adler32"}

# Checksum granularity: few, large hash calls, while tearing happens at
# sector/page grain far below it.
CHECK_BLOCK = 64 * 1024

_MAGIC = b"PEMSCRC2"
_HEADER = 64                            # fixed header size, entries follow

__all__ = ["CHECK_BLOCK", "CHECKSUM_ALGO", "ChecksumSidecar",
           "IntegrityError", "crc_bytes", "seg_range", "span_plan"]


class IntegrityError(OSError):
    """Checksummed bytes do not match their recorded CRC: a torn write, bit
    rot, or an out-of-band mutation of the backing file.  Carries
    ``path``/``row``/``seg``; the errno is ``EBADMSG``, which the engine
    never retries."""

    def __init__(self, msg: str, *, path: Optional[str] = None,
                 row: Optional[int] = None, seg: Optional[int] = None):
        super().__init__(errno.EBADMSG, msg)
        self.path = path
        self.row = row
        self.seg = seg


def crc_bytes(buf) -> int:
    """CRC of a bytes-like or contiguous-ndarray buffer (uint32)."""
    return _crc(buf) & 0xFFFFFFFF


def seg_range(b0: int, nb: int, chk: int = CHECK_BLOCK) -> Tuple[int, int]:
    """Inclusive segment index range ``[s0, s1]`` covering bytes
    ``[b0, b0+nb)``."""
    return b0 // chk, (b0 + nb - 1) // chk


def span_plan(byte_ranges: Sequence[Tuple[int, int]], chk: int,
              rowbytes: int) -> List[Tuple[int, int, List[int]]]:
    """Plan the segment work for disjoint within-row byte ranges.

    Returns ``[(s0, s1, partial_segs)]``: maximal runs of consecutive touched
    segments, with the segments only partially covered by the ranges (those
    need a verified pre-image before their CRC is recomputed).
    """
    if not byte_ranges:
        return []
    ranges = sorted(byte_ranges)
    touched: List[int] = []
    for b0, b1 in ranges:
        s0, s1 = seg_range(b0, b1 - b0, chk)
        if touched and s0 <= touched[-1]:
            s0 = touched[-1] + 1
        touched.extend(range(s0, s1 + 1))

    def covered(seg: int) -> bool:
        g0, g1 = seg * chk, min(rowbytes, (seg + 1) * chk)
        pos = g0
        for b0, b1 in ranges:
            if b1 <= pos:
                continue
            if b0 > pos:
                return False
            pos = b1
            if pos >= g1:
                return True
        return pos >= g1

    spans: List[Tuple[int, int, List[int]]] = []
    for s in touched:
        if spans and s == spans[-1][1] + 1:
            s0, _, partial = spans[-1]
            spans[-1] = (s0, s, partial)
        else:
            spans.append((s, s, []))
        if not covered(s):
            spans[-1][2].append(s)
    return spans


class ChecksumSidecar:
    """``<data path>.crc``: one uint32 CRC per ``chk``-byte segment per row.

    Create-or-reuse like the backing files: a sidecar whose header matches
    (magic, algorithm, ``v``, ``rowbytes``, ``chk``) and size is reopened;
    anything else is recreated and ``fresh`` is set, so the owner seeds it
    (zero CRCs for a new backing file, a full recompute for an adopted one).
    """

    def __init__(self, data_path: str, v: int, rowbytes: int,
                 chk: int = CHECK_BLOCK):
        from ..core import backing
        self.data_path = data_path
        self.path = data_path + ".crc"
        self.v = v
        self.rowbytes = rowbytes
        self.chk = chk
        self.nseg = -(-rowbytes // chk)
        self.fresh = not self._reusable()
        if self.fresh:
            backing.create_sized_file(self.path, self._header(), self._size())
        self.crcs = backing.map_words(self.path, np.uint32, _HEADER,
                                      (v, self.nseg))

    def _size(self) -> int:
        return _HEADER + 4 * self.v * self.nseg

    def _header(self) -> bytes:
        h = np.zeros(_HEADER, np.uint8)
        h[:8] = np.frombuffer(_MAGIC, np.uint8)
        np.frombuffer(h, np.uint32, 3, 8)[:] = (1, _ALGO_ID, self.chk)
        np.frombuffer(h, np.uint64, 2, 24)[:] = (self.v, self.rowbytes)
        return h.tobytes()

    def _reusable(self) -> bool:
        from ..core import backing
        found = backing.read_head(self.path, _HEADER)
        if found is None:
            return False
        head, size = found
        if len(head) != _HEADER or head[:8] != _MAGIC:
            return False
        _ver, algo, chk = np.frombuffer(head, np.uint32, 3, 8)
        v, rowbytes = np.frombuffer(head, np.uint64, 2, 24)
        if ((int(v), int(rowbytes), int(chk)) != (self.v, self.rowbytes,
                                                  self.chk)
                or size != self._size()):
            return False
        if int(algo) != _ALGO_ID:
            name = _ALGO_NAMES.get(int(algo), f"algorithm #{int(algo)}")
            raise IntegrityError(
                f"checksum sidecar {self.path!r} was written with {name} but "
                f"this interpreter only has {CHECKSUM_ALGO}; install the "
                "matching module or delete the sidecar to recompute",
                path=self.path)
        return True

    def seed_zero(self) -> None:
        """Seed every entry with the CRC of an all-zero segment (a freshly
        created sparse backing file reads as zeros)."""
        z = np.zeros(self.chk, np.uint8)
        full = crc_bytes(z)
        tail_len = self.rowbytes - (self.nseg - 1) * self.chk
        tail = crc_bytes(z[:tail_len]) if tail_len != self.chk else full
        self.crcs[:, :] = full
        self.crcs[:, -1] = tail
        self.fresh = False

    def flush(self) -> None:
        self.crcs.flush()

    def seg_bounds(self, s: int) -> Tuple[int, int]:
        b0 = s * self.chk
        return b0, min(self.rowbytes, b0 + self.chk)

    def set_rows(self, r0: int, rows_u8: np.ndarray) -> None:
        """Record the CRCs of full rows ``[r0, r0+len)`` from their bytes
        (``rows_u8``: ``[rows, rowbytes]`` uint8)."""
        for i in range(rows_u8.shape[0]):
            self.set_span(r0 + i, 0, rows_u8[i])

    def verify_rows(self, r0: int, rows_u8: np.ndarray) -> None:
        for i in range(rows_u8.shape[0]):
            self.verify_span(r0 + i, 0, rows_u8[i])

    def set_span(self, row: int, s0: int, buf: np.ndarray) -> None:
        """Record CRCs for the consecutive segments from ``s0`` whose bytes
        are ``buf`` (starting exactly at ``s0``'s boundary)."""
        s, off, n = s0, 0, len(buf)
        while off < n:
            b0, b1 = self.seg_bounds(s)
            ln = b1 - b0
            self.crcs[row, s] = crc_bytes(buf[off:off + ln])
            s += 1
            off += ln

    def verify_span(self, row: int, s0: int, buf: np.ndarray) -> None:
        s, off, n = s0, 0, len(buf)
        while off < n:
            b0, b1 = self.seg_bounds(s)
            ln = b1 - b0
            got = crc_bytes(buf[off:off + ln])
            want = int(self.crcs[row, s])
            if got != want:
                raise IntegrityError(
                    f"checksum mismatch on {self.data_path!r}: row {row}, "
                    f"segment {s} (bytes [{row * self.rowbytes + b0:,}, "
                    f"{row * self.rowbytes + b1:,}) of the file): stored "
                    f"{CHECKSUM_ALGO}=0x{want:08x}, data reads 0x{got:08x} "
                    "— a torn write, bit rot, or an out-of-band mutation; "
                    "restore from the last checkpoint/superstep cursor "
                    "instead of trusting these bytes",
                    path=self.data_path, row=row, seg=s)
            s += 1
            off += ln
