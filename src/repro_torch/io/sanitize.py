"""Runtime in-flight I/O race sanitizer: ``io_driver="sanitize:<inner>"``
(the port's copy of the JAX package's ``io/sanitize.py``).

The static ``submit-then-mutate`` pems-lint rule catches the lexical shape
of the hazard; this wrapper catches it dynamically.  ``SanitizingFile``
wraps any driver (the proxy shape of
:class:`repro_torch.io.faults.FaultyFile`) and the
:class:`~repro_torch.io.engine.IOEngine` feeds it two duck-typed hooks:

* ``note_submit(req)`` — records the request's byte range and, for writes,
  a CRC of the buffer *as submitted*, plus the submitting stack.  A new
  range overlapping one already in flight (either side a write) is an
  **overlap** finding: the engine only serialises aligned-range conflicts
  for ``align > 1`` drivers, so unserialized overlapping writes race.
* ``note_complete(req)`` — re-CRCs the write buffer the worker actually
  transferred.  A mismatch means the caller mutated the buffer between
  submit and completion — a **mutate-in-flight** finding carrying the
  submitting stack, which names the culprit call site.

Findings accumulate on ``SanitizingFile.findings`` (thread-safe) and are
never raised mid-run — chaos/regression suites assert the list is empty
(or not, for planted races) after ``drain``.  Overhead is one CRC per
write at submit + completion and a stack capture per request: enable it in
tests and chaos runs, not in timed runs.

Compose wrappers left to right: ``"sanitize:faulty:buffered"`` sanitizes
above the fault injector.
"""

from __future__ import annotations

import threading
import traceback
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..obs import NOOP

__all__ = ["SanitizeFinding", "SanitizingFile", "collect_findings"]


def _crc(buf) -> int:
    arr = np.ascontiguousarray(buf)
    return zlib.crc32(memoryview(arr).cast("B"))


def _submit_stack() -> str:
    # Drop this helper, note_submit, and the engine's _submit frame — the
    # interesting tail is the caller that handed the buffer over.
    frames = traceback.format_stack()[:-3]
    return "".join(frames[-6:])


@dataclass
class SanitizeFinding:
    """One detected race.  ``kind`` is ``"overlap"`` (two in-flight
    requests on intersecting byte ranges, at least one a write) or
    ``"mutate-in-flight"`` (a write buffer changed between submit and
    completion).  ``stack`` is the submitting call stack of the offending
    request."""

    kind: str
    op: str
    offset: int
    nbytes: int
    path: Optional[str]
    detail: str
    stack: str

    def format(self) -> str:
        """Multi-line human-readable report of this finding."""
        return (f"sanitize: {self.kind}: {self.op} of {self.nbytes:,} B at "
                f"offset {self.offset:,} on {self.path!r}: {self.detail}\n"
                f"submitted at:\n{self.stack}")


class _Track:
    __slots__ = ("op", "lo", "hi", "crc", "stack")

    def __init__(self, op: str, lo: int, hi: int, crc: Optional[int],
                 stack: str):
        self.op = op
        self.lo = lo
        self.hi = hi
        self.crc = crc
        self.stack = stack


class SanitizingFile:
    """Driver proxy recording in-flight ranges and write-buffer CRCs.

    Pure pass-through on the data path (``pread_into``/``pwrite`` delegate
    untouched); all detection happens in the ``note_submit``/
    ``note_complete`` hooks the engine calls around a request's lifetime.
    ``tracked`` counts requests observed (proof the sanitizer was live);
    ``findings`` holds :class:`SanitizeFinding` records.
    """

    # Span tracing (attached post-construction by the executor): each
    # finding doubles as an instant event, so a trace timeline shows *when*
    # the race was detected relative to the spans around it.
    tracer = NOOP

    def __init__(self, inner):
        self.inner = inner
        self._lock = threading.Lock()
        self._inflight: Dict[int, _Track] = {}
        self.findings: List[SanitizeFinding] = []
        self.tracked = 0

    # ------------------------------------------------------------- delegation
    @property
    def path(self):
        return self.inner.path

    @property
    def align(self):
        return self.inner.align

    @property
    def driver(self):
        return f"sanitize:{self.inner.driver}"

    @property
    def fallback(self):
        return getattr(self.inner, "fallback", False)

    def flush(self):
        return self.inner.flush()

    def close(self):
        return self.inner.close()

    def pread_into(self, offset: int, out) -> int:
        return self.inner.pread_into(offset, out)

    def pwrite(self, offset: int, data) -> int:
        return self.inner.pwrite(offset, data)

    # ------------------------------------------------------------------ hooks
    def note_submit(self, req) -> None:
        """Engine hook: called under the engine lock once ``req`` joins the
        in-flight set (after any aligned-conflict serialisation, so ranges
        the engine serialises never co-exist here)."""
        lo, hi = req.offset, req.offset + req.nbytes
        crc = (_crc(req.data)
               if req.op == "write" and req.data is not None else None)
        stack = _submit_stack()
        hit = False
        with self._lock:
            for t in self._inflight.values():
                if t.lo < hi and lo < t.hi and "write" in (t.op, req.op):
                    hit = True
                    self.findings.append(SanitizeFinding(
                        kind="overlap", op=req.op, offset=req.offset,
                        nbytes=req.nbytes, path=self.path,
                        detail=(f"byte range [{lo:,}, {hi:,}) overlaps the "
                                f"in-flight {t.op} [{t.lo:,}, {t.hi:,}) — "
                                "unserialized overlapping requests race; "
                                "wait/drain between them"),
                        stack=stack))
            self._inflight[id(req)] = _Track(req.op, lo, hi, crc, stack)
            self.tracked += 1
        if hit and self.tracer.enabled:
            self.tracer.instant("sanitize:overlap", tid="events",
                                cat="sanitize", op=req.op,
                                offset=req.offset, nbytes=req.nbytes)

    def note_complete(self, req) -> None:
        """Engine hook: called from the worker after the driver op, while
        ``req.data`` is still held — the submit-time CRC is checked against
        the bytes the worker actually saw."""
        with self._lock:
            t = self._inflight.pop(id(req), None)
        if t is None or t.crc is None or req.data is None:
            return
        if _crc(req.data) != t.crc:
            f = SanitizeFinding(
                kind="mutate-in-flight", op=req.op, offset=req.offset,
                nbytes=req.nbytes, path=self.path,
                detail=("write buffer changed between submit and "
                        "completion — the caller mutated (or reused) the "
                        "buffer while the request was in flight"),
                stack=t.stack)
            with self._lock:
                self.findings.append(f)
            self.tracer.instant("sanitize:mutate-in-flight", tid="events",
                                cat="sanitize", op=req.op,
                                offset=req.offset, nbytes=req.nbytes)

    # ---------------------------------------------------------------- reports
    def format_findings(self) -> str:
        """All findings as one human-readable block (empty string if
        clean)."""
        with self._lock:
            return "\n".join(f.format() for f in self.findings)


def collect_findings(backing) -> List[SanitizeFinding]:
    """Every sanitizer finding reachable from a backing: its own driver
    file (``backing.file``) and, for a sharded backing, each shard's.
    Backings without a sanitizing driver contribute nothing."""
    out: List[SanitizeFinding] = []
    for bk in getattr(backing, "shards", None) or [backing]:
        f = getattr(bk, "file", None)
        out.extend(getattr(f, "findings", ()))
    return out
