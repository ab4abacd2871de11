"""Deterministic, seed-driven fault injection below the I/O engine (the
port's copy of the JAX package's ``io/faults.py``).

``FaultyFile`` wraps any positional driver (``buffered``/``odirect``/``mmap``)
behind the same ``pread_into``/``pwrite`` API, so the whole stack above it —
engine retries, backing-tier checksums, superstep recovery — exercises real
failure paths without real hardware faults.  Select it with
``PemsConfig(io_driver="faulty:<inner>", fault_spec=...)`` or
``open_file(..., "faulty:<inner>", fault_spec=...)``.  The same spec over
the same sequence of driver calls injects at the same calls as the JAX
package's wrapper.

Fault-spec grammar (semicolon-separated clauses)::

    spec   := clause (";" clause)*
    clause := "seed=" N | "shard=" N | kind "@" sel [":" param]
    kind   := "eio" | "torn" | "lat" | "enospc" | "kill"
    sel    := [op] ("*" | N | N "-" M | "p" FLOAT | "b" LO "-" HI)
    op     := "w" | "r"              -- restrict to writes / reads

``shard=N`` is not a fault of its own: under a sharded backing (``P > 1``,
one backing file + driver per mesh process) it restricts the *whole spec* to
shard ``N``'s driver — the other shards run the clean inner driver, the
single-disk-failure model.  It is stripped by :func:`split_shard_clause`
before parsing; with no ``shard=`` clause the spec applies to every shard
(and at ``P == 1`` to the only one).  Byte-range (``b``) selectors address
offsets within the *shard's own* file.

Selectors address driver-level request *attempts* (engine retries re-count),
either by per-op index (``w3``, ``r0-4``), by overall match (``*``), by a
seeded pseudo-random probability (``p0.02`` — deterministic in
``(seed, op, index)``), or by file byte range overlap (``b0-65535``).

Per-kind parameter:

* ``eio``: ``xK`` — the matching request fails ``K`` consecutive attempts
  with ``EIO`` before succeeding (default 1), so bounded engine retries can
  be proven to absorb it (or to exhaust).
* ``torn``: fraction of the payload actually written, default ``0.5``.
  Torn writes are **silent** — the driver reports full success, exactly like
  a power cut after a partial sector flush; only checksums can catch them.
* ``lat``: seconds of injected latency, default ``0.001``.
* ``enospc``: no parameter; raises ``ENOSPC`` (permanent — never retried).
* ``kill``: no parameter; ``SIGKILL``s the *process* at the matching request,
  i.e. genuine mid-I/O death for crash-recovery tests.

Example: ``"seed=7;eio@p0.02:x2;lat@p0.01:0.003;torn@w44"``.

Indices count every attempt the engine issues, so under ``queue_depth > 1``
the mapping from index to logical request depends on scheduling; tests that
need exact determinism use ``queue_depth=1`` or byte-range selectors.
"""

from __future__ import annotations

import errno
import os
import re
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs import NOOP

_KINDS = ("eio", "torn", "lat", "enospc", "kill")

_SEL_RE = re.compile(
    r"^(?P<op>[wr])?(?:(?P<star>\*)|p(?P<prob>[0-9.]+)"
    r"|b(?P<blo>\d+)-(?P<bhi>\d+)|(?P<lo>\d+)(?:-(?P<hi>\d+))?)$"
)


def split_shard_clause(spec: Optional[str]):
    """Strip the optional ``shard=N`` clause out of a fault spec.

    Returns ``(shard, rest)`` — ``shard`` is the targeted shard index (or
    ``None`` when the spec names no shard, meaning "every shard") and
    ``rest`` is the spec with the clause removed, ready for
    :meth:`FaultSpec.parse`.  The sharded backing hands ``rest`` only to
    shard ``shard``'s driver; all other shards get the clean inner driver.
    """
    if not spec:
        return None, spec
    shard = None
    keep = []
    for raw in spec.split(";"):
        s = raw.strip()
        if s.startswith("shard="):
            try:
                shard = int(s[6:])
            except ValueError:
                raise ValueError(f"bad fault_spec shard clause {s!r}")
            if shard < 0:
                raise ValueError(f"fault_spec shard index must be >= 0: {s!r}")
            continue
        if s:
            keep.append(s)
    return shard, ";".join(keep)


@dataclass
class _Clause:
    kind: str
    op: Optional[str] = None            # "read" | "write" | None
    lo: Optional[int] = None            # request-index range (inclusive)
    hi: Optional[int] = None
    prob: Optional[float] = None
    byte_lo: Optional[int] = None       # file byte range (inclusive)
    byte_hi: Optional[int] = None
    param: float = 0.0


@dataclass
class FaultSpec:
    """Parsed fault specification: a seed plus an ordered clause list."""

    seed: int = 0
    clauses: List[_Clause] = field(default_factory=list)

    @staticmethod
    def parse(spec: Optional[str]) -> "FaultSpec":
        out = FaultSpec()
        if not spec:
            return out
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            if raw.startswith("seed="):
                try:
                    out.seed = int(raw[5:])
                except ValueError:
                    raise ValueError(f"bad fault_spec seed clause {raw!r}")
                continue
            if "@" not in raw:
                raise ValueError(
                    f"bad fault_spec clause {raw!r}: expected "
                    "'kind@sel[:param]' or 'seed=N'")
            kind, rest = raw.split("@", 1)
            if kind not in _KINDS:
                raise ValueError(
                    f"bad fault_spec kind {kind!r} in {raw!r}: "
                    f"one of {_KINDS}")
            sel, _, param = rest.partition(":")
            m = _SEL_RE.match(sel)
            if not m:
                raise ValueError(
                    f"bad fault_spec selector {sel!r} in {raw!r}: expected "
                    "[w|r](* | N | N-M | pFLOAT | bLO-HI)")
            cl = _Clause(kind=kind)
            if m.group("op"):
                cl.op = "write" if m.group("op") == "w" else "read"
            if m.group("prob") is not None:
                try:
                    cl.prob = float(m.group("prob"))
                except ValueError:
                    raise ValueError(f"bad probability in {raw!r}")
                if not 0.0 <= cl.prob <= 1.0:
                    raise ValueError(f"probability out of [0,1] in {raw!r}")
            elif m.group("blo") is not None:
                cl.byte_lo = int(m.group("blo"))
                cl.byte_hi = int(m.group("bhi"))
            elif m.group("lo") is not None:
                cl.lo = int(m.group("lo"))
                cl.hi = int(m.group("hi") or m.group("lo"))
            # else: "*" matches everything
            if cl.kind == "eio":
                cl.param = 1.0
                if param:
                    if not re.fullmatch(r"x\d+", param):
                        raise ValueError(
                            f"bad eio param {param!r} in {raw!r}: expected "
                            "xK (consecutive failing attempts)")
                    cl.param = float(param[1:])
            elif cl.kind == "torn":
                cl.param = float(param) if param else 0.5
                if not 0.0 < cl.param <= 1.0:
                    raise ValueError(
                        f"torn fraction out of (0,1] in {raw!r}")
                cl.op = "write"         # torn reads are meaningless
            elif cl.kind == "lat":
                cl.param = float(param) if param else 1e-3
                if cl.param < 0:
                    raise ValueError(f"negative latency in {raw!r}")
            elif param:
                raise ValueError(
                    f"kind {kind!r} takes no parameter (got {param!r})")
            out.clauses.append(cl)
        return out


def _hash01(seed: int, op: str, idx: int, salt: int) -> float:
    """Deterministic uniform [0,1) from (seed, op, index, clause)."""
    h = (seed * 1000003) ^ (0x9E3779B9 if op == "write" else 0x85EBCA77)
    h ^= (idx * 2654435761) ^ (salt * 40503)
    h = (h * 6364136223846793005 + 1442695040888963407) & (2 ** 64 - 1)
    return (h >> 11) / float(2 ** 53)


class FaultyFile:
    """Driver proxy injecting faults per :class:`FaultSpec`.

    Sits *below* the engine: every injected ``OSError`` flows through the
    engine's retry/propagation machinery, every torn write is only visible
    to the checksum layer, and ``kill`` dies with I/O genuinely in flight.
    ``injected`` counts faults by kind for assertions and reporting.
    """

    # Span tracing (attached post-construction by the executor): each
    # injected fault is an instant event on the owning shard's lane, so a
    # trace answers "which injection caused this retry/stall".
    tracer = NOOP

    def __init__(self, inner, spec: FaultSpec):
        self.inner = inner
        self.spec = spec
        self._lock = threading.Lock()
        self._n = {"read": 0, "write": 0}
        self.injected: Dict[str, int] = {k: 0 for k in _KINDS}
        # (clause idx, op, offset) -> remaining consecutive eio failures
        self._armed: Dict[Tuple[int, str, int], int] = {}

    # ------------------------------------------------------------- delegation
    @property
    def path(self):
        return self.inner.path

    @property
    def align(self):
        return self.inner.align

    @property
    def driver(self):
        return f"faulty:{self.inner.driver}"

    @property
    def fallback(self):
        return getattr(self.inner, "fallback", False)

    def flush(self):
        return self.inner.flush()

    def close(self):
        return self.inner.close()

    # -------------------------------------------------------------- injection
    def _apply(self, op: str, offset: int, nbytes: int) -> Optional[float]:
        """Evaluate clauses; raise/sleep/kill as matched.

        Returns a torn-write fraction, or None for a clean pass-through.
        """
        sleep_s = 0.0
        torn: Optional[float] = None
        with self._lock:
            idx = self._n[op]
            self._n[op] = idx + 1
            fire: List[_Clause] = []
            for ci, cl in enumerate(self.spec.clauses):
                key = (ci, op, offset)
                if cl.kind == "eio" and self._armed.get(key, 0) > 0:
                    self._armed[key] -= 1
                    if self._armed[key] == 0:
                        del self._armed[key]
                    fire.append(cl)
                    continue
                if cl.op is not None and cl.op != op:
                    continue
                if cl.lo is not None and not cl.lo <= idx <= cl.hi:
                    continue
                if cl.byte_lo is not None and not (
                        offset <= cl.byte_hi and offset + nbytes > cl.byte_lo):
                    continue
                if cl.prob is not None and _hash01(
                        self.spec.seed, op, idx, ci) >= cl.prob:
                    continue
                if cl.kind == "eio" and cl.param > 1 and key not in self._armed:
                    # Arm the remaining K-1 consecutive failures for the
                    # engine's retries of this same (op, offset) to consume.
                    self._armed[key] = int(cl.param) - 1
                fire.append(cl)
            for cl in fire:
                self.injected[cl.kind] += 1
                if cl.kind == "lat":
                    sleep_s += cl.param
                elif cl.kind == "torn":
                    torn = cl.param if torn is None else min(torn, cl.param)
        # Effects outside the lock so concurrent workers aren't serialised.
        if self.tracer.enabled:
            for cl in fire:
                self.tracer.instant(f"fault:{cl.kind}", tid="events",
                                    cat="fault", op=op, offset=offset,
                                    nbytes=nbytes)
        if sleep_s:
            time.sleep(sleep_s)
        for cl in fire:
            if cl.kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            if cl.kind == "enospc":
                raise OSError(
                    errno.ENOSPC,
                    f"injected ENOSPC: {op} of {nbytes:,} bytes at offset "
                    f"{offset:,} on {self.path!r} (fault_spec)")
            if cl.kind == "eio":
                raise OSError(
                    errno.EIO,
                    f"injected EIO: {op} of {nbytes:,} bytes at offset "
                    f"{offset:,} on {self.path!r} (fault_spec)")
        return torn

    # --------------------------------------------------------------- file API
    def pread_into(self, offset: int, out) -> int:
        nbytes = memoryview(out).nbytes
        self._apply("read", offset, nbytes)
        return self.inner.pread_into(offset, out)

    def pwrite(self, offset: int, data) -> int:
        buf = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        nbytes = buf.nbytes
        torn = self._apply("write", offset, nbytes)
        if torn is not None and nbytes > 1:
            # Silent short write: persist only a prefix but report success —
            # the power-cut model.  Detection is the checksum layer's job.
            keep = max(1, int(nbytes * torn))
            self.inner.pwrite(offset, buf[:keep])
            return nbytes
        return self.inner.pwrite(offset, data)
