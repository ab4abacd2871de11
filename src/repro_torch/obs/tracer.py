"""Structured span tracer: the time-resolved twin of ``TierStats``.

``TierStats``/``IOLedger`` answer *how much* (seconds stalled, bytes
moved); they cannot answer *when* — which superstep stalled, which shard's
queue backed up, why ``merge_stall_s`` was nonzero.  :class:`Tracer` records
that: begin/end spans, complete spans, instant events, and counter samples
into a bounded ring buffer, exported as Chrome/Perfetto ``trace_event``
JSON (:mod:`repro_torch.obs.export`) and summarized by ``python -m
repro_torch.obs report`` (:mod:`repro_torch.obs.report`).  The port's own
copy of the JAX package's tracer: the same events, lanes and format.

Design constraints (and how they are met):

* **Low overhead.**  One event is one tuple appended to a
  ``collections.deque(maxlen=capacity)`` — no dict building, no I/O, no
  locking on the hot path (CPython's deque append is atomic, which is all
  the single-producer-per-lane usage here needs).  When tracing is off the
  plumbing holds the :data:`NOOP` singleton, so instrumented code pays one
  attribute check (``tracer.enabled``) or one no-op method call.
* **Bounded memory.**  The ring drops the *oldest* events past
  ``capacity`` (``dropped`` counts them) — a week-long run cannot OOM on
  its own telemetry.
* **Monotonic clock.**  Timestamps are ``time.perf_counter()`` relative to
  a shared ``epoch``, immune to wall-clock steps.  Tracers that should
  share a timeline (the executor's per-shard tracers) are constructed with
  the same ``epoch`` so their events merge onto comparable timestamps.
* **Exact agreement with the stats.**  :meth:`Tracer.complete` takes the
  *caller's* ``t0``/``t1`` perf_counter readings — the executor passes the
  very same values it adds into ``TierStats``, so a report derived from
  spans can never disagree with the counters.

The port runs eagerly, so a span never sits inside a compiled program; but
CUDA kernels return before they finish.  A span over device work therefore
begins and ends on a drained stream (``Pems.device_span``), and only while
tracing is on.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

__all__ = ["Tracer", "NoopTracer", "NOOP"]

# Event tuples: (ph, name, tid, ts_s, dur_s, cat, args)
#   ph  — Chrome trace_event phase: "X" complete, "B"/"E" begin/end,
#         "i" instant, "C" counter
#   ts_s/dur_s — seconds since the tracer's epoch / span length
#   args — small dict of attributes (None when empty)


class _Span:
    """Context manager for one complete ("X") span.  ``duration_s`` is
    available after exit — benchmarks time *through* the span so their
    numbers and the trace can never disagree."""

    __slots__ = ("_tracer", "name", "tid", "cat", "args", "t0", "t1")

    def __init__(self, tracer: "Tracer", name: str, tid: str,
                 cat: Optional[str], args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.tid = tid
        self.cat = cat
        self.args = args
        self.t0 = 0.0
        self.t1 = 0.0

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t1 = time.perf_counter()
        self._tracer.complete(self.name, self.t0, self.t1, tid=self.tid,
                              cat=self.cat, **(self.args or {}))
        return False

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Bounded ring-buffer span/event recorder (one per process lane)."""

    enabled = True

    def __init__(self, capacity: int = 1 << 16,
                 epoch: Optional[float] = None, name: str = "main"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = name
        self.capacity = capacity
        self.epoch = time.perf_counter() if epoch is None else epoch
        self._events = collections.deque(maxlen=capacity)
        self.dropped = 0        # advisory: events evicted by the ring

    # ---------------------------------------------------------------- clock
    def now(self) -> float:
        """Raw ``time.perf_counter()`` — pair with :meth:`complete`."""
        return time.perf_counter()

    # --------------------------------------------------------------- events
    def _push(self, ev: tuple) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1   # advisory count; benign under races
        self._events.append(ev)

    def span(self, name: str, tid: str = "main", cat: Optional[str] = None,
             **args) -> _Span:
        """``with tracer.span("stage:merge", tid="stages"): ...`` — records
        one complete span from enter to exit."""
        return _Span(self, name, tid, cat, args or None)

    def complete(self, name: str, t0: float, t1: float, tid: str = "main",
                 cat: Optional[str] = None, **args) -> None:
        """Record an already-timed region: ``t0``/``t1`` are the caller's
        ``time.perf_counter()`` readings (the same values it billed into
        its stats counters)."""
        self._push(("X", name, tid, t0 - self.epoch, t1 - t0, cat,
                    args or None))

    def begin(self, name: str, tid: str = "main",
              cat: Optional[str] = None, **args) -> None:
        """Open a nested span; close it with :meth:`end` on the same lane.
        For spans confined to one scope prefer :meth:`span` — the
        ``trace-balance`` lint rule flags a ``begin`` without a matching
        ``end`` in the same scope."""
        self._push(("B", name, tid, time.perf_counter() - self.epoch,
                    None, cat, args or None))

    def end(self, name: str, tid: str = "main") -> None:
        self._push(("E", name, tid, time.perf_counter() - self.epoch,
                    None, None, None))

    def instant(self, name: str, tid: str = "events",
                cat: Optional[str] = None, **args) -> None:
        """Zero-duration marker (fault injections, sanitizer findings,
        drain timeouts)."""
        self._push(("i", name, tid, time.perf_counter() - self.epoch,
                    None, cat, args or None))

    def counter(self, name: str, value, tid: str = "counters") -> None:
        """One sample of a counter track (e.g. engine queue depth)."""
        self._push(("C", name, tid, time.perf_counter() - self.epoch,
                    None, None, {"value": value}))

    # ------------------------------------------------------------ inspection
    def events(self) -> list:
        """Snapshot of the ring's event tuples, oldest first."""
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0


class _NoopSpan:
    """Shared do-nothing span: zero allocation per disabled ``span()``."""

    __slots__ = ()
    t0 = 0.0
    t1 = 0.0
    duration_s = 0.0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


class NoopTracer:
    """Disabled tracer: every method is a no-op, ``enabled`` is False so
    hot paths can skip even argument construction.  Use the shared
    :data:`NOOP` singleton."""

    enabled = False
    name = "noop"
    epoch = 0.0
    capacity = 0
    dropped = 0

    def now(self) -> float:
        return time.perf_counter()

    def span(self, name: str, tid: str = "main", cat=None, **args):
        return _NOOP_SPAN

    def complete(self, name, t0, t1, tid="main", cat=None, **args) -> None:
        pass

    def begin(self, name, tid="main", cat=None, **args) -> None:
        pass

    def end(self, name, tid="main") -> None:
        pass

    def instant(self, name, tid="events", cat=None, **args) -> None:
        pass

    def counter(self, name, value, tid="counters") -> None:
        pass

    def events(self) -> list:
        return []

    def __len__(self) -> int:
        return 0

    def clear(self) -> None:
        pass


NOOP = NoopTracer()
