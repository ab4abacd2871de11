"""io_uring-style asynchronous file I/O engine (the port's own copy of the
JAX package's ``io/engine.py``; standard library only).

The PEMS2 thesis' headline feature is asynchronous disk I/O that overlaps
swap traffic with compute (§5.1).  This engine makes that overlap real for
file-backed tiers: callers *submit* positional reads/writes into a bounded
queue and *poll*/*drain* completions, while a small worker pool executes the
transfers through one of the positional drivers — so round ``r+1``'s
swap-in and round ``r-1``'s writeback are both in flight during round ``r``'s
compute, with measured queue-depth/stall/overlap counters instead of hope.

Semantics:

* ``submit_read(offset, out)`` / ``submit_write(offset, data)`` return an
  :class:`IORequest` immediately.  At most ``queue_depth`` requests are in
  flight; a submit into a full queue blocks (the measured
  ``queue_stall_s``) — backpressure, exactly like a full io_uring SQ.
* ``poll()`` returns (and forgets) completed requests without blocking.
* ``wait(reqs)`` blocks until the given requests complete; ``drain()``
  until *all* in-flight requests complete.  Both re-raise the first worker
  error.  After ``drain()``, ``in_flight == 0`` — guaranteed quiescence.
* For drivers with an alignment unit (``odirect``), requests whose aligned
  block ranges overlap are serialised when either is a write — the
  read-modify-write of boundary blocks would otherwise race.
* Transient errors (``EIO``/``EINTR``/``EAGAIN``/``ETIMEDOUT``) are retried
  in the worker up to ``retries`` times with exponential backoff and
  deterministic jitter before being treated as permanent; permanent errors
  (everything else, and exhausted retries) propagate per-request through
  ``wait``/``drain`` exactly as before.  ``retries``/``backoff_s``/
  ``permanent_errors`` counters record the policy's work.
* ``drain(timeout=)`` raises a :class:`TimeoutError` naming the still
  in-flight requests instead of deadlocking on a hung worker (a stalled
  disk, an injected latency fault).

The engine mirrors its measurements into the caller's
:class:`~repro_torch.core.iostats.TierStats`-shaped object (``max_queue_depth``,
``queue_stall_s``, ``fsyncs``, ``rw_overlap_events``) and
:class:`~repro_torch.core.iostats.IOLedger`-shaped object
(``syscall_read_bytes``/``syscall_write_bytes``); both are duck-typed so
this module stays import-independent of :mod:`repro_torch.core`.  The
drivers it runs (``pread_into``/``pwrite``/``flush``/``close``) live in
:mod:`repro_torch.core.backing`.
"""

from __future__ import annotations

import errno
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from ..obs import NOOP
from .aligned import align_down, align_up

_MAX_WORKERS = 16

# Errnos worth retrying: the device/kernel may succeed on a second attempt.
# Everything else (EINVAL, ENOSPC, EBADMSG/IntegrityError, ...) is permanent.
TRANSIENT_ERRNOS = frozenset(
    {errno.EIO, errno.EINTR, errno.EAGAIN, errno.ETIMEDOUT})


class IORequest:
    """One submitted transfer.  ``wait()`` blocks until completion and
    re-raises any worker error; ``done`` is non-blocking."""

    __slots__ = ("op", "offset", "nbytes", "data", "out", "syscall_bytes",
                 "error", "auto_reap", "attempts", "t_submit", "_a0", "_a1",
                 "_event")

    def __init__(self, op: str, offset: int, nbytes: int, data, out,
                 align: int, auto_reap: bool = False):
        self.op = op                    # "read" | "write"
        self.offset = offset
        self.nbytes = nbytes
        self.data = data                # write source (held until complete)
        self.out = out                  # read destination buffer
        self.t_submit = 0.0             # perf_counter at submit: request age
                                        # in drain diagnostics, queue time in
                                        # trace spans
        self.syscall_bytes = 0
        self.auto_reap = auto_reap      # fire-and-forget: skip _completed
        self.attempts = 0               # driver calls issued (1 = no retry)
        self.error: Optional[BaseException] = None
        self._a0 = align_down(offset, align) if align > 1 else offset
        self._a1 = (align_up(offset + nbytes, align) if align > 1
                    else offset + nbytes)
        self._event = threading.Event()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self) -> "IORequest":
        self._event.wait()
        if self.error is not None:
            raise self.error
        return self


class IOEngine:
    """Bounded submission/completion queues over one driver file.

    Parameters:

    * ``file`` — an open driver file object (``pread_into``/
      ``pwrite``/``flush``/``close`` plus an ``align`` unit in bytes).
    * ``queue_depth`` — maximum in-flight requests; a submit into a full
      queue blocks (measured as ``queue_stall_s``, seconds).
    * ``stats`` / ``ledger`` — duck-typed mirrors for the measured counters
      (see module docstring); byte counters are in bytes, ``*_s`` in seconds.
    * ``workers`` — worker-thread count (default ``min(queue_depth, 16)``).
    * ``retries`` — transient-error re-attempts per request (0 = fail fast).
    * ``backoff_s`` / ``backoff_max_s`` — base and cap of the exponential
      retry delay, in seconds.  ``jitter`` scales a deterministic per-attempt
      factor in ``[1, 1+jitter)``.
    * ``name`` — optional label (e.g. ``"shard1"`` under a sharded backing)
      included in drain-timeout diagnostics so a hung shard is identifiable.
    """

    def __init__(self, file, queue_depth: int = 8, stats=None, ledger=None,
                 workers: Optional[int] = None, retries: int = 2,
                 backoff_s: float = 0.002, backoff_max_s: float = 0.25,
                 jitter: float = 0.25, name: Optional[str] = None):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        self.file = file
        self.queue_depth = queue_depth
        self.stats = stats
        self.ledger = ledger
        self.name = name
        # Retry policy for transient errors (see TRANSIENT_ERRNOS): up to
        # ``retries`` re-attempts, delay min(backoff_max_s, backoff_s·2^i)
        # scaled by a deterministic per-(request, attempt) jitter factor so
        # schedules are reproducible yet colliding retries still spread out.
        self.max_retries = retries
        self._backoff_base_s = backoff_s
        self._backoff_cap_s = backoff_max_s
        self._jitter = jitter
        self._slots = threading.Semaphore(queue_depth)
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()   # guards _bump only; may be
                                              # taken while holding _lock
        self._quiet = threading.Condition(self._lock)
        self._inflight: List[IORequest] = []
        self._completed: List[IORequest] = []
        self._reads = 0
        self._writes = 0
        self._closed = False
        # Local mirrors of the duck-typed stats (always available, e.g. for
        # a standalone engine in benchmarks/tests).
        self.max_queue_depth = 0
        self.queue_stall_s = 0.0
        self.fsyncs = 0
        self.rw_overlap_events = 0
        self.syscall_read_bytes = 0
        self.syscall_write_bytes = 0
        self.retries = 0                # transient re-attempts issued
        self.backoff_s = 0.0            # scheduled backoff (deterministic)
        self.permanent_errors = 0       # requests that finally errored
        # Span tracing: attached post-construction by the executor (like
        # the duck-typed stats/ledger mirrors).  NOOP by default, so the
        # per-request instrumentation costs one attribute check.
        self.tracer = NOOP
        # Test hook: workers block here before touching the file, so tests
        # can hold requests in flight deterministically.  Set by default.
        self._gate = threading.Event()
        self._gate.set()
        self._pool = ThreadPoolExecutor(
            max_workers=workers or min(queue_depth, _MAX_WORKERS),
            thread_name_prefix="repro-io",
        )

    # ------------------------------------------------------------- submission
    def submit_read(self, offset: int, out,
                    auto_reap: bool = False) -> IORequest:
        """Read ``len(out)`` bytes at ``offset`` into the writable buffer
        ``out`` (filled by completion time)."""
        req = IORequest("read", offset, memoryview(out).cast("B").nbytes,
                        None, out, self.file.align, auto_reap)
        return self._submit(req)

    def submit_write(self, offset: int, data,
                     auto_reap: bool = False) -> IORequest:
        """Write the buffer ``data`` at ``offset``.  The engine holds a
        reference until completion — callers may drop theirs immediately.
        ``auto_reap=True`` marks a fire-and-forget request: a successful
        completion is dropped instead of queued for ``poll`` (errors are
        still kept for ``drain``), so an unbounded stream of async
        writebacks does not grow the completion list."""
        req = IORequest("write", offset, memoryview(data).cast("B").nbytes,
                        data, None, self.file.align, auto_reap)
        return self._submit(req)

    def _submit(self, req: IORequest) -> IORequest:
        if self._closed:
            raise RuntimeError("submit on a closed IOEngine")
        req.t_submit = time.perf_counter()
        if not self._slots.acquire(blocking=False):
            t0 = time.perf_counter()
            self._slots.acquire()
            self._bump("queue_stall_s", time.perf_counter() - t0)
        with self._lock:
            if ((req.op == "read" and self._writes > 0)
                    or (req.op == "write" and self._reads > 0)):
                self._bump("rw_overlap_events", 1)
            if self.file.align > 1:
                # Serialise aligned-range conflicts: an O_DIRECT boundary
                # block is read-modify-written, so two requests touching the
                # same block (either being a write) must not interleave.
                while self._conflicts(req):
                    self._quiet.wait()
            self._inflight.append(req)
            # Sanitizer hook (duck-typed, see repro_torch.io.sanitize):
            # fires once the request joins the in-flight set, after any
            # aligned-conflict serialisation above — so ranges the engine
            # serialises never co-exist in the sanitizer's view either.
            note = getattr(self.file, "note_submit", None)
            if note is not None:
                note(req)
            if req.op == "read":
                self._reads += 1
            else:
                self._writes += 1
            depth = len(self._inflight)
            self.max_queue_depth = max(self.max_queue_depth, depth)
            if self.stats is not None:
                self.stats.max_queue_depth = max(
                    self.stats.max_queue_depth, depth)
        if self.tracer.enabled:
            self.tracer.counter("queue_depth", depth, tid="queue")
        self._pool.submit(self._execute, req)
        return req

    def _conflicts(self, req: IORequest) -> bool:
        for r in self._inflight:
            if (r._a0 < req._a1 and req._a0 < r._a1
                    and ("write" in (r.op, req.op))):
                return True
        return False

    # -------------------------------------------------------------- execution
    def _backoff_delay(self, req: IORequest, attempt: int) -> float:
        d = min(self._backoff_cap_s, self._backoff_base_s * (2 ** attempt))
        if self._jitter:
            # Deterministic jitter in [1, 1+jitter): a hash of the request's
            # identity and the attempt number, not a PRNG — retry schedules
            # are exactly reproducible for tests and postmortems.
            h = (req.offset * 1000003 + attempt * 8191 + req.nbytes)
            h = (h * 2654435761) & 0xFFFFFFFF
            d *= 1.0 + self._jitter * (h / 2.0 ** 32)
        return d

    def _execute(self, req: IORequest) -> None:
        self._gate.wait()
        t_exec0 = time.perf_counter()
        attempt = 0
        while True:
            try:
                if req.op == "read":
                    n = self.file.pread_into(req.offset, req.out)
                else:
                    n = self.file.pwrite(req.offset, req.data)
                req.syscall_bytes = n
                req.attempts = attempt + 1
                break
            except BaseException as e:   # propagate through wait()/drain()
                if (isinstance(e, OSError)
                        and e.errno in TRANSIENT_ERRNOS
                        and attempt < self.max_retries):
                    delay = self._backoff_delay(req, attempt)
                    self._bump("retries", 1)
                    self._bump("backoff_s", delay)
                    attempt += 1
                    if delay > 0:
                        time.sleep(delay)
                    continue
                req.error = e
                req.attempts = attempt + 1
                self._bump("permanent_errors", 1)
                break
        # Sanitizer hook: the write buffer is still held here, so its
        # submit-time CRC can be checked against what the worker saw.
        note = getattr(self.file, "note_complete", None)
        if note is not None:
            note(req)
        with self._lock:
            self._inflight.remove(req)
            if req.op == "read":
                self._reads -= 1
                if req.error is None:
                    self.syscall_read_bytes += req.syscall_bytes
                    if self.ledger is not None:
                        self.ledger.syscall_read_bytes += req.syscall_bytes
            else:
                self._writes -= 1
                if req.error is None:
                    self.syscall_write_bytes += req.syscall_bytes
                    if self.ledger is not None:
                        self.ledger.syscall_write_bytes += req.syscall_bytes
            req.data = None          # free the held write buffer …
            req.out = None           # … and the read destination reference
            if not req.auto_reap or req.error is not None:
                self._completed.append(req)
            depth = len(self._inflight)
            self._quiet.notify_all()
        if self.tracer.enabled:
            # One complete span per request on this worker thread's lane:
            # the driver execution (incl. retries/backoff), with queue time
            # as an attribute — submit→execute→complete in one event.
            self.tracer.complete(
                req.op, t_exec0, time.perf_counter(),
                tid=threading.current_thread().name, cat="request",
                offset=req.offset, bytes=req.nbytes,
                driver=getattr(self.file, "driver", "?"),
                retries=req.attempts - 1,
                queued_us=round((t_exec0 - req.t_submit) * 1e6),
                error=type(req.error).__name__ if req.error else None)
            self.tracer.counter("queue_depth", depth, tid="queue")
        req._event.set()
        self._slots.release()

    # ------------------------------------------------------------- completion
    def poll(self) -> List[IORequest]:
        """Completed-so-far requests (each reaped exactly once, like CQEs).
        A polled request's error is the caller's to inspect — ``drain()``
        only re-raises errors of requests nobody has reaped yet."""
        with self._lock:
            done, self._completed = self._completed, []
        return done

    def wait(self, reqs) -> None:
        """Block until every request in ``reqs`` completes; raise the first
        error.  Reaps the waited requests (their errors are this caller's,
        and the completion list must not grow with every wait-style batch),
        so a later ``poll``/``drain`` no longer sees them."""
        reqs = list(reqs)
        err = None
        for r in reqs:
            r._event.wait()
            if err is None and r.error is not None:
                err = r.error
        with self._lock:
            waited = set(reqs)
            self._completed = [c for c in self._completed
                               if c not in waited]
        if err is not None:
            raise err

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until no request is in flight.  On return,
        ``in_flight == 0`` and every error raised.

        With ``timeout`` (seconds), a hung worker raises a diagnostic
        :class:`TimeoutError` naming the stuck requests instead of
        deadlocking the caller; the requests stay in flight (a later
        ``drain()`` can still collect them if the worker recovers).
        """
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._quiet:
            while self._inflight:
                if deadline is None:
                    self._quiet.wait()
                    continue
                left = deadline - time.monotonic()
                if left <= 0:
                    # Each stuck request's age (since submit) and byte
                    # range: enough to tell a wedged worker from a slow
                    # one, and to map the range back to context rows.
                    now = time.perf_counter()
                    pend = [
                        (r.op, f"[{r.offset},{r.offset + r.nbytes})",
                         f"age={now - r.t_submit:.3f}s")
                        for r in self._inflight
                    ]
                    who = f"engine {self.name!r} " if self.name else ""
                    self.tracer.instant(
                        "drain_timeout", tid="events", cat="engine",
                        timeout_s=timeout, in_flight=len(pend),
                        stuck=[list(p) for p in pend[:4]])
                    raise TimeoutError(
                        f"IOEngine.drain timed out after {timeout}s with "
                        f"{len(pend)} request(s) still in flight on "
                        f"{who}{getattr(self.file, 'path', '?')!r} (driver="
                        f"{getattr(self.file, 'driver', '?')}): first "
                        f"{pend[:4]} as (op, [byte range), age since "
                        "submit) — a worker is stuck; check for a stalled "
                        "device, an injected latency fault, or a held "
                        "test gate")
                self._quiet.wait(left)
            done, self._completed = self._completed, []
        for r in done:
            if r.error is not None:
                raise r.error

    @property
    def in_flight(self) -> int:
        with self._lock:
            return len(self._inflight)

    # ------------------------------------------------------------- durability
    def fsync(self) -> None:
        """Drain, then push everything to stable storage."""
        self.drain()
        self.file.flush()
        self._bump("fsyncs", 1)

    def close(self) -> None:
        if self._closed:
            return
        self.drain()
        self._closed = True
        self._pool.shutdown(wait=True)
        self.file.close()

    # ---------------------------------------------------------------- helpers
    def _bump(self, name: str, val) -> None:
        # Concurrent submitters (main writeback + prefetch reads) can stall
        # simultaneously; the read-modify-write must not lose increments.
        with self._stats_lock:
            setattr(self, name, getattr(self, name) + val)
            if self.stats is not None:
                setattr(self.stats, name, getattr(self.stats, name) + val)
