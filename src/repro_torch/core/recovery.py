"""Durable superstep cursor: crash recovery for the out-of-core path (the
port's copy of the JAX package's ``core/recovery.py``).

A long out-of-core run is a sequence of named stages (supersteps and
collectives) mutating one backing file.  To survive ``kill -9`` the runner
needs two tiny pieces of durable state:

* **the cursor** — which stage last *committed* (its writes flushed to the
  backing file) and which stage, if any, was *in progress* when the process
  died.  :class:`SuperstepCursor` stores this as an atomically replaced,
  fsynced JSON file: a crash mid-update leaves the previous cursor intact.
* **a pre-stage snapshot** of any field a stage both reads and writes
  (taken by the runner, :func:`repro_torch.pems_apps.psrs_run_recoverable`):
  the resume restores it before rerunning the stage from its true input.
  Stages whose read and write sets are disjoint rerun idempotently.

The protocol per stage ``i``::

    snapshot read∩write fields (if any)      # atomic npz
    cursor.mark_in_progress(i)               # durable
    run the stage
    store.flush()                            # backing + sidecar durable
    cursor.mark_completed(i)                 # durable

On resume, stages ``<= completed`` are skipped; if ``in_progress`` is set,
the backing's checksums are recomputed, the snapshot is restored and the
stage reruns, bit-identically, because every input byte is either from a
committed flush or from the snapshot.

The file names (``cursor.json``, ``cursor.p<p>.json``) and JSON keys are the
JAX package's, and the same marks write the same bytes, so a state dir
written by one package resumes in the other.  With a tracer attached, each
stage's in-progress window is an ``in_progress:<stage>`` span on the
``recovery`` lane, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..obs import NOOP

__all__ = ["atomic_replace_file", "atomic_write_json", "fsync_dir",
           "SuperstepCursor"]


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss."""
    try:
        # Directory handle for fsync only — no data bytes move through it,
        # so there is nothing for the IOLedger to see.
        fd = os.open(path, os.O_RDONLY)  # pems-lint: disable=block-api-only
    except OSError:
        return                     # e.g. platforms without dir-open support
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_replace_file(path: str, write_fn, binary: bool = False,
                        durable: bool = True) -> None:
    """Atomically replace ``path`` with whatever ``write_fn(f)`` writes.

    ``write_fn`` writes into ``path + ".tmp"``, which is flushed and
    fsynced, renamed over ``path``, and the directory fsynced so the rename
    itself survives power loss: readers see the old contents or the new,
    never a torn mix.  ``durable=False`` skips both fsyncs (advisory state,
    where the rename's atomicity is enough); ``binary=True`` opens the temp
    file in ``"wb"`` mode (the npz stage snapshots).
    """
    tmp = path + ".tmp"
    # Audited raw open: this *is* the durable-state write path (cursor
    # JSON, stage snapshots) — control state, not ledger-visible backing
    # data, which must keep flowing through the block API.
    with open(tmp, "wb" if binary else "w") as f:  # pems-lint: disable=block-api-only
        write_fn(f)
        if durable:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if durable:
        fsync_dir(os.path.dirname(path) or ".")


def atomic_write_json(path: str, obj, durable: bool = True) -> None:
    """Write ``obj`` as JSON to ``path`` via :func:`atomic_replace_file`."""
    atomic_replace_file(path, lambda f: json.dump(obj, f), durable=durable)


class SuperstepCursor:
    """Tiny durable record of stage progress for one recoverable run.

    State: ``{"completed": i, "in_progress": j|None, "stage": name,
    "round": r}`` — ``completed`` is the index of the last stage whose
    writes are flushed, ``in_progress`` the stage that was running (None
    between stages), ``round`` an advisory executor-round note within the
    in-progress stage.

    Under the sharded backing (``P > 1``) a recoverable run keeps one cursor
    per process (:meth:`path_for`): process p's cursor commits when its
    shard's writes are flushed, so a single-disk failure leaves the other
    processes' cursors at the completed stage and only the failed process
    reruns (``procs=[p]``).
    """

    # Span tracing (attached post-construction by the runner, like the
    # engine's): mark_in_progress opens a span on the recovery lane that
    # mark_completed closes, so the trace shows each stage's durable
    # in-progress window — exactly what a resume decision is made from.
    tracer = NOOP
    trace_tid = "recovery"

    def __init__(self, path: str):
        self.path = path
        self._cur = self._load()

    @staticmethod
    def path_for(state_dir: str, proc: int = 0, nprocs: int = 1) -> str:
        """The cursor file of process ``proc`` of ``nprocs`` under
        ``state_dir``: the bare name at ``nprocs == 1``."""
        if nprocs == 1:
            return os.path.join(state_dir, "cursor.json")
        return os.path.join(state_dir, f"cursor.p{proc}.json")

    def _load(self) -> Optional[dict]:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def state(self) -> Optional[dict]:
        """The persisted state, or None for a fresh run."""
        return None if self._cur is None else dict(self._cur)

    @property
    def completed(self) -> int:
        return -1 if self._cur is None else int(self._cur.get("completed", -1))

    @property
    def in_progress(self) -> Optional[int]:
        return None if self._cur is None else self._cur.get("in_progress")

    def mark_in_progress(self, stage: int, name: Optional[str] = None) -> None:
        self._cur = {"completed": self.completed, "in_progress": stage,
                     "stage": name, "round": None}
        atomic_write_json(self.path, self._cur, durable=True)
        # Audited cross-call pair: the matching end() is in mark_completed —
        # the in-progress window *is* the span, and a crash inside it is
        # closed at export by the balance sanitizer.
        # pems-lint: disable=trace-balance
        self.tracer.begin(f"in_progress:{name or stage}", tid=self.trace_tid,
                          cat="recovery", stage=stage)

    def mark_completed(self, stage: int, name: Optional[str] = None) -> None:
        self._cur = {"completed": stage, "in_progress": None,
                     "stage": name, "round": None}
        atomic_write_json(self.path, self._cur, durable=True)
        self.tracer.end(f"in_progress:{name or stage}", tid=self.trace_tid)

    def note_round(self, r: int) -> None:
        """Advisory executor-round progress (atomic but not fsynced — a
        resume restarts the whole in-progress stage regardless)."""
        if self._cur is None:
            self._cur = {"completed": -1, "in_progress": None,
                         "stage": None, "round": None}
        self._cur["round"] = r
        atomic_write_json(self.path, self._cur, durable=False)

    def clear(self) -> None:
        self._cur = None
        try:
            os.unlink(self.path)
        except OSError:
            pass
