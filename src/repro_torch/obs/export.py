"""Chrome/Perfetto ``trace_event`` JSON export + per-process trace merge
(the JAX package's exporter, byte for byte on the same events).

Produces the JSON *object* format (``{"traceEvents": [...], ...}``), which
both ``chrome://tracing`` and https://ui.perfetto.dev load directly and
which permits extra top-level keys — the flat metrics snapshot rides along
under ``"metrics"`` so one file carries spans *and* the ``TierStats``/
``IOLedger`` counters they must agree with.

Lane layout: each tracer becomes one Perfetto *process* (``pid``) — the
executor's main tracer is pid 0, shard ``p``'s engine/round tracer pid
``p+1`` — and each distinct ``tid`` string inside a tracer becomes one
named *thread* lane.  Timestamps are exported in microseconds as the
format requires.

Balance sanitation: ``B``/``E`` events are matched per lane on export —
an orphan ``E`` (its ``B`` fell off the ring) is dropped, and a ``B``
still open at the end of the buffer is closed at the last seen timestamp —
so every exported trace nests cleanly no matter where the ring wrapped or
where a crash cut the run.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

__all__ = ["trace_events", "write_trace", "merge_trace_files", "load_trace"]

_US = 1e6


def _balanced(events: list) -> list:
    """Drop orphan E events and close dangling B events per (tid, lane)."""
    out = []
    stacks: Dict[str, List[int]] = {}       # tid -> indices of open B's
    last_ts: Dict[str, float] = {}
    for ev in events:
        ph, name, tid, ts = ev[0], ev[1], ev[2], ev[3]
        last_ts[tid] = max(last_ts.get(tid, ts), ts)
        if ph == "B":
            stacks.setdefault(tid, []).append(len(out))
        elif ph == "E":
            if not stacks.get(tid):
                continue                    # orphan end: B fell off the ring
            stacks[tid].pop()
        out.append(ev)
    for tid, open_bs in stacks.items():
        for i in reversed(open_bs):         # close innermost first
            b = out[i]
            out.append(("E", b[1], tid, last_ts[tid], None, None, None))
    return out


def trace_events(tracer, pid: int,
                 process_name: Optional[str] = None) -> List[dict]:
    """Convert one tracer's ring into Chrome trace_event dicts under
    ``pid``, with process/thread metadata and balanced B/E nesting."""
    name = process_name or getattr(tracer, "name", f"pid{pid}")
    out: List[dict] = [{
        "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
        "args": {"name": name},
    }]
    tids: Dict[str, int] = {}
    for ev in _balanced(tracer.events()):
        ph, ev_name, tid_s, ts, dur, cat, args = ev
        tid = tids.get(tid_s)
        if tid is None:
            tid = tids[tid_s] = len(tids) + 1
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name", "args": {"name": tid_s}})
        rec = {"ph": ph, "pid": pid, "tid": tid, "name": ev_name,
               "ts": ts * _US}
        if ph == "X":
            rec["dur"] = dur * _US
        if ph == "i":
            rec["s"] = "t"                  # thread-scoped instant
        if cat is not None:
            rec["cat"] = cat
        if args is not None:
            rec["args"] = args
        out.append(rec)
    return out


def write_trace(path: str, events: Iterable[dict],
                metrics: Optional[dict] = None) -> str:
    """Write one Perfetto-loadable JSON object trace file."""
    doc = {"traceEvents": list(events), "displayTimeUnit": "ms"}
    if metrics is not None:
        doc["metrics"] = metrics
    # One json.dumps call: the C encoder, where json.dump's streaming goes
    # through the pure-Python one (10x slower) for the same bytes.
    text = json.dumps(doc)
    with open(path, "w") as f:
        f.write(text)
    return path


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def merge_trace_files(path: str, part_paths: Iterable[str],
                      extra_events: Iterable[dict] = (),
                      metrics: Optional[dict] = None) -> str:
    """Merge per-process trace files (plus ``extra_events``, e.g. the main
    tracer's already-converted events) into one trace at ``path``.

    Events keep their pids (each part file was exported under its own), so
    the merged view shows one Perfetto process lane per source process;
    part-file ``metrics`` dicts are folded under the part's process name.
    """
    events: List[dict] = list(extra_events)
    merged_metrics: dict = dict(metrics or {})
    for pp in part_paths:
        doc = load_trace(pp)
        events.extend(doc.get("traceEvents", ()))
        for k, v in doc.get("metrics", {}).items():
            merged_metrics.setdefault(k, v)
    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
    return write_trace(path, events,
                       metrics=merged_metrics if merged_metrics else None)
