"""Summarize an exported trace: where did the time actually go?

``python -m repro_torch.obs report <trace.json>`` prints, from the spans
alone:

* a per-phase (plan-stage) breakdown of compute vs I/O vs stall time,
* the measured compute/I-O overlap fraction, cross-checked against the
  ``TierStats.overlap_fraction`` embedded in the trace's metrics snapshot
  (the two derive from the same ``perf_counter`` readings, so they must
  agree — a mismatch means instrumentation drift),
* the top-N slowest engine requests (driver, bytes, retries).

Span taxonomy consumed here (the JAX package's, which the port records):

* ``cat="stage"``      — one span per plan stage (main tracer, pid 0)
* ``cat="compute"``    — round compute (per-shard tracers)
* ``cat="io"``         — executor-level swap_in/swap_out wall time
* ``cat="stall"``      — main-thread time blocked waiting on a swap-in
* ``cat="request"``    — one span per engine request (worker lanes)

Everything is stdlib; the module is import-independent of torch/numpy so
the CLI runs anywhere the trace file can be copied.
"""

from __future__ import annotations

import json
from typing import List, Optional

__all__ = ["summarize", "render", "report"]


def _xspans(trace: dict) -> List[dict]:
    return [e for e in trace.get("traceEvents", ())
            if e.get("ph") == "X"]


def summarize(trace: dict, top: int = 10) -> dict:
    """Reduce a loaded trace document to the report's numbers.

    Returns a dict with ``stages`` (per-stage rows), ``totals`` (summed
    compute/io/stall seconds and the span-derived ``overlap_fraction``),
    ``metrics_overlap`` (the ``TierStats`` value embedded at export, or
    None), and ``slowest`` (top-N request spans by duration).
    """
    spans = _xspans(trace)
    stages = sorted((e for e in spans if e.get("cat") == "stage"),
                    key=lambda e: e["ts"])
    buckets = {"compute": "compute_s", "io": "io_s", "stall": "stall_s"}
    rows = [{
        "name": s["name"], "ts": s["ts"], "dur": s.get("dur", 0.0),
        "wall_s": s.get("dur", 0.0) / 1e6,
        "compute_s": 0.0, "io_s": 0.0, "stall_s": 0.0,
    } for s in stages]
    totals = {"compute_s": 0.0, "io_s": 0.0, "stall_s": 0.0,
              "swap_in_s": 0.0, "unattributed_s": 0.0}

    for e in spans:
        key = buckets.get(e.get("cat"))
        if key is None:
            continue
        dur_s = e.get("dur", 0.0) / 1e6
        totals[key] += dur_s
        if e.get("name") == "swap_in":
            totals["swap_in_s"] += dur_s
        mid = e["ts"] + e.get("dur", 0.0) / 2.0
        for row in rows:
            if row["ts"] <= mid < row["ts"] + row["dur"]:
                row[key] += dur_s
                break
        else:
            totals["unattributed_s"] += dur_s

    # Same formula as TierStats.overlap_fraction, computed from the spans.
    if totals["swap_in_s"] > 0.0:
        overlap = min(1.0, max(
            0.0, 1.0 - totals["stall_s"] / totals["swap_in_s"]))
    else:
        overlap = 0.0
    totals["overlap_fraction"] = overlap

    reqs = sorted((e for e in spans if e.get("cat") == "request"),
                  key=lambda e: -e.get("dur", 0.0))[:top]
    slowest = [{
        "op": e["name"], "dur_s": e.get("dur", 0.0) / 1e6,
        **{k: v for k, v in e.get("args", {}).items()},
    } for e in reqs]

    metrics = trace.get("metrics", {})
    return {
        "stages": rows,
        "totals": totals,
        "overlap_fraction": overlap,
        "metrics_overlap": metrics.get("tier.overlap_fraction"),
        "metrics": metrics,
        "slowest": slowest,
        "events": len(trace.get("traceEvents", ())),
    }


def render(summary: dict) -> str:
    """The report as human-readable text."""
    out = [f"trace: {summary['events']} events"]
    if summary["stages"]:
        out.append("")
        out.append(f"{'phase':<20} {'wall_s':>9} {'compute_s':>10} "
                   f"{'io_s':>9} {'stall_s':>9}")
        for r in summary["stages"]:
            out.append(f"{r['name']:<20} {r['wall_s']:>9.4f} "
                       f"{r['compute_s']:>10.4f} {r['io_s']:>9.4f} "
                       f"{r['stall_s']:>9.4f}")
    t = summary["totals"]
    out.append("")
    out.append(f"{'total':<20} {'':>9} {t['compute_s']:>10.4f} "
               f"{t['io_s']:>9.4f} {t['stall_s']:>9.4f}")
    if t["unattributed_s"] > 0.0:
        out.append(f"  ({t['unattributed_s']:.4f}s outside any stage span)")
    out.append("")
    out.append(f"overlap fraction (spans):     "
               f"{summary['overlap_fraction']:.3f}  "
               f"(1 - stall {t['stall_s']:.4f}s / "
               f"swap_in {t['swap_in_s']:.4f}s)")
    mo = summary["metrics_overlap"]
    if mo is not None:
        delta = abs(summary["overlap_fraction"] - mo)
        out.append(f"overlap fraction (TierStats): {mo:.3f}  "
                   f"(delta {delta:.3f})")
    if summary["slowest"]:
        out.append("")
        out.append("slowest requests:")
        for r in summary["slowest"]:
            extra = " ".join(f"{k}={v}" for k, v in r.items()
                             if k not in ("op", "dur_s"))
            out.append(f"  {r['op']:<6} {r['dur_s'] * 1e3:>9.3f} ms  "
                       f"{extra}")
    return "\n".join(out)


def report(path: str, top: int = 10) -> str:
    """Load ``path`` and return the rendered report."""
    with open(path) as f:
        trace = json.load(f)
    return render(summarize(trace, top=top))
