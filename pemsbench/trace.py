"""``torch.profiler`` over a few jobs, reduced to what the readers need.

A profile is exported as a Chrome trace to a fixed file under ``TMPDIR``,
read back and deleted.  Device operations are the trace's kernels, memory
copies and memory sets, by card.  A job's place on the profiler's clock is
the benchmark's own ``record_function`` annotation around the call; the
program's stage spans (``time.perf_counter`` readings) are moved onto that
clock by the offset between the annotation's start and the host clock read
just before it.  A device operation belongs to the stage during which the
host launched it (the runtime call that shares its correlation id), which
on a drained stage is also where it ran.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time
from contextlib import contextmanager

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
JOB = "pemsbench.job"


class Profile:
    """The parsed trace: ``ops`` as ``(card, start_us, end_us, name,
    launch_us)`` and ``jobs`` as ``(start_us, end_us, perf_counter_start)``
    in the order they ran."""

    def __init__(self, doc: dict, anchors: list):
        ops, launches, jobs = [], {}, []
        for e in doc.get("traceEvents", []):
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args") or {}
            ts, dur = float(e["ts"]), float(e.get("dur", 0))
            if cat in DEVICE_CATS:
                ops.append([int(args.get("device", e.get("pid", 0))), ts,
                            ts + dur, e.get("name", ""),
                            args.get("correlation")])
            elif cat in ("cuda_runtime", "cuda_driver"):
                if "correlation" in args:
                    launches[args["correlation"]] = ts
            elif cat == "user_annotation" and e.get("name") == JOB:
                jobs.append((ts, ts + dur))
        for op in ops:
            op[4] = launches.get(op[4], op[1])
        self.ops = [tuple(op) for op in ops]
        jobs.sort()
        if len(jobs) != len(anchors):
            raise RuntimeError(
                f"profile holds {len(jobs)} job annotations for "
                f"{len(anchors)} jobs")
        self.jobs = [(a, b, t) for (a, b), t in zip(jobs, anchors)]

    def window(self) -> tuple:
        return self.jobs[0][0], self.jobs[-1][1]

    def busy_us(self, cards) -> list:
        """Each card's union of device-operation time inside the window."""
        lo, hi = self.window()
        return [_length(_union(
            [(max(s, lo), min(e, hi)) for c, s, e, _, _ in self.ops
             if c == card and e > lo and s < hi])) for card in cards]

    def top_ops(self, count: int = 10) -> list:
        """``[name, seconds]`` of the device operations that took most time
        inside the window, summed over cards."""
        lo, hi = self.window()
        tot = collections.Counter()
        for _, s, e, name, _ in self.ops:
            if e > lo and s < hi:
                tot[name[:160]] += (min(e, hi) - max(s, lo)) * 1e-6
        return [[name, sec] for name, sec in tot.most_common(count)]

    def stage_intervals(self, job: int, spans: list, epoch: float) -> list:
        """``(name, start_us, end_us)`` of job ``job``'s stage spans on the
        profiler's clock; ``spans`` as ``(name, t0, dur)`` relative to the
        tracer's ``epoch`` (``time.perf_counter`` seconds)."""
        start_us, _, t_host = self.jobs[job]
        off = start_us - t_host * 1e6
        return [(name, (epoch + t0) * 1e6 + off, (epoch + t0 + dur) * 1e6
                 + off) for name, t0, dur in spans]

    def stage_device_s(self, stages: list, cards) -> dict:
        """Seconds of device work each stage launched: the union of its
        operations' intervals on each card, summed over cards; ``stages``
        as ``(name, start_us, end_us)`` on the profiler's clock."""
        by = collections.defaultdict(list)
        for c, s, e, _, launch in self.ops:
            if c not in cards:
                continue
            for name, a, b in stages:
                if a <= launch < b:
                    by[(name, c)].append((s, e))
                    break
        out = collections.Counter()
        for (name, _), iv in by.items():
            out[name] += _length(_union(iv)) * 1e-6
        return dict(out)

    def idle_by_stage(self, stages_by_job: list, cards) -> dict:
        """Idle seconds inside the window by what the host was doing, the
        mean over ``cards``: in a stage (``stage:<name>``), between two
        (``<a> -> <b>``), before a job's first stage or after its last
        (plan build and load; extract and gather), or between jobs;
        ``stages_by_job`` holds each job's ``(name, start_us, end_us)``."""
        lo, hi = self.window()
        out = collections.Counter()
        for card in cards:
            busy = _union([(max(s, lo), min(e, hi))
                           for c, s, e, _, _ in self.ops
                           if c == card and e > lo and s < hi])
            edges = [lo] + [x for iv in busy for x in iv] + [hi]
            for a, b in zip(edges[0::2], edges[1::2]):
                if b > a:
                    where = self._where((a + b) / 2, stages_by_job)
                    out[where] += (b - a) * 1e-6
        return {k: v / len(cards) for k, v in out.items()}

    def _where(self, t: float, stages_by_job: list) -> str:
        for (a, b, _), stages in zip(self.jobs, stages_by_job):
            if not a <= t < b:
                continue
            prev = None
            for name, s, e in sorted(stages, key=lambda x: x[1]):
                if s <= t < e:
                    return f"stage:{name}"
                if t < s:
                    return (f"{prev} -> {name}" if prev
                            else "before the stages")
                prev = name
            return "after the stages"
        return "between jobs"


def _union(iv: list) -> list:
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(iv: list) -> float:
    return sum(e - s for s, e in iv)


@contextmanager
def job_annotation(anchors: list):
    """Around one job's call: its ``record_function`` annotation, and the
    host clock just before it (appended to ``anchors``)."""
    anchors.append(time.perf_counter())
    with torch.profiler.record_function(JOB):
        yield


def profiled(run, cuda: bool) -> Profile:
    """Run ``run(anchors)`` under ``torch.profiler`` (CPU and, with
    ``cuda``, the cards) and parse the trace."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    anchors = []
    with profile(activities=acts) as prof:
        run(anchors)
    path = os.path.join(tempfile.gettempdir(), "pemsbench_profile.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        if os.path.exists(path):
            os.remove(path)
    return Profile(doc, anchors)
