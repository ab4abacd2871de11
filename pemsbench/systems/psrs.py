"""PSRS (thesis Alg 8.3.1) through ``repro_torch.pems_apps.psrs_sort``.

A run is a closed loop of one client: each job's keys are made on the first
card from the seed before the job's clock starts, the call sorts them, and
the next job starts when the output is ready with every card synchronised.
The untraced run measures for ``seconds``; the traced run reads the stage
spans (on drained streams) of jobs run with the program's tracer on, then
profiles a few jobs with the tracer off (device busy time, the device
operations that took most time) and a few with both (each stage's device
work, the idle time by stage).

After the last job a sample of the jobs drawn from the seed, whose outputs
were kept, is compared with the plain reference, and every job's count of
the bytes that crossed between real processors (``IOLedger.network``) with
the benchmark's own.
"""

from __future__ import annotations

import contextlib
import inspect
import random
import sys
import time
import traceback

import torch

from pemsbench import reference, trace, yardstick
from pemsbench.keys import Jobs, job_seed

STAGE_PREFIX = "stage:"
SAMPLES = 3             # job outputs kept for the reference
SPAN_JOBS, SPAN_S = 10, 3.0     # traced jobs read for the stage spans
TRACE_JOBS, TRACE_S = 3, 1.0    # jobs in each profiled phase


class Reservoir:
    """A sample of ``size`` job outputs drawn from the seed as the jobs come
    (Vitter's algorithm R): every job is equally likely to be kept."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(job_seed(seed, "sample"))
        self.kept = []                  # [(job, output)]
        self.offered = 0

    def offer(self, job: int, out) -> None:
        i = self.offered
        self.offered += 1
        if i < self.size:
            self.kept.append((job, out))
            return
        r = self.rng.randrange(i + 1)
        if r < self.size:
            self.kept[r] = (job, out)


class Psrs:
    """One configuration of PSRS on ``devices`` (the cell's cards, or the
    CPU in the tests) under one traffic mix."""

    def __init__(self, config: dict, traffic: dict, seed: int, devices,
                 scale_n=None):
        from repro_torch.core import Mesh, make_mesh
        from repro_torch.pems_apps import psrs_sort
        self.sort = psrs_sort
        self.jobs = Jobs(traffic, config, seed, scale_n)
        devices = [torch.device(d) for d in devices]
        self.cards = [d for d in devices if d.type == "cuda"]
        self.home = devices[0]
        P = int(config["P"])
        mesh = None
        if config["tier"] == "device" and P > 1:
            mesh = (Mesh(devices) if len(devices) == P
                    else make_mesh(P, device=self.home))
        # Every key of the configuration that names an argument of
        # psrs_sort is passed as it stands; what a configuration leaves out
        # takes the program's default.
        args = inspect.signature(psrs_sort).parameters
        self.kwargs = {k: x for k, x in config.items() if k in args}
        self.kwargs.update(mesh=mesh, device=self.home)
        self.card_peak = [0] * len(self.cards)
        self.attempted = self.failed = self.warm_failed = 0
        self.network_gap = 0
        self.sample = Reservoir(SAMPLES, seed)

    # ------------------------------------------------------------- one job
    def sync(self) -> None:
        for c in self.cards:
            torch.cuda.synchronize(c)

    def job(self, j, trace_spans: bool = False, anchors=None,
            keep: bool = True) -> dict:
        """Run job ``j`` (below 0 for the warm-up's) and return its
        record: ``n``, ``wall_s``, ``event_ms`` (CUDA events
        on the first card's stream), ``peak_bytes`` (the call's peak over
        the cards, input included), ``network_bytes``, ``crossing_bytes``
        and, traced, ``stages`` as ``(name, t0, dur)`` from the tracer's
        ``epoch``."""
        n = self.jobs.size(j)
        keys = self.jobs.keys(j, self.home)
        self.sync()
        before = [torch.cuda.memory_allocated(c) for c in self.cards]
        for c in self.cards:
            torch.cuda.reset_peak_memory_stats(c)
        events = None
        if self.cards:
            events = [torch.cuda.Event(enable_timing=True) for _ in "se"]
            events[0].record()
        if keep:
            self.attempted += 1
        rec = {"n": n}
        t0 = time.perf_counter()
        marked = (contextlib.nullcontext() if anchors is None
                  else trace.job_annotation(anchors))
        try:
            with marked:
                out, pems = self.sort(keys, return_pems=True,
                                      trace=trace_spans, **self.kwargs)
        except Exception:               # a job that gives no answer
            traceback.print_exc(file=sys.stderr)
            self.sync()
            if keep:
                self.failed += 1
            else:
                self.warm_failed += 1
            rec["failed"] = True
            return rec
        if events:
            events[1].record()
        self.sync()
        rec["wall_s"] = time.perf_counter() - t0
        if events:
            rec["event_ms"] = events[0].elapsed_time(events[1])
        peaks = [torch.cuda.max_memory_allocated(c) for c in self.cards]
        self.card_peak = [max(a, b) for a, b in zip(self.card_peak, peaks)]
        if self.cards:
            rec["peak_bytes"] = (sum(p - b for p, b in zip(peaks, before))
                                 + keys.numel() * keys.element_size())
        v, P = self.kwargs["v"], self.kwargs["P"]
        rec["network_bytes"] = int(pems.ledger.network)
        rec["crossing_bytes"] = yardstick.crossing_bytes(n, v, P)
        want = yardstick.exchange_bytes(n, v, P)
        self.network_gap = max(self.network_gap,
                               abs(rec["network_bytes"] - want))
        if trace_spans:
            rec["epoch"] = pems.tracer.epoch
            rec["stages"] = [(ev[1][len(STAGE_PREFIX):], ev[3], ev[4])
                             for ev in pems.tracer.events()
                             if ev[0] == "X" and ev[5] == "stage"
                             and ev[1].startswith(STAGE_PREFIX)]
        if keep:
            self.sample.offer(j, out)
        return rec

    def warm_up(self) -> None:
        """One job at each size of the mix, the largest first: the
        kernels' build or load, the allocator's blocks, every shape of the
        window."""
        for i in range(len(self.jobs.warm)):
            self.job(-1 - i, keep=False)

    # ---------------------------------------------------------------- runs
    def window(self, seconds: float, t_start: float) -> dict:
        """The untraced run: warm up, then jobs back to back for
        ``seconds``; ``setup_s`` runs from ``t_start`` to the window."""
        self.warm_up()
        t_w = time.perf_counter()
        deadline = t_w + seconds
        jobs, j = [], 0
        while True:
            jobs.append(self.job(j))
            j += 1
            if time.perf_counter() >= deadline:
                break
        done = [r for r in jobs if not r.get("failed")]
        ms = [round(r.get("event_ms", r["wall_s"] * 1e3), 3) for r in done]
        print(f"pemsbench: {len(jobs)} jobs, {len(done)} done; ms of the "
              f"first five {ms[:5]}, the slowest five {sorted(ms)[-5:]}",
              file=sys.stderr)
        return {"setup_s": t_w - t_start,
                "window_s": time.perf_counter() - t_w, "jobs": done}

    def traced(self) -> dict:
        """The traced run: traced jobs, then profiled jobs with the tracer
        off, then profiled traced jobs (see the module's docstring)."""
        self.warm_up()
        cuda = bool(self.cards)
        cards = [c.index for c in self.cards]
        j = iter(range(SPAN_JOBS + 2 * TRACE_JOBS))

        def phase(count, seconds, anchors, spans):
            """Up to ``count`` jobs, fewer where they pass ``seconds``."""
            done, t0 = [], time.perf_counter()
            while len(done) < count and (
                    not done or time.perf_counter() - t0 < seconds):
                done.append(self.job(next(j), trace_spans=spans,
                                     anchors=anchors))
            return done

        spans = [r for r in phase(SPAN_JOBS, SPAN_S, None, True)
                 if not r.get("failed")]
        for r in spans:
            print("pemsbench: traced job %.3f ms: %s" % (
                r["wall_s"] * 1e3, ", ".join(
                    f"{name} {dur * 1e3:.3f}" for name, _, dur
                    in r["stages"])), file=sys.stderr)
        a_jobs, b_jobs = [], []
        prof_a = trace.profiled(
            lambda an: a_jobs.extend(phase(TRACE_JOBS, TRACE_S, an, False)),
            cuda)
        prof_b = trace.profiled(
            lambda an: b_jobs.extend(phase(TRACE_JOBS, TRACE_S, an, True)),
            cuda)
        out = {"jobs": spans}
        if not cards or any(r.get("failed") for r in a_jobs + b_jobs):
            return out
        lo, hi = prof_a.window()
        out["window_s"] = (hi - lo) * 1e-6
        out["busy_s"] = [b * 1e-6 for b in prof_a.busy_us(cards)]
        out["device_ops"] = prof_a.top_ops(10)
        stages = [prof_b.stage_intervals(i, r["stages"], r["epoch"])
                  for i, r in enumerate(b_jobs)]
        out["stage_device_s"] = prof_b.stage_device_s(
            [s for job in stages for s in job], cards)
        out["stage_keys"] = sum(r["n"] for r in b_jobs)
        print("pemsbench: device ms a job by stage: " + ", ".join(
            f"{k} {v * 1e3 / len(b_jobs):.3f}"
            for k, v in out["stage_device_s"].items()), file=sys.stderr)
        idle = prof_b.idle_by_stage(stages, cards)
        out["idle_gaps"] = sorted(([k, v] for k, v in idle.items()),
                                  key=lambda kv: -kv[1])[:10]
        return out

    # ---------------------------------------------------------- the check
    def check(self) -> dict:
        """Compare the kept outputs with the reference, once the program's
        state is freed; the readings that decide ``correct``."""
        kept, self.sample.kept = self.sample.kept, []
        readings = {"failed_jobs": self.failed + self.warm_failed,
                    "network_bytes_gap": self.network_gap}
        worst = {"mismatched_keys": 0, "length_gap": 0}
        while kept:
            j, out = kept.pop()
            keys = self.jobs.keys(j, self.home)
            for name, value in reference.compare(out, keys).items():
                worst[name] = max(worst[name], value)
            del out, keys
        readings.update(worst)
        readings["compared_jobs"] = min(self.sample.offered, SAMPLES)
        return readings


def make(config: dict, traffic: dict, seed: int, devices, scale_n=None):
    return Psrs(config, traffic, seed, devices, scale_n)
