"""The port's span tracing (``repro_torch.obs`` and the spans of the
executor, engine, collectives, recovery, fault injection and sanitizer)
against the JAX package's (``repro.obs``).

The tracer's ring, drop count, span timings and ``NOOP``, and the export's
balance sanitizer, are the JAX package's; fed the same events, both
exporters write the same bytes.  Traced PSRS writes the JAX package's
events — the same multiset of (process, lane, name, category, phase) and
non-timing arguments — on every tier at ``P`` 1 and 2, with the same metric
keys, and leaves the keys and every ``ledger.*`` counter bit-equal to the
untraced run and to the JAX package's.  Each package's report reads the
other's trace.

One difference is the port's own and is tested here: on the file tier the
async writeback's buffer wait (billed to ``swap_out_s`` inside the compute
window) is a ``writeback_wait`` span nested in the round's compute span.

``tests/test_torch_gpu.py`` runs traced PSRS on the card.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import _chaos
from _chaos import assert_killed, run_child
from _jax_ref import apps
import repro.io as jio
import repro.obs as jobs
from repro_torch import io as tio
from repro_torch import obs as tobs
from repro_torch.core import PemsConfig, SuperstepCursor
from repro_torch.pems_apps import psrs_run_recoverable, psrs_sort

N, V, K = 4096, 8, 2
STAGES = ["stage:sort_sample", "stage:gather_samples", "stage:pick_splitters",
          "stage:bcast_splitters", "stage:partition", "stage:alltoallv",
          "stage:merge"]
# Arguments that carry a reading of the clock or of a racing queue.
TIMING_ARGS = ("queued_us",)
PORT_ONLY = ("writeback_wait",)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _keys(seed=0, n=N):
    return np.random.default_rng(seed).integers(-2**31, 2**31 - 1, size=n,
                                                dtype=np.int32)


def _lanes(trace) -> dict:
    return {(e["pid"], e["tid"]): e["args"]["name"]
            for e in trace["traceEvents"]
            if e["ph"] == "M" and e["name"] == "thread_name"}


def _multiset(trace, drop=()) -> collections.Counter:
    """(pid, lane, name, cat, ph, non-timing args) of every event.  The
    engine's worker lanes are one lane (which worker runs a request is the
    scheduler's choice), and a counter's value is the queue's momentary
    depth, so only its presence counts."""
    lanes = _lanes(trace)
    out = collections.Counter()
    for e in trace["traceEvents"]:
        if e["ph"] == "M" or e["name"] in drop:
            continue
        lane = lanes[(e["pid"], e["tid"])]
        if lane.startswith("repro-io"):
            lane = "repro-io"
        args = {} if e["ph"] == "C" else {
            k: v for k, v in (e.get("args") or {}).items()
            if k not in TIMING_ARGS}
        out[(e["pid"], lane, e["name"], e.get("cat"), e["ph"],
             json.dumps(args, sort_keys=True))] += 1
    return out


def _balance(trace) -> int:
    """Open spans left after walking B/E per lane (no orphan E allowed)."""
    stacks = {}
    for e in trace["traceEvents"]:
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            stacks.setdefault(key, []).append(e["name"])
        elif e["ph"] == "E":
            assert stacks.get(key), f"orphan E event: {e}"
            stacks[key].pop()
    return sum(len(s) for s in stacks.values())


def _ledger(metrics) -> dict:
    return {k: v for k, v in metrics.items() if k.startswith("ledger.")}


# --------------------------------------------------------------------------- #
# The tracer and the exporter                                                  #
# --------------------------------------------------------------------------- #

def test_tracer_ring_bounds_and_drop_count():
    tr = tobs.Tracer(capacity=4)
    for i in range(10):
        tr.instant(f"e{i}")
    assert len(tr) == 4
    assert tr.dropped == 6
    assert [e[1] for e in tr.events()] == ["e6", "e7", "e8", "e9"]
    tr.clear()
    assert len(tr) == 0 and tr.dropped == 0
    with pytest.raises(ValueError, match="capacity"):
        tobs.Tracer(capacity=0)


def test_tracer_span_records_caller_timings():
    tr = tobs.Tracer()
    with tr.span("work", tid="lane", cat="compute", round=3) as sp:
        sum(range(10000))
    (ph, name, tid, ts, dur, cat, args), = tr.events()
    assert (ph, name, tid, cat) == ("X", "work", "lane", "compute")
    assert args == {"round": 3}
    assert dur == sp.duration_s == sp.t1 - sp.t0 and dur > 0
    assert ts == sp.t0 - tr.epoch
    # complete() bills exactly the caller's readings.
    tr.complete("x", 1.0 + tr.epoch, 3.5 + tr.epoch, tid="lane")
    ev = tr.events()[-1]
    assert ev[3] == pytest.approx(1.0) and ev[4] == pytest.approx(2.5)
    # Tracers built on one epoch share a timeline.
    assert tobs.Tracer(epoch=tr.epoch).epoch == tr.epoch


def test_noop_tracer_is_inert():
    assert not tobs.NOOP.enabled
    with tobs.NOOP.span("x", tid="y") as sp:
        pass
    assert sp.duration_s == 0.0
    tobs.NOOP.begin("a")
    tobs.NOOP.end("a")
    tobs.NOOP.instant("b")
    tobs.NOOP.counter("c", 1)
    tobs.NOOP.complete("d", 0.0, 1.0)
    assert tobs.NOOP.events() == [] and len(tobs.NOOP) == 0
    # Every stand-in of the port is the one singleton.
    assert tio.IOEngine.__init__.__globals__["NOOP"] is tobs.NOOP
    assert tio.FaultyFile.tracer is tobs.NOOP
    assert tio.SanitizingFile.tracer is tobs.NOOP
    assert SuperstepCursor.tracer is tobs.NOOP


def test_export_closes_dangling_begin_and_drops_orphan_end():
    tr = tobs.Tracer()
    tr.begin("outer", tid="lane")
    tr.begin("inner", tid="lane")
    tr.end("inner", tid="lane")
    # "outer" never ends (a crash): the export closes it.
    evs = [e for e in tobs.trace_events(tr, pid=0) if e["ph"] in ("B", "E")]
    assert _balance({"traceEvents": evs}) == 0
    assert [e["name"] for e in evs if e["ph"] == "E"][-1] == "outer"

    tr2 = tobs.Tracer()
    tr2.end("ghost", tid="lane")      # its B fell off the ring: dropped
    assert [e for e in tobs.trace_events(tr2, pid=0)
            if e["ph"] in ("B", "E")] == []


def _scenario(name: str) -> tobs.Tracer:
    tr = tobs.Tracer(capacity=5 if name == "wrapped" else 1 << 16,
                     name=f"t-{name}")
    tr.begin("outer", tid="a", cat="recovery", stage=1)
    tr.complete("swap_in", tr.epoch + 0.25, tr.epoch + 1.5, tid="prefetch",
                cat="io", round=0, bytes=4096)
    tr.instant("fault:eio", cat="fault", op="read", offset=0, nbytes=8)
    tr.counter("queue_depth", 3, tid="queue")
    with tr.span("chunk", tid="collective", cat="collective", dst=0, c0=2):
        pass
    if name != "dangling":
        tr.end("outer", tid="a")
    if name == "orphan":
        tr.end("ghost", tid="b")
    tr.instant("drain_timeout", cat="engine", stuck=[["write", "[0,8)"]])
    return tr


@pytest.mark.parametrize("name", ["nested", "dangling", "orphan", "wrapped"])
def test_exporters_write_the_same_bytes(tmp_path, name):
    """One tracer's events through each package's exporter: the same
    trace_events, the same write_trace file, the same merged file."""
    tr = _scenario(name)
    assert tobs.trace_events(tr, 3) == jobs.trace_events(tr, 3)
    metrics = {"tier.rounds": 4, "ledger.h2d_bytes": 8}
    main_tr = _scenario("nested")
    out = []
    for pkg, mod in (("jax", jobs), ("port", tobs)):
        part = mod.write_trace(str(tmp_path / f"{pkg}.p0"),
                               mod.trace_events(tr, pid=1))
        main = mod.trace_events(main_tr, pid=0, process_name="main")
        merged = mod.merge_trace_files(str(tmp_path / f"{pkg}.json"),
                                       [part], extra_events=main,
                                       metrics=metrics)
        with open(part, "rb") as f, open(merged, "rb") as g:
            out.append((f.read(), g.read()))
    assert out[0] == out[1]


# --------------------------------------------------------------------------- #
# Traced PSRS against the JAX package                                          #
# --------------------------------------------------------------------------- #

MATRIX = [("device", None, 1, "async"), ("host", None, 1, "sliced"),
          ("host", None, 2, "async"), ("memmap", None, 1, "explicit"),
          ("memmap", None, 2, "async"), ("file", "buffered", 1, "async"),
          ("file", "buffered", 2, "sliced"), ("file", "odirect", 1, "async"),
          ("file", "odirect", 2, "async")]


def _run(pkg, tmp_path, tier, io_driver, P, driver, trace, tag="", seed=0):
    """psrs_sort of one package: (keys, trace or None, pems)."""
    kw = dict(v=V, k=K, P=P, tier=tier, driver=driver, return_pems=True)
    if tier in ("memmap", "file"):
        kw["backing_path"] = str(tmp_path / f"{pkg}{tag}.bin")
    if io_driver is not None:
        kw["io_driver"] = io_driver
    tp = str(tmp_path / f"{pkg}{tag}.json") if trace else None
    if trace:
        kw.update(trace=True, trace_path=tp)
    if pkg == "jax":
        out, pems = apps.psrs_sort(_keys(seed), **kw)
        out = np.asarray(out)
    else:
        out, pems = psrs_sort(torch.from_numpy(_keys(seed)), device="cpu",
                              **kw)
        out = out.numpy()
    return out, (jobs.load_trace(tp) if trace else None), pems


@pytest.mark.parametrize("tier, io_driver, P, driver", MATRIX)
def test_traced_psrs_writes_the_jax_packages_events(tmp_path, tier,
                                                    io_driver, P, driver):
    jout, jtrace, _ = _run("jax", tmp_path, tier, io_driver, P, driver, True)
    tout, ttrace, tpems = _run("port", tmp_path, tier, io_driver, P, driver,
                               True)
    plain, _, ppems = _run("port", tmp_path, tier, io_driver, P, driver,
                           False, tag="plain")
    np.testing.assert_array_equal(jout, np.sort(_keys()))
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_array_equal(plain, tout)
    # Tracing changes no counter; the ledger is the JAX package's.
    assert _ledger(ttrace["metrics"]) == _ledger(jtrace["metrics"])
    assert ([led.snapshot() for led in tpems.shard_ledgers]
            == [led.snapshot() for led in ppems.shard_ledgers])
    assert tpems.ledger.snapshot() == ppems.ledger.snapshot()
    assert sorted(ttrace["metrics"]) == sorted(jtrace["metrics"])
    assert list(ttrace) == list(jtrace) == ["traceEvents", "displayTimeUnit",
                                            "metrics"]
    # The same events, lane for lane, but the port's own writeback waits.
    assert _multiset(ttrace, drop=PORT_ONLY) == _multiset(jtrace)
    assert _balance(ttrace) == 0
    evs = ttrace["traceEvents"]
    assert [e["name"] for e in sorted(
        (e for e in evs if e.get("cat") == "stage"),
        key=lambda e: e["ts"])] == STAGES
    assert {e["pid"] for e in evs} == (
        {0} if tier == "device" else {0, *range(1, P + 1)})
    # Merged: no part file is left beside the trace.
    assert not [f for f in os.listdir(tmp_path) if ".json.p" in f]


def _sum(tracer, lane, names) -> float:
    return sum(e[4] for e in tracer.events()
               if e[0] == "X" and e[2] == lane and e[1] in names)


@pytest.mark.parametrize("driver", ["async", "explicit"])
def test_spans_bill_what_tierstats_bills(tmp_path, driver):
    """Every interval TierStats is billed with is one span of the same two
    readings, and the report's overlap cross-check agrees exactly."""
    tp = str(tmp_path / "t.json")
    out, pems = psrs_sort(torch.from_numpy(_keys(29)), v=V, k=1, P=2,
                          tier="file", driver=driver, trace=True,
                          trace_path=tp, device="cpu", return_pems=True,
                          backing_path=str(tmp_path / "ctx.bin"))
    np.testing.assert_array_equal(out.numpy(), np.sort(_keys(29)))
    for tr, st in zip(pems.shard_tracers, pems.shard_stats):
        for names, lane, total in (
                (("swap_in",), "prefetch", st.swap_in_s),
                (("stall",), "rounds", st.stall_s),
                (("compute",), "rounds", st.compute_s),
                (("swap_out", "writeback_wait"), "rounds", st.swap_out_s)):
            assert _sum(tr, lane, names) == pytest.approx(total, rel=1e-9)
    s = tobs.summarize(tobs.load_trace(tp))
    assert s["metrics_overlap"] == pems.merged_shard_stats().overlap_fraction
    assert s["overlap_fraction"] == pytest.approx(s["metrics_overlap"],
                                                  abs=1e-9)


@pytest.mark.parametrize("driver", ["async", "explicit"])
def test_writeback_waits_nest_in_their_rounds_compute(tmp_path, driver):
    """The port's one extra span: a round whose out buffer still has a
    writeback in flight waits for it inside its compute window.  Under
    async writeback that is every round from the third, in each superstep
    that writes back asynchronously (all four under ``async``, the streamed
    merge alone under ``explicit``)."""
    v, k = 8, 1
    _, pems = psrs_sort(torch.from_numpy(_keys(5)), v=v, k=k, tier="file",
                        driver=driver, trace=True, device="cpu",
                        return_pems=True,
                        backing_path=str(tmp_path / "ctx.bin"))
    evs = [e for e in pems.shard_tracers[0].events()
           if e[0] == "X" and e[2] == "rounds"]
    waits = [e for e in evs if e[1] == "writeback_wait"]
    async_steps = 4 if driver == "async" else 1
    assert len(waits) == async_steps * (v // k - 2)
    compute = {}
    for e in evs:
        if e[1] == "compute":
            compute.setdefault(e[6]["round"], []).append(e)
    for w in waits:
        assert w[5] == "io"
        assert any(c[3] <= w[3] and w[3] + w[4] <= c[3] + c[4]
                   for c in compute[w[6]["round"]])


def test_shard_traces_merge_to_the_single_process_totals(tmp_path):
    _, _, p1 = _run("port", tmp_path, "file", None, 1, "async", True,
                    tag="p1", seed=41)
    _, trace, p2 = _run("port", tmp_path, "file", None, 2, "async", True,
                        tag="p2", seed=41)
    merged = p2.merged_shard_ledger().snapshot()
    single = p1.ledger.snapshot()
    for key in ("ledger.disk_read_bytes", "ledger.disk_write_bytes",
                "ledger.h2d_bytes", "ledger.d2h_bytes",
                "ledger.syscall_read_bytes", "ledger.syscall_write_bytes"):
        assert merged[key] == single[key] == trace["metrics"][key], key
    stats = p2.merged_shard_stats()
    assert stats.rounds == p1.tier_stats.rounds
    snap = p2.metrics_snapshot()
    for key, val in stats.snapshot().items():
        assert snap[key] == val
    assert "shard0.tier.rounds" in snap and "shard1.tier.rounds" in snap
    # One process lane a shard, each with its own rounds and engine lanes.
    lanes = _lanes(trace)
    for pid in (1, 2):
        names = {n for (p, _), n in lanes.items() if p == pid}
        assert {"rounds", "prefetch", "queue"} <= names
        assert any(n.startswith("repro-io") for n in names)


def test_export_and_config_errors_match_jax(tmp_path):
    tp = str(tmp_path / "t.json")
    with pytest.raises(ValueError) as port:
        PemsConfig(v=4, trace_path=tp)
    with pytest.raises(ValueError) as ref:
        apps.psrs_sort(_keys(), v=4, trace_path=tp)
    assert str(port.value) == str(ref.value)
    _, pems = psrs_sort(torch.from_numpy(_keys()), v=4, device="cpu",
                        return_pems=True)
    with pytest.raises(ValueError, match="trace=True"):
        pems.export_trace(tp)
    _, pems = psrs_sort(torch.from_numpy(_keys()), v=4, device="cpu",
                        trace=True, return_pems=True)
    with pytest.raises(ValueError, match="needs a path"):
        pems.export_trace()
    assert pems.export_trace(tp) == tp and os.path.exists(tp)


# --------------------------------------------------------------------------- #
# Each package's report on the other's trace                                   #
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """A traced async file-tier run at P = 2 of each package."""
    d = tmp_path_factory.mktemp("traces")
    return {pkg: _run(pkg, d, "file", None, 2, "async", True, seed=7)[1]
            for pkg in ("jax", "port")}


@pytest.mark.parametrize("trace_of", ["jax", "port"])
def test_each_report_reads_the_other_packages_trace(traces, trace_of):
    trace = traces[trace_of]
    port, ref = tobs.summarize(trace, top=3), jobs.summarize(trace, top=3)
    assert port == ref
    assert tobs.render(port) == jobs.render(ref)
    assert [r["name"] for r in port["stages"]] == STAGES
    assert port["metrics_overlap"] is not None
    assert abs(port["overlap_fraction"] - port["metrics_overlap"]) <= 1e-9
    assert len(port["slowest"]) == 3
    assert port["totals"]["compute_s"] > 0 and port["totals"]["io_s"] > 0


@pytest.mark.parametrize("cli, trace_of", [("repro_torch.obs", "jax"),
                                           ("repro.obs", "port")])
def test_report_cli_reads_the_other_packages_trace(tmp_path, traces, cli,
                                                   trace_of):
    tp = str(tmp_path / "t.json")
    with open(tp, "w") as f:
        json.dump(traces[trace_of], f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", cli, "report", tp, "--top",
                        "3"], capture_output=True, text=True, timeout=120,
                       env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == jobs.report(tp, top=3)
    assert "overlap fraction (spans)" in r.stdout
    assert "overlap fraction (TierStats)" in r.stdout
    assert "stage:merge" in r.stdout


# --------------------------------------------------------------------------- #
# Recovery spans, fault and sanitizer instants                                 #
# --------------------------------------------------------------------------- #

def _recoverable(pkg, state_dir, tp, **kw):
    kw = dict(v=_chaos.V, k=_chaos.K, state_dir=str(state_dir),
              io_queue_depth=4, trace=True, trace_path=str(tp), **kw)
    if pkg == "jax":
        return np.asarray(apps.psrs_run_recoverable(_chaos.keys(), **kw))
    return psrs_run_recoverable(torch.from_numpy(_chaos.keys()),
                                device="cpu", **kw).numpy()


def _recovery(trace) -> collections.Counter:
    """The recovery lanes' events (an end event carries no category)."""
    return collections.Counter(
        (lane, name, ph) for (_, lane, name, _, ph, _), n
        in _multiset(trace).items() if lane.startswith("recovery")
        for _ in range(n))


@pytest.mark.parametrize("P", [1, 2])
def test_recoverable_run_traces_the_cursor_windows(tmp_path, P):
    got = {}
    for pkg in ("jax", "port"):
        out = _recoverable(pkg, tmp_path / pkg, tmp_path / f"{pkg}.json",
                           P=P)
        np.testing.assert_array_equal(out, np.sort(_chaos.keys()))
        got[pkg] = jobs.load_trace(str(tmp_path / f"{pkg}.json"))
    rec = _recovery(got["port"])
    assert rec == _recovery(got["jax"])
    assert _multiset(got["port"], drop=PORT_ONLY) == _multiset(got["jax"])
    assert _balance(got["port"]) == 0
    lanes = ["recovery"] if P == 1 else [f"recovery.p{p}" for p in range(P)]
    for lane in lanes:
        # load + the seven plan stages, each window one begin and one end.
        assert sum(n for (ln, name, ph), n in rec.items()
                   if ln == lane and ph == "B") == _chaos.N_STAGES
    # sort_sample, bcast_splitters and merge snapshot first, per process.
    assert rec[("recovery", "snapshot:save", "X")] == 3 * P


def test_a_resume_traces_the_snapshot_restore_like_jax(tmp_path):
    """A port child killed inside the merge; the state dir resumed, traced,
    by each package: one restore and the merge's window alone."""
    sd = tmp_path / "crashed"
    assert_killed(run_child(sd, kind="in", stage="merge"))
    got = {}
    for pkg in ("jax", "port"):
        shutil.copytree(sd, tmp_path / pkg)
        out = _recoverable(pkg, tmp_path / pkg, tmp_path / f"{pkg}.json")
        np.testing.assert_array_equal(out, np.sort(_chaos.keys()))
        got[pkg] = jobs.load_trace(str(tmp_path / f"{pkg}.json"))
    rec = _recovery(got["port"])
    assert rec == _recovery(got["jax"])
    assert rec == {("recovery", "snapshot:restore", "X"): 1,
                   ("recovery", "snapshot:save", "X"): 1,
                   ("recovery", "in_progress:merge", "B"): 1,
                   ("recovery", "in_progress:merge", "E"): 1}
    assert _multiset(got["port"], drop=PORT_ONLY) == _multiset(got["jax"])


@pytest.mark.parametrize("spec", ["seed=3;eio@p0.3", "lat@w0-5:0.0005",
                                  "shard=1;eio@r1;eio@w2:x2"])
def test_fault_instants_match_jax(tmp_path, spec):
    got = {}
    for pkg in ("jax", "port"):
        kw = dict(v=V, k=K, P=2, tier="file", driver="sliced",
                  io_driver="faulty:buffered", fault_spec=spec,
                  io_queue_depth=1, io_retries=3, trace=True,
                  trace_path=str(tmp_path / f"{pkg}.json"),
                  backing_path=str(tmp_path / f"{pkg}.bin"),
                  return_pems=True)
        if pkg == "jax":
            out, pems = apps.psrs_sort(_keys(3), **kw)
            out = np.asarray(out)
        else:
            out, pems = psrs_sort(torch.from_numpy(_keys(3)), device="cpu",
                                  **kw)
            out = out.numpy()
        np.testing.assert_array_equal(out, np.sort(_keys(3)))
        trace = jobs.load_trace(str(tmp_path / f"{pkg}.json"))
        faults = collections.Counter(
            (e["pid"], e["name"], e["args"]["op"], e["args"]["offset"])
            for e in trace["traceEvents"] if e.get("cat") == "fault")
        injected = sum(sum(getattr(sh.file, "injected", {}).values())
                       for sh in pems.backing.shards)
        assert sum(faults.values()) == injected > 0
        got[pkg] = (faults, _multiset(trace, drop=PORT_ONLY))
    assert got["port"] == got["jax"]


def _sanitizer_instants(mod, tracer_cls, tmp_path, name, plant):
    f = mod.open_file(str(tmp_path / name), 1 << 16, "sanitize:buffered")
    eng = mod.IOEngine(f, queue_depth=4)
    eng.tracer = f.tracer = tracer_cls()
    try:
        eng._gate.clear()                  # hold the workers
        buf = np.ones(512, np.uint8)
        eng.submit_write(0, buf)
        if plant == "overlap":
            eng.submit_write(256, np.full(512, 2, np.uint8))
        else:
            buf[:8] = 7                    # mutate after submit
        eng._gate.set()
        eng.drain()
    finally:
        eng._gate.set()
        eng.close()
    return [(e[1], e[2], e[5], e[6]) for e in eng.tracer.events()
            if e[0] == "i"], [x.kind for x in f.findings]


@pytest.mark.parametrize("plant", ["overlap", "mutate-in-flight"])
def test_sanitizer_instants_match_jax(tmp_path, plant):
    port = _sanitizer_instants(tio, tobs.Tracer, tmp_path, "t.bin", plant)
    ref = _sanitizer_instants(jio, jobs.Tracer, tmp_path, "j.bin", plant)
    assert port == ref
    assert [i[0] for i in port[0]] == [f"sanitize:{plant}"]
    assert port[1] == [plant]


def test_untraced_runs_keep_the_noop_everywhere(tmp_path):
    """With tracing off nothing records: every tracer of the executor, the
    engines, the driver wrappers and the cursors is the NOOP singleton."""
    _, pems = psrs_sort(torch.from_numpy(_keys()), v=V, k=K, P=2,
                        tier="file", io_driver="sanitize:buffered",
                        device="cpu", return_pems=True,
                        backing_path=str(tmp_path / "ctx.bin"))
    assert pems.tracer is tobs.NOOP
    assert all(t is tobs.NOOP for t in pems.shard_tracers)
    for sh in pems.backing.shards:
        assert sh.engine.tracer is tobs.NOOP and sh.file.tracer is tobs.NOOP
    _, traced = psrs_sort(torch.from_numpy(_keys()), v=V, k=K, P=2,
                          tier="file", io_driver="sanitize:buffered",
                          device="cpu", return_pems=True, trace=True,
                          backing_path=str(tmp_path / "t.bin"))
    for p, sh in enumerate(traced.backing.shards):
        assert sh.engine.tracer is traced.shard_tracers[p]
        assert sh.file.tracer is traced.shard_tracers[p]
    assert len({id(t) for t in traced.shard_tracers}) == 2
    assert {t.epoch for t in traced.shard_tracers} == {traced.tracer.epoch}
