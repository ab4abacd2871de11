"""The benchmark's own tests: the manifest against its contract, the files
it names, the yardstick's arithmetic, the reference and its control, the
result's line, and faults planted under the timed path.

    PYTHONPATH=src python -m pytest -q pemsbench/tests

Everything runs on the CPU at a tiny size but ``test_cell_on_card``, marked
``gpu``, which asks the ``cuda`` fixture for the cards and skips without
them.
"""

from __future__ import annotations

import ast
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from pemsbench import keys as keygen  # noqa: E402
from pemsbench import manifest as mf  # noqa: E402
from pemsbench import reference, trace, yardstick  # noqa: E402
from pemsbench.generators.uniform import rand_int32  # noqa: E402
from pemsbench.run import FORBIDDEN, forbidden_modules, run_cell  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TINY = 1 << 12
MANIFEST = mf.load()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
CONFIG_FILES = sorted((ROOT / "pemsbench" / "configs").glob("*.json"))
TRAFFIC_FILES = sorted((ROOT / "pemsbench" / "traffic").glob("*.json"))


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


# ------------------------------------------------------------ the manifest
def test_manifest_keys_and_limits():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(m["command"]) <= 32
    assert all(_line(w) for w in m["command"])
    assert m["command"][1].split("/")[0] in m["paths"]
    rs = m["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells has to fit the driver's 43200 seconds.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_and_cells():
    m = MANIFEST
    assert 1 <= len(m["configs"]) <= 24 and 1 <= len(m["workloads"]) <= 24
    files = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in m["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        assert _line(c["source"]) and _line(c["why"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(k in cfg and NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in m["workloads"])
    sources = [c["source"] for c in m["configs"]]
    assert len(set(sources)) == len(sources)
    pairs, four = set(), 0
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert mf.config_file(m, w["config"])["chips"] == w["chips"]
        assert mf.traffic_path(w["traffic"]).exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        four += w["chips"] == 4
    assert four <= max(1, len(m["workloads"]) // 4)


def test_names_and_units():
    m = MANIFEST
    metrics = m["end_to_end"] + m["per_layer"]
    for group in (m["configs"], m["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(set(names)) == len(names)
        assert all(NAME.match(x) for x in names)
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for x in metrics:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")


def test_metrics_entries():
    m = MANIFEST
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    assert 1 <= len(m["per_layer"]) <= 128
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert x["moves"] in e2e and _line(x["layer"])
        if x["name"].endswith("_roofline"):
            assert x["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_enough(cell):
    e2e = mf.metrics_for(MANIFEST, cell, trace=False)
    names = {x["name"] for x in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert mf.metrics_for(MANIFEST, cell, trace=True)


def test_per_layer_cells_report_what_they_move():
    e2e = {x["name"]: x for x in MANIFEST["end_to_end"]}
    for x in MANIFEST["per_layer"]:
        moved = e2e[x["moves"]]
        for cell in x.get("workloads", CELLS):
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"]


@pytest.mark.parametrize("name", [x["name"] for x in
                                  MANIFEST["end_to_end"]
                                  + MANIFEST["per_layer"]])
def test_reader_file_matches_entry(name):
    entry = next(x for x in MANIFEST["end_to_end"] + MANIFEST["per_layer"]
                 if x["name"] == name)
    mod = mf.reader(name)
    assert callable(mod.read) and mod.UNIT == entry["unit"]
    if "layer" in entry:
        assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])
    assert mod.read({}) is None         # nothing to read: nothing returned


# ------------------------------------------------------- configs, traffic
@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.stem)
def test_config_file(path):
    cfg = json.loads(path.read_text())
    assert cfg["name"] == path.stem and NAME.match(cfg["name"])
    assert (ROOT / "pemsbench" / "systems" / f"{cfg['system']}.py").exists()
    assert set(cfg["reduced"]) <= set(cfg) and set(cfg["assumed"]) <= set(cfg)
    assert cfg["key_dtype"] == "int32" and cfg["n"] % cfg["v"] == 0
    assert cfg["v"] % cfg["P"] == 0 and cfg["tier"] in ("device", "host",
                                                        "memmap", "file")
    assert _line(cfg["source"])
    # Every key a configuration holds is set: an option left at the
    # program's default is left out.
    assert None not in cfg.values()


@pytest.mark.parametrize("path", TRAFFIC_FILES, ids=lambda p: p.stem)
def test_traffic_file(path):
    t = json.loads(path.read_text())
    assert set(t) == {"why", "divisors", "keys"} and _line(t["why"])
    cfg = {"n": 1 << 20}
    jobs = keygen.Jobs(t, cfg, 7)
    for j in range(len(t["divisors"])):
        assert jobs.keys(j, "cpu").numel() == jobs.size(j)
    assert sorted(jobs.size(j) for j in range(len(t["divisors"]))) == \
        sorted(cfg["n"] // d for d in t["divisors"])


def test_sizes_cycle_in_an_order_from_the_seed():
    t = {"why": "x", "divisors": [1, 2, 4, 8],
         "keys": {"distribution": "uniform"}}
    orders = set()
    for seed in range(8):
        jobs = keygen.Jobs(t, {"n": 1 << 10}, seed)
        cycles = [[jobs.size(4 * c + i) for i in range(4)]
                  for c in range(3)]
        # Every cycle sorts the same sizes; the seed orders them.
        assert all(sorted(c) == [128, 256, 512, 1024] for c in cycles)
        orders.add(tuple(cycles[0]))
        # The warm-up's jobs, below 0, take each size once, largest first.
        assert [jobs.size(-1 - i) for i in range(4)] == [1024, 512, 256,
                                                         128]
        assert jobs.keys(2, "cpu").numel() == jobs.size(2)
    assert len(orders) > 1


def test_a_distribution_is_a_module_found_by_name(monkeypatch):
    import types
    mod = types.ModuleType("pemsbench.generators.constant")
    mod.keys = lambda n, gen, value: torch.full((n,), value,
                                                dtype=torch.int32)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    t = {"why": "x", "divisors": [1],
         "keys": {"distribution": "constant", "value": 7}}
    assert keygen.Jobs(t, {"n": 16}, 1).keys(0, "cpu").tolist() == [7] * 16
    t["keys"] = {"distribution": "no_such_distribution"}
    with pytest.raises(ModuleNotFoundError):
        keygen.Jobs(t, {"n": 16}, 1)


def test_keys_come_from_the_seed():
    t = json.loads((ROOT / "pemsbench/traffic/full.json").read_text())
    a = keygen.Jobs(t, {"n": TINY}, 2**33 + 1).keys(5, "cpu")
    b = keygen.Jobs(t, {"n": TINY}, 2**33 + 1).keys(5, "cpu")
    c = keygen.Jobs(t, {"n": TINY}, 2**33 + 2).keys(5, "cpu")
    assert a.dtype == torch.int32 and a.numel() == TINY
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) < -2**30 and int(a.max()) > 2**30


# ---------------------------------------------------------- the yardstick
def test_least_bytes():
    assert yardstick.least_bytes("sort_sample", 1 << 28) == 1 << 31
    assert yardstick.least_bytes("merge", 1 << 28) == 1 << 31
    assert yardstick.HBM_BYTES_PER_S["NVIDIA H100 80GB HBM3"] == 3.35e12


def test_exchange_bytes_at_the_cells_sizes():
    # 2^29 keys over four cards: 16 contexts each send 12 remote messages
    # of 2^25 words, 24 GiB, and the gather and broadcast add 1920 bytes.
    assert yardstick.exchange_bytes(1 << 29, 16, 4) == 24 * 2**30 + 1920
    assert yardstick.exchange_bytes(1 << 28, 16, 1) == 0


@pytest.mark.parametrize("P", [1, 2, 4])
def test_exchange_bytes_equal_the_ledger(P):
    from repro_torch.core import make_mesh
    from repro_torch.pems_apps import psrs_sort
    x = rand_int32((TINY,), torch.Generator().manual_seed(P))
    mesh = make_mesh(P, device="cpu") if P > 1 else None
    _, pems = psrs_sort(x, v=16, k=1, P=P, mesh=mesh, device="cpu",
                        return_pems=True)
    assert pems.ledger.network == yardstick.exchange_bytes(TINY, 16, P)


def test_crossing_bytes():
    # 2^29 keys over four cards: 3/4 of them cross, 4 bytes each.
    assert yardstick.crossing_bytes(1 << 29, 16, 4) == 3 * 2**29
    assert yardstick.crossing_bytes(1 << 28, 16, 1) == 0


def test_nearest_rank():
    xs = list(range(1, 201))
    assert yardstick.nearest_rank(xs, 0.95) == 190
    assert yardstick.nearest_rank([5.0], 0.95) == 5.0


# ------------------------------------------------- reference and control
@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(cell):
    from repro_torch.core import make_mesh
    from repro_torch.pems_apps import psrs_sort
    cfg = mf.config_file(MANIFEST, mf.cell(MANIFEST, cell)["config"])
    x = rand_int32((TINY,), torch.Generator().manual_seed(9))
    mesh = make_mesh(cfg["P"], device="cpu") if cfg["P"] > 1 else None
    out = psrs_sort(x, v=cfg["v"], k=cfg["k"], P=cfg["P"], mesh=mesh,
                    driver=cfg["driver"], device="cpu")
    assert reference.compare(out, x) == {"mismatched_keys": 0,
                                         "length_gap": 0}


def test_the_control_fails():
    """The reference in float32 in the program's place: keys that differ
    below float32's 24 bits of mantissa come out in their input order."""
    gen = torch.Generator().manual_seed(4)
    x = rand_int32((1 << 14,), gen)
    got = reference.compare(reference.control_sort(x), x)
    assert got["length_gap"] == 0 and got["mismatched_keys"] > 0
    correct, _ = reference.verdict(dict(got, failed_jobs=0,
                                        network_bytes_gap=0,
                                        compared_jobs=1))
    assert not correct


def test_verdict_needs_every_reading_and_a_comparison():
    good = {"mismatched_keys": 0, "length_gap": 0, "network_bytes_gap": 0,
            "failed_jobs": 0}
    assert reference.verdict(dict(good, compared_jobs=2))[0]
    assert not reference.verdict(dict(good, compared_jobs=0))[0]
    assert not reference.verdict({"compared_jobs": 1})[0]


# ------------------------------------------------------ the result's line
@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, traced):
    out = run_cell(MANIFEST, cell, 2**31 + 77, 0.2, traced, ["cpu"],
                   scale_n=TINY, t_start=0.0)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert set(out) <= {"correct", "attempted", "failed", "metrics",
                        "device", "breakdown", "checks"}
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    allowed = {x["name"] for x in mf.metrics_for(MANIFEST, cell, traced)}
    assert out["metrics"] and set(out["metrics"]) <= allowed
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    json.dumps(out)


def test_a_mix_of_sizes_runs_and_is_correct(monkeypatch):
    mix = {"why": "x", "divisors": [1, 4, 2],
           "keys": {"distribution": "uniform"}}
    monkeypatch.setattr(mf, "traffic_file", lambda name: mix)
    out = run_cell(MANIFEST, CELLS[0], 5, 0.2, False, ["cpu"],
                   scale_n=TINY, t_start=0.0)
    assert out["correct"] is True and out["attempted"] >= 3


def test_a_configuration_passes_its_psrs_sort_arguments():
    from pemsbench.systems import psrs as system
    cfg = dict(mf.config_file(MANIFEST, "psrs-4cards"), P=2, v=8, alpha=1)
    sut = system.make(cfg, mf.traffic_file("full"), 3, ["cpu"],
                      scale_n=TINY)
    assert sut.kwargs["alpha"] == 1 and sut.kwargs["P"] == 2
    assert not {"n", "source", "chips", "deployment"} & set(sut.kwargs)
    sut.warm_up()
    sut.job(0)
    assert reference.verdict(sut.check())[0]


def _half(fields, cap=None, rcap=None):
    out = _SORTED_KEYS[0](fields, cap, rcap)
    return out[: out.numel() // 2]


def _altered(fields, cap=None, rcap=None):
    out = _SORTED_KEYS[0](fields, cap, rcap).clone()
    out[out.numel() // 3] += 1
    return out


_SORTED_KEYS = []


FAULTS = {
    # A step that returns its state unchanged: every superstep.
    "unchanged": ("repro_torch.core.executor.Pems", "superstep",
                  lambda self, store, *a, **k: store),
    # Half of the batch left out: half of the sorted keys returned.
    "half": ("repro_torch.pems_apps.psrs", "_sorted_keys", _half),
    # The exchange between real processors left out.
    "no_exchange": ("repro_torch.core.executor.Pems", "alltoallv",
                    lambda self, store, *a, **k: store),
    # An answer altered where it is produced.
    "altered": ("repro_torch.pems_apps.psrs", "_sorted_keys", _altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    import importlib

    from repro_torch.pems_apps import psrs
    owner, attr, fn = FAULTS[fault]
    mod_name, _, cls = owner.rpartition(".")
    if cls[0].isupper():
        target = getattr(importlib.import_module(mod_name), cls)
    else:
        target = importlib.import_module(owner)
    _SORTED_KEYS[:] = [psrs._sorted_keys]
    monkeypatch.setattr(target, attr, fn)
    out = run_cell(MANIFEST, cell, 11, 0.1, False, ["cpu"], scale_n=TINY,
                   t_start=0.0)
    assert out["correct"] is False


# --------------------------------------------------------------- imports
def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((ROOT / "pemsbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & set(FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", sys)
    assert "repro" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    assert "repro" in forbidden_modules()


def test_fails_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's folder
    gives a non-zero exit and no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "pemsbench", tmp_path / "pemsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run(
        [sys.executable, "pemsbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert r.returncode != 0
    assert '"correct"' not in r.stdout


# ------------------------------------------------------ the trace's reader
def _doc():
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": args}
    return {"traceEvents": [
        x("user_annotation", trace.JOB, 1000, 100),
        x("cuda_runtime", "cudaLaunchKernel", 1010, 2, correlation=1),
        x("kernel", "k1", 1015, 20, device=0, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 1050, 2, correlation=2),
        x("kernel", "k2", 1055, 30, device=0, correlation=2),
        x("gpu_memcpy", "Memcpy PtoP", 1060, 30, device=1, correlation=3),
    ]}


def test_profile_reduction():
    p = trace.Profile(_doc(), [0.5])
    assert p.window() == (1000, 1100)
    assert p.busy_us([0, 1]) == [50, 30]
    top = dict(p.top_ops(2))
    assert top == pytest.approx({"k2": 30e-6, "Memcpy PtoP": 30e-6})
    # Spans relative to an epoch of 0.4 s: the job's host clock read 0.5 s,
    # so 0.1 s after the epoch is the annotation's start.
    stages = p.stage_intervals(0, [("a", 0.1, 40e-6), ("b", 0.1 + 47e-6,
                                                        50e-6)], 0.4)
    assert [round(s[1]) for s in stages] == [1000, 1047]
    assert p.stage_device_s(stages, [0]) == pytest.approx(
        {"a": 20e-6, "b": 30e-6})
    idle = p.idle_by_stage([stages], [0])
    # Each gap goes by its midpoint: [1000, 1015) in a, [1035, 1055)
    # between a and b, [1085, 1100) in b.
    assert idle == pytest.approx({"stage:a": 15e-6, "a -> b": 20e-6,
                                  "stage:b": 15e-6})


def test_readers_on_a_record():
    rec = {"device_kind": "NVIDIA H100 80GB HBM3", "stage_keys": 1 << 28,
           "stage_device_s": {"merge": 2**31 / 3.35e12 * 4},
           "busy_s": [0.9, 0.7], "window_s": 1.0,
           "jobs": [{"n": 4, "wall_s": 0.010, "network_bytes": 10**10,
                     "crossing_bytes": 10**9,
                     "stages": [("partition", 0, 0.004),
                                ("alltoallv", 0.004, 0.002)]}]}
    assert mf.reader("merge_roofline").read(rec) == pytest.approx(25.0)
    assert mf.reader("sort_sample_roofline").read(rec) is None
    assert mf.reader("device_idle_share").read(rec) == pytest.approx(20.0)
    assert mf.reader("stage_ms.partition").read(rec) == pytest.approx(4.0)
    assert mf.reader("outside_stages_ms").read(rec) == pytest.approx(4.0)
    assert mf.reader("exchange_gbps").read(rec) == pytest.approx(500.0)
    window = {"window_s": 2.0, "setup_s": 3.0,
              "jobs": [{"n": 10, "event_ms": float(i), "peak_bytes": 20 * i}
                       for i in range(1, 21)]}
    assert mf.reader("sort_keys_per_s").read(window) == 100.0
    assert mf.reader("sort_ms_p95").read(window) == 19.0
    assert mf.reader("peak_bytes_per_key").read(window) == 40.0
    assert mf.reader("setup_s").read(window) == 3.0


# ---------------------------------------------------------------- a card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.device_count()


@pytest.mark.gpu
@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell, traced, cuda):
    chips = mf.cell(MANIFEST, cell)["chips"]
    if cuda < chips:
        pytest.skip(f"needs {chips} cards")
    devices = [torch.device("cuda", i) for i in range(chips)]
    out = run_cell(MANIFEST, cell, 2**32 + 3, 1.0, traced, devices,
                   scale_n=1 << 22, t_start=0.0)
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    want = {x["name"] for x in mf.metrics_for(MANIFEST, cell, traced)}
    assert set(out["metrics"]) == want
