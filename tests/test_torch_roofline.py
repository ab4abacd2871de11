"""The port's roofline analysis and report (``repro_torch.roofline``)
against the JAX package's (``repro.roofline``).

The formulas are the same float expressions over the same inputs, so
``roofline_terms``, ``analytic_bytes_floor`` and ``model_flops`` must equal
JAX's exactly (JAX's ``HW`` passed to the port), and the report's tables
must be JAX's rows character for character.  ``collective_bytes`` reads a
``CommDebugMode`` record in place of HLO text: a hand-built DTensor program
on a fake 16×16 mesh with one redistribute of each kind DTensor issues
gives known bytes and counts, exactly.
"""

import math

import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.roofline import analyze as janalyze
from repro.roofline import report as jreport
from repro_torch.configs import SHAPES, get_config
from repro_torch.roofline import HW, analyze, collective_bytes, report
from repro_torch.roofline.analyze import collective_kind

from test_roofline_report import _row

TERMS = [(197e12, 819e9, 0.0), (1e12, 819e9, 500e9), (5e13, 2e12, 5e10),
         (0.0, 0.0, 0.0), (3.1e14, 4.2e11, 7.7e9)]


@pytest.mark.parametrize("flops,bytes_,coll", TERMS)
def test_roofline_terms_equal_jax_with_its_hw(flops, bytes_, coll):
    got = analyze.roofline_terms(flops, bytes_, coll, hw=janalyze.HW)
    assert got == janalyze.roofline_terms(flops, bytes_, coll)


def test_hw_is_the_h100_data_sheet():
    assert HW["peak_flops"] == 989e12 and HW["hbm_bw"] == 3.35e12
    assert HW["link_bw"] == 450e9
    assert HW["hbm_bytes"] == 85_017_493_504   # total_memory on the card
    t = analyze.roofline_terms(989e12, 3.35e12, 0.0)
    assert math.isclose(t["compute_s"], 1.0)
    assert math.isclose(t["memory_s"], 1.0)


FLOOR = [
    ("train", dict(n_params=int(1.5e9), n_active=int(1.5e9), n_layers=28,
                   d_model=1536, vocab=151936, tokens=256 * 4096, n_mb=8,
                   n_chips=256)),
    ("train", dict(n_params=int(1e12), n_active=int(3.2e10), n_layers=61,
                   d_model=7168, vocab=163840, tokens=256 * 4096, n_mb=8,
                   n_chips=512, opt_bytes_per_param=4)),
    ("decode", dict(n_params=int(1.5e9), n_active=int(1.5e9), n_layers=28,
                    d_model=1536, vocab=151936, tokens=128, n_mb=1,
                    n_chips=256, cache_bytes=int(20e9))),
    ("prefill", dict(n_params=int(3e9), n_active=int(3e9), n_layers=18,
                     d_model=2048, vocab=257216, tokens=32 * 32768, n_mb=1,
                     n_chips=256, cache_bytes=int(9e9), param_bytes=4)),
]


@pytest.mark.parametrize("kind,kw", FLOOR)
def test_analytic_bytes_floor_equals_jax(kind, kw):
    assert (analyze.analytic_bytes_floor(kind, **kw)
            == janalyze.analytic_bytes_floor(kind, **kw))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "kimi-k2-1t-a32b",
                                  "mamba2-130m"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_model_flops_equal_jax(arch, shape):
    n = 1.234e9
    assert (analyze.model_flops(get_config(arch), SHAPES[shape], n)
            == janalyze.model_flops(jax_config(arch), JAX_SHAPES[shape], n))


def test_count_params_over_the_port_nest():
    tree = {"a": torch.empty(3, 4), "layers": [{"w": torch.empty(5)},
                                               {"w": torch.empty(5)}]}
    assert analyze.count_params(tree) == 22


def _calibrated(d):
    d["calibrated"] = {
        "flops": 5e13, "bytes": 2e12, "coll": 5e10,
        "roofline": {"compute_s": 0.25, "memory_s": 2.4,
                     "collective_s": 1.0, "dominant": "memory",
                     "roofline_fraction": 0.105,
                     "step_lower_bound_s": 2.4},
        "useful_flop_ratio": 0.4, "memory_floor_s": 0.5,
        "roofline_fraction_optimistic": 0.25,
    }
    return d


ROWS = [
    [_row(), {"arch": "x", "shape": "long_500k", "skipped": "reason"}],
    [_row(multi_pod=True), _row(arch="e", error="boom")],
    [_calibrated(_row())],
    [_row(kind="decode", shape="decode_32k"),
     _row(roofline={"compute_s": 1.0, "memory_s": 0.1, "collective_s": 0.2,
                    "dominant": "compute", "roofline_fraction": 1.0,
                    "step_lower_bound_s": 1.0})],
    [_row(roofline={"compute_s": 0.1, "memory_s": 0.1, "collective_s": 2.0,
                    "dominant": "collective", "roofline_fraction": 0.05,
                    "step_lower_bound_s": 2.0})],
]


@pytest.mark.parametrize("rows", ROWS)
def test_report_tables_equal_jax(rows):
    for tag in ("single", "multi"):
        assert (report.dryrun_table(rows, tag, hw=janalyze.HW)
                == jreport.dryrun_table(rows, tag))
    assert report.roofline_table(rows) == jreport.roofline_table(rows)


def test_report_names_the_h100_capacity():
    head = report.dryrun_table([_row()], "single").splitlines()[0]
    assert f"fits {HW['hbm_bytes'] / 1024**3:.3g}GB" in head


def test_report_main_prints_three_sections(tmp_path, capsys):
    import json
    (tmp_path / "a.json").write_text(json.dumps(_row()))
    report.main([str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("## ") == 3 and "test-arch" in out


def test_collective_kinds():
    for name, kind in [("_c10d_functional::all_gather_into_tensor",
                        "all-gather"),
                       ("_c10d_functional::all_reduce", "all-reduce"),
                       ("_c10d_functional::reduce_scatter_tensor",
                        "reduce-scatter"),
                       ("_c10d_functional::all_to_all_single", "all-to-all"),
                       ("_dtensor::shard_dim_alltoall", "all-to-all"),
                       ("c10d::send", "collective-permute"),
                       ("c10d::recv_", "collective-permute"),
                       ("_c10d_functional::wait_tensor", None),
                       ("aten::mm", None)]:
        assert collective_kind(name) == kind, name


def test_collective_bytes_of_a_dtensor_program():
    """On a fake 16×16 mesh (a ``"cuda"`` mesh over meta tensors): an
    all-gather, an all-reduce, a reduce-scatter and an all-to-all, each
    one device's output bytes, all-reduce weighted twice."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.dryrun import CommRecord
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    def dt(shape, placements):
        return DTensor.from_local(torch.empty(shape, device="meta"), mesh,
                                  placements, run_check=False)

    with fake_world(256):
        mesh = make_production_mesh()
        with CommRecord() as rec:
            dt((4, 32), [Shard(0), Replicate()]).redistribute(
                mesh, [Replicate(), Replicate()])              # 64·32·4
            p = dt((64, 32), [Replicate(), Partial()])
            p.redistribute(mesh, [Replicate(), Replicate()])  # 64·32·4
            p.redistribute(mesh, [Replicate(), Shard(0)])     # 4·32·4
            dt((4, 32), [Shard(0), Replicate()]).redistribute(
                mesh, [Shard(1), Replicate()])                 # 64·2·4
    got = collective_bytes(rec.collectives)
    assert got["bytes_by_kind"] == {"all-gather": 8192, "all-reduce": 8192,
                                    "reduce-scatter": 512, "all-to-all": 512,
                                    "collective-permute": 0}
    assert got["count_by_kind"] == {"all-gather": 1, "all-reduce": 1,
                                    "reduce-scatter": 1, "all-to-all": 1,
                                    "collective-permute": 0}
    assert got["weighted_bytes"] == 8192 + 2 * 8192 + 512 + 512
    assert collective_bytes([("c10d::send", 40)])["bytes_by_kind"][
        "collective-permute"] == 40


@pytest.mark.parametrize("arch,shape,kw", [
    ("mamba2-130m", "train_4k", dict(global_batch=4, seq_len=32)),
    ("qwen2-1.5b", "decode_32k", dict(global_batch=4, seq_len=32)),
])
def test_calibrated_flops_equal_the_direct_count(arch, shape, kw):
    """The port counts every op as it runs, so the calibrated extrapolation
    ``OUT + n_mb·(MB + L·LY)`` from the three probes must equal the direct
    count of the whole cell (smoke widths, 6 layers, the plain path on a
    one-device mesh) within float rounding (1e-9 relative)."""
    import dataclasses

    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.roofline.calibrate import calibrate_cell

    smoke = get_config(arch).smoke()
    over = {**{f.name: getattr(smoke, f.name)
               for f in dataclasses.fields(smoke)}, "n_layers": 6}
    with fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        cal = calibrate_cell(arch, shape, mesh, microbatches=2, direct=True,
                             cfg_overrides=over, device="cpu", **kw)
    want = cal["direct"]["flops"]
    assert want > 0
    assert math.isclose(cal["flops"], want, rel_tol=1e-9)
    assert cal["flops"] == pytest.approx(
        cal["flops_outside"] + cal["n_mb"] * (
            cal["flops_mb_fixed"] + 6 * cal["flops_layer"]), rel=1e-12)
