"""Elastic checkpoints of the port (``repro_torch.checkpoint``) against the
JAX package's (``tests/test_elastic.py``): a state restored onto another
layout by ``placements=`` (a device, or a ``(DeviceMesh, [Placement, ...])``
pair, JAX's ``shardings=``), saved from DTensors over several processes.

Worlds of ``gloo`` processes (``torch.multiprocessing``, a ``FileStore``
rendezvous; the ranks in ``tests/_elastic_worker.py``) and the JAX package
in subprocesses over host devices run once for the module, side by side:

* a world of 4 saves the JAX test's ``[16, 4]`` leaf from a DTensor sharded
  by rows, which JAX restores under 2 devices;
* JAX saves the same leaf sharded over 8 devices, which a world of 2
  restores by rows, each rank's shard bit for bit its rows;
* the world of 4 saves steps from DTensors (a bf16 leaf sharded by
  columns among them), corrupts the newest, fails the next on one rank
  alone and passes bad placements;
* qwen2-1.5b's smoke train state, laid out by ``param_placements`` and
  ``opt_placements`` through ``shardings_for`` over ``(data 1, model 4)``,
  saved and restored over ``(data 1, model 2)`` from a ``meta`` like.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager

_ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-1.5b"

# The JAX package's side, as tests/test_elastic.py writes it: save the
# [16, 4] leaf sharded over n host devices, or restore it sharded over n.
_JAX = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.checkpoint import CheckpointManager
    from repro.launch.mesh import make_mesh_auto

    mgr = CheckpointManager({d!r})
    mesh = make_mesh_auto(({n},), ("data",))
    sh = NamedSharding(mesh, P("data", None))
    if {save}:
        w = jax.device_put(jnp.arange(64, dtype=jnp.float32).reshape(16, 4),
                           sh)
        mgr.save(7, {{"w": w}})
        print("SAVED", len(jax.devices()))
    else:
        step, st = mgr.restore_latest(like={{"w": jnp.zeros((16, 4))}},
                                      shardings={{"w": sh}})
        assert step == 7
        assert len(st["w"].addressable_shards) == {n}
        np.testing.assert_array_equal(
            np.asarray(st["w"]).ravel(), np.arange(64, dtype=np.float32))
        print("RESTORED", len(jax.devices()))
""")


def _jax(n: int, d: Path, save: bool) -> subprocess.Popen:
    env = {"PYTHONPATH": str(_ROOT / "src"),
           "PATH": os.environ.get("PATH", ""),
           "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")}
    return subprocess.Popen(
        [sys.executable, "-c", _JAX.format(n=n, d=str(d), save=save)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(_ROOT))


def _world(tmp: Path, name: str, n: int, tasks: list):
    """Start a world of ``n`` ranks running ``tasks``; returns a function
    that joins it and gives each rank's results."""
    import torch.multiprocessing as mp

    import _elastic_worker
    out = tmp / name
    out.mkdir()
    ctx = mp.spawn(_elastic_worker.run,
                   args=(n, str(tmp / f"{name}.store"), str(out), tasks),
                   nprocs=n, join=False)

    def join():
        while not ctx.join(timeout=120):
            pass
        return [json.loads((out / f"{r}.json").read_text()) for r in range(n)]

    return join


def _finish(proc: subprocess.Popen) -> str:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Everything that needs a world or JAX, once: a world of 4 beside a
    JAX save over 8 devices, then a world of 2 beside a JAX restore over
    2."""
    tmp = tmp_path_factory.mktemp("elastic")
    dirs = {k: tmp / k for k in ("rows", "jax_rows", "steps", "state")}
    jax_save = _jax(8, dirs["jax_rows"], save=True)
    big = _world(tmp, "big", 4, [
        ("save_rows", {"directory": str(dirs["rows"])}),
        ("steps", {"directory": str(dirs["steps"])}),
        ("save_train_state", {"directory": str(dirs["state"]),
                              "arch": ARCH, "seed": 3})])
    got = {"jax_save": _finish(jax_save), "big": big()}
    jax_restore = _jax(2, dirs["rows"], save=False)
    small = _world(tmp, "small", 2, [
        ("restore_rows", {"directory": str(dirs["jax_rows"])}),
        ("restore_train_state", {"directory": str(dirs["state"]),
                                 "arch": ARCH, "seed": 3})])
    got.update(small=small(), jax_restore=_finish(jax_restore), dirs=dirs)
    return got


def test_restore_onto_a_single_device(tmp_path):
    """As ``test_elastic.py::test_restore_with_shardings``: a leaf restored
    by a single-device placement (a device string, a ``torch.device``)
    equals the saved one and sits on that device, also from a ``meta``
    like; a ``meta`` like leaf left without a placement raises."""
    mgr = CheckpointManager(str(tmp_path))
    state = {"w": torch.arange(32, dtype=torch.float32).reshape(4, 8)}
    mgr.save(1, state)
    for place, like in (("cpu", state), (torch.device("cpu"), state),
                        ("cpu", {"w": torch.empty((4, 8), device="meta")})):
        got = mgr.restore_latest(like=like, placements={"w": place})
        assert got is not None
        step, restored = got
        assert step == 1 and restored["w"].device == torch.device("cpu")
        assert torch.equal(restored["w"], state["w"])
    # Restored onto meta the leaf would hold no data: that raises.
    meta = {"w": torch.empty((4, 8), device="meta")}
    for where in (None, {"w": None}, {"w": "meta"}):
        with pytest.raises(ValueError, match="no data"):
            mgr.restore_latest(like=meta, placements=where)
        with pytest.raises(ValueError, match="no data"):
            mgr.restore(1, like=meta, placements=where)


class _Mesh:
    """A one-dim mesh as ``_checked`` reads it; ``distribute_tensor`` fails
    on it, as on a mesh whose process group is gone."""
    ndim = 1
    device_type = "cpu"


def test_a_bad_placement_raises_and_does_not_fall_back(tmp_path):
    """A placement naming a card this host lacks, a ``Shard`` dim past the
    leaf's, a nest that does not follow the state and a value that is no
    placement raise ValueError, where a corrupt step would fall back; a
    placement that fails while the leaf is placed raises PlacementError
    and does not fall back to the step before."""
    from torch.distributed.tensor import Shard

    from repro_torch.checkpoint import PlacementError
    mgr = CheckpointManager(str(tmp_path))
    state = {"w": torch.ones(4, 2), "b": [torch.zeros(3)]}
    mgr.save(1, state)
    missing = f"cuda:{torch.cuda.device_count()}"
    for bad in ({"w": missing, "b": [None]}, {"w": None},
                {"w": None, "b": None, "x": None}, {"w": 3, "b": [None]},
                {"w": None, "b": [None, None]},
                {"w": (_Mesh(), [Shard(2)]), "b": [None]},
                {"w": None, "b": [(_Mesh(), [Shard(-2)])]}):
        with pytest.raises(ValueError):
            mgr.restore_latest(like=state, placements=bad)
        with pytest.raises(ValueError):
            mgr.restore(1, like=state, placements=bad)
    with pytest.raises(ValueError):
        mgr.restore_latest(like=None, placements={"w": "cpu"})
    _, ok = mgr.restore_latest(like=state, placements={"w": "cpu", "b": None})
    assert torch.equal(ok["w"], state["w"])
    mgr.save(2, state)
    with pytest.raises(PlacementError, match=r"\['w'\] of step 2"):
        mgr.restore_latest(like=state,
                           placements={"w": (_Mesh(), [Shard(0)]),
                                       "b": [None]})


def test_jax_sharded_save_restores_into_a_smaller_world(worlds):
    """JAX saves ``[16, 4]`` sharded over 8 devices; a world of 2 restores
    it with ``Shard(0)``: each rank's local shard is its 8 rows, bit for
    bit."""
    assert "SAVED 8" in worlds["jax_save"]
    for rank, r in enumerate(worlds["small"]):
        got = r["restore_rows"]
        assert got["step"] == 7 and got["local_shape"] == [8, 4], (rank, got)
        assert got["equal"], rank


def test_dtensor_save_restores_in_jax_under_fewer_devices(worlds):
    """A world of 4 saves the leaf from a DTensor sharded by rows (each
    rank holding 4 rows); JAX restores it under 2 devices, equal to
    ``arange(64)``."""
    assert [r["save_rows"]["local_rows"] for r in worlds["big"]] == \
        [[4, 4]] * 4
    assert "RESTORED 2" in worlds["jax_restore"]


def test_a_dtensor_leaf_is_written_whole(worlds):
    """The checkpoint of a row-sharded DTensor holds the whole ``[16, 4]``
    leaf, not one rank's shard; the steps' bf16 leaf sharded by columns is
    whole too ([6, 8] as uint16 bits)."""
    d = worlds["dirs"]["rows"] / f"step_{7:012d}"
    manifest = json.loads((d / "manifest.json").read_text())
    assert [a["shape"] for a in manifest["arrays"]] == [[16, 4]]
    w = np.load(d / manifest["arrays"][0]["file"])
    np.testing.assert_array_equal(w, np.arange(64, dtype=np.float32
                                               ).reshape(16, 4))
    steps = worlds["dirs"]["steps"] / f"step_{1:012d}"
    m = json.loads((steps / "manifest.json").read_text())
    assert {a["key"]: (a["shape"], a["dtype"]) for a in m["arrays"]} == {
        "['b']": ([6, 8], "uint16"), "['n']": ([3], "int64"),
        "['s']": ([], "int32"), "['w']": ([16, 4], "float32")}


def test_only_rank_0_writes_and_no_rank_returns_before_the_commit(worlds):
    """Over a world of 4, rank 0 writes every array and the others none;
    every rank finds each step committed once ``save`` (blocking) or
    ``wait`` (after a non-blocking save) returns."""
    written = [r["steps"]["arrays_written"] for r in worlds["big"]]
    assert written == [3 * 4, 0, 0, 0]
    assert all(r["steps"]["committed"] == [True] * 3 for r in worlds["big"])


def test_one_directory_and_one_manifest_a_step(worlds):
    """Four ranks saving the same steps leave one committed directory a
    step, one manifest in it, and no staging directory."""
    d = worlds["dirs"]["steps"]
    assert sorted(os.listdir(d)) == [f"step_{s:012d}" for s in (1, 2, 3)]
    for s in (1, 2, 3):
        files = sorted(os.listdir(d / f"step_{s:012d}"))
        assert files == ["arr_00000.npy", "arr_00001.npy", "arr_00002.npy",
                         "arr_00003.npy", "manifest.json"], files


def test_every_rank_restores_the_same_step(worlds):
    """With the newest step corrupted every rank falls back to step 2; with
    step 2 failing on rank 1 alone every rank falls back to step 1; each
    restored shard is its slice of that step's state."""
    for r in worlds["big"]:
        assert r["steps"]["after_corrupt"] == [2, True]
        assert r["steps"]["after_one_rank_fails"] == [1, True]


def test_a_bad_placement_raises_on_every_rank(worlds):
    """A card missing on one rank, placements of the wrong length and a
    ``Shard`` dim past the leaf's on every rank raise ValueError on every
    rank; a leaf that fails to be placed on one rank alone raises on every
    rank (PlacementError there, RuntimeError on the others).  No rank hangs
    or falls back."""
    for rank, r in enumerate(worlds["big"]):
        for case in ("one_rank_missing_card", "every_rank_short_placements",
                     "every_rank_shard_dim_past_the_leaf"):
            assert r["steps"][case].startswith("ValueError"), (case, r)
        want = "PlacementError" if rank == 2 else "RuntimeError"
        assert r["steps"]["one_rank_fails_to_place"].startswith(want), r


def test_train_state_restores_onto_another_layout(worlds):
    """qwen2-1.5b's smoke train state saved over ``(data 1, model 4)`` by
    ``shardings_for`` of ``param_placements``/``opt_placements`` restores
    over ``(data 1, model 2)`` from a ``meta`` like: every local shard is
    bit for bit its slice of the state rebuilt from the seed."""
    saved = worlds["big"][0]["save_train_state"]
    assert saved["sharded_leaves"] > 0
    for r in worlds["small"]:
        got = r["restore_train_state"]
        assert got["step"] == 5 and got["leaves"] == saved["leaves"]
        assert got["all_equal"]
        # Model 2 shards every leaf model 4 did, and those of dims that 2
        # divides and 4 does not.
        assert got["sharded_leaves"] == got["placed_sharded"] >= \
            saved["sharded_leaves"]


def test_shardings_for_follows_the_specs():
    """``shardings_for`` keeps the nest (dicts, lists, namedtuples, None)
    and turns each spec into ``(mesh, to_placements(mesh, spec))``."""
    import collections

    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import ShardingRules, shardings_for

    class Mesh:     # the two attributes to_placements reads
        ndim = 2
        mesh_dim_names = ("data", "model")

    mesh = Mesh()
    Pair = collections.namedtuple("Pair", "a b")
    specs = {"x": ("model", None), "y": [(None, ("data", "model")), ()],
             "z": Pair(a=("data",), b=None)}
    got = shardings_for(ShardingRules(mesh=mesh), specs)
    assert got["x"] == (mesh, [Replicate(), Shard(0)])
    assert got["y"] == [(mesh, [Shard(1), Shard(1)]),
                        (mesh, [Replicate(), Replicate()])]
    assert isinstance(got["z"], Pair) and got["z"].b is None
    assert got["z"].a == (mesh, [Shard(0), Replicate()])
