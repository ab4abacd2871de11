"""Guards of the PyTorch port's package boundary.

``repro_torch`` (the dry run and the roofline among it),
``chip_smoke.py`` and the port's scripts of kernel tiles
(``scripts/flash_d256_tiles.py``, ``radix_ssd_tiles.py``,
``flash_bwd_tiles.py``, ``train_scan_tiles.py``) and of the ops' cost
(``scripts/op_overhead.py``) import ``torch`` and
numpy, never ``jax`` and nothing of the JAX package ``repro`` (whose name
``repro_torch`` shares a prefix, so the checks compare whole dotted names).
Its entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

_ROOT = Path(__file__).resolve().parent.parent
_PORT_FILES = sorted((_ROOT / "src" / "repro_torch").rglob("*.py")) + [
    _ROOT / "chip_smoke.py"] + [
    _ROOT / "scripts" / f"{name}_tiles.py"
    for name in ("flash_d256", "radix_ssd", "flash_bwd", "train_scan")] + [
    _ROOT / "scripts" / "op_overhead.py"]


def _forbidden(module: str) -> bool:
    """Whether a dotted module name is jax or the JAX package."""
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value


def test_forbidden_names_tell_repro_from_repro_torch():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("repro") and _forbidden("repro.io")
    assert not _forbidden("repro_torch")
    assert not _forbidden("repro_torch.core.context")


@pytest.mark.parametrize("path", _PORT_FILES,
                         ids=lambda p: str(p.relative_to(_ROOT)))
def test_port_source_imports_no_jax_and_no_repro(path):
    bad = [f"{path.name}:{line}: {mod}" for line, mod in _imports(path)
           if _forbidden(mod)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch.pems_apps.psrs, repro_torch.interop\n"
        "import repro_torch.pems_apps.prefix_sum\n"
        "import repro_torch.pems_apps.list_ranking\n"
        "import repro_torch.pems_apps.euler_tour\n"
        "import repro_torch.launch.serve, repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.ssd_scan, repro_torch.kernels.lru_scan\n"
        "import repro_torch.core.mesh, repro_torch.core.analysis\n"
        "import repro_torch.io, repro_torch.core.backing\n"
        "import repro_torch.core.recovery, repro_torch.checkpoint\n"
        "import repro_torch.io.npyio, repro_torch.io.faults\n"
        "import repro_torch.io.sanitize, repro_torch.io.checksum\n"
        "import repro_torch.obs, repro_torch.obs.__main__\n"
        "import repro_torch.launch.train, repro_torch.train\n"
        "import repro_torch.optim, repro_torch.data, repro_torch.tree\n"
        "repro_torch.io.open_file, repro_torch.io.save_npy_durable\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT / "src")] + [p for p in
                                env.get("PYTHONPATH", "").split(os.pathsep)
                                if p])
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=str(_ROOT))
    assert r.returncode == 0, r.stdout + r.stderr


def test_the_analysis_modules_load_no_jax_and_no_repro():
    """The dry run, the meshes, the sharding rules and the roofline
    (analysis, report, calibration) import neither jax nor the JAX package,
    and importing them creates no process group."""
    code = (
        "import sys\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.mesh\n"
        "import repro_torch.distributed, repro_torch.distributed.sharding\n"
        "import repro_torch.roofline, repro_torch.roofline.report\n"
        "import repro_torch.roofline.calibrate\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT / "src")] + [p for p in
                                env.get("PYTHONPATH", "").split(os.pathsep)
                                if p])
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=str(_ROOT))
    assert r.returncode == 0, r.stdout + r.stderr


def test_every_jax_module_has_a_port_counterpart():
    """Each module of ``src/repro`` has one of the same path in
    ``src/repro_torch``, but ``lint/`` (the lint runs over all of ``src``)
    and ``io/drivers.py`` (the port's drivers live in
    ``core/backing.py``)."""
    jax_root, port_root = _ROOT / "src" / "repro", _ROOT / "src" / "repro_torch"
    missing = [str(p.relative_to(jax_root)) for p in jax_root.rglob("*.py")
               if p.relative_to(jax_root).parts[0] != "lint"
               and p.relative_to(jax_root).as_posix() != "io/drivers.py"
               and not (port_root / p.relative_to(jax_root)).exists()]
    assert not missing, missing


# The JAX package's public names whose port counterpart has another name
# (``module:name`` -> the port's name in its module of the same path).
_RENAMED = {
    "distributed/sharding.py:param_pspecs": "param_placements",
    "distributed/sharding.py:opt_pspecs": "opt_placements",
    "distributed/sharding.py:cache_pspec": "cache_placements",
    "distributed/sharding.py:batch_specs_sharded": "batch_placements",
    "distributed/__init__.py:param_pspecs": "param_placements",
    "distributed/__init__.py:cache_pspec": "cache_placements",
    "distributed/__init__.py:batch_specs_sharded": "batch_placements",
    "launch/mesh.py:make_mesh_auto": "make_mesh",
    # The port makes the weights when it builds the model, from its seed.
    "models/model.py:Model.init": "Model.__init__",
}
# JAX modules whose names the port keeps in another module.
_MODULES = {"io/drivers.py": "core/backing.py"}
# What the port has no counterpart of, and why (a module's path ending in
# ``/`` covers the package).
_NOT_PORTED = {
    "lint/": "the lint rules check both packages' sources (scripts/"
             "pems_lint.py over src); the port needs no copy of them",
    "core/context.py:ContextStore.tree_flatten":
        "pytree registration (jax.tree_util); torch has no pytrees",
    "core/context.py:ContextStore.tree_unflatten":
        "pytree registration (jax.tree_util); torch has no pytrees",
    "kernels/alltoallv_deliver/ops.py:uses_pallas":
        "chooses Pallas or XLA; the port's wrappers choose by the "
        "tensor's device",
    "kernels/alltoallv_deliver/__init__.py:uses_pallas":
        "chooses Pallas or XLA; the port's wrappers choose by the "
        "tensor's device",
    "kernels/alltoallv_deliver/alltoallv_deliver.py:LANE_TILE":
        "the TPU's 128-lane tile of the Pallas grid; the CUDA kernel "
        "tiles by warps",
}


def _public_names(path: Path, defined_only: bool) -> set:
    """A module's public top-level functions, classes, their public
    methods and upper-case constants; with ``defined_only`` false, also
    every other name it binds at the top level (imports, assignments)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name.startswith("_") and defined_only:
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{f.name}" for f in node.body
                           if isinstance(f, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
                           and (not f.name.startswith("_")
                                or not defined_only))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out.update(t.id for t in targets if isinstance(t, ast.Name)
                       and (not defined_only
                            or (t.id.isupper() and t.id[0] != "_")))
        elif isinstance(node, ast.ImportFrom) and not defined_only:
            out.update(a.asname or a.name for a in node.names)
    return out


def _all_names(path: Path) -> set:
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return set(ast.literal_eval(node.value))
    return set()


def _not_ported(rel: str, name: str) -> bool:
    return any(f"{rel}:{name}" == k or (k.endswith("/") and rel.startswith(k))
               for k in _NOT_PORTED)


def test_every_public_jax_name_has_a_port_counterpart():
    """Each public top-level function, class, public method and upper-case
    constant of each ``src/repro`` module (parsed, never imported), and
    each name in a JAX ``__all__``, has a counterpart of the same name in
    the port's module of the same path (or of ``_MODULES``), but those on
    the lists above, each with the port's name or the reason it has none.
    Every entry of the lists is still needed, and each renamed counterpart
    exists."""
    jax_root, port_root = _ROOT / "src" / "repro", _ROOT / "src" / "repro_torch"
    missing, used = [], set()
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        port = port_root / _MODULES.get(rel, rel)
        have = (_public_names(port, False) | _all_names(port)
                if port.exists() else set())
        want = {(n, "name") for n in _public_names(path, True)} | {
            (n, "__all__") for n in _all_names(path)}
        for name, kind in sorted(want):
            key = f"{rel}:{name}"
            if _not_ported(rel, name):
                used.add(next(k for k in _NOT_PORTED
                              if k == key or rel.startswith(k)))
                continue
            port_name = _RENAMED.get(key, name)
            if key in _RENAMED:
                used.add(key)
            ok = (port_name in have if kind == "name"
                  else port_name in _all_names(port))
            if not ok:
                missing.append(f"{key} ({kind}) -> {port_name}")
    assert not missing, missing
    assert used == set(_RENAMED) | set(_NOT_PORTED), (
        "stale entries", (set(_RENAMED) | set(_NOT_PORTED)) - used)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.core import ContextLayout, Pems, PemsConfig, make_mesh
    from repro_torch.pems_apps import (euler_tour, list_rank, prefix_sum,
                                       psrs_plan, psrs_sort)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(4)
    keys = torch.arange(64, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        psrs_sort(keys, v=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        psrs_plan(4, 16)
    lo = ContextLayout().add("x", (4,), torch.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Pems(PemsConfig(v=4), lo)
    for app, arg in ((prefix_sum, keys), (list_rank, keys),
                     (euler_tour, torch.zeros(8, dtype=torch.int64))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            app(arg, v=4)
    out = psrs_sort(keys.flip(0), v=4, device="cpu")
    assert out.device.type == "cpu"
    assert torch.equal(out, keys)
    out = prefix_sum(torch.ones(64, dtype=torch.int32), v=4, device="cpu")
    assert out.device.type == "cpu"
    assert torch.equal(out, keys + 1)
    out = list_rank(torch.minimum(keys + 1, keys[-1]), v=4, device="cpu")
    assert out.device.type == "cpu"
    assert torch.equal(out, keys.flip(0))
    tour = euler_tour(torch.tensor([0, 0, 1, 2]), v=4, device="cpu")
    assert all(t.device.type == "cpu" for t in tour.values())
    assert tour["rank"][[2, 4, 6, 7, 5, 3]].tolist() == [5, 4, 3, 2, 1, 0]
    from repro_torch.data import DataConfig, synthetic_batch
    dcfg = DataConfig(seq_len=8, global_batch=2, vocab=16, frontend="frames",
                      d_model=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthetic_batch(dcfg, 0)
    batch = synthetic_batch(dcfg, 0, device="cpu")
    assert all(t.device.type == "cpu" for t in batch.values())
    from repro_torch.launch import train
    argv = ["--arch", "hubert-xlarge", "--smoke", "--steps", "1", "--seq",
            "8", "--batch", "2"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(argv)
    state = train.main(argv + ["--device", "cpu"])
    assert all(p.device.type == "cpu" for p in state.params["layers"][0]
               ["attn"].values())


@pytest.mark.parametrize("knob, value, item", [
    ("checksums", True, "item 6"),
    ("fault_spec", "eio@1", "item 6"),
    ("P", 2, "item 7"),
    ("alpha", 1, "item 7"),
    ("trace_path", "run.json", "item 9"),
])
def test_knobs_outside_the_slice_raise_and_name_their_roadmap_item(
        knob, value, item):
    """The knobs of ROADMAP.md items 6, 7 and 9, which once raised
    ``NotImplementedError`` naming their item, are ported.  Items 6
    (recovery) and 9 (tracing): their knobs misused on the device tier
    (``trace_path`` without ``trace``) raise the JAX package's own
    ``ValueError``.  Item 7 (``P > 1``), over a mesh of cards too (7b): a
    mesh of cards that does not start on the executor's device raises the
    mesh-mismatch ``ValueError``, and on a one-device mesh the knob
    sorts."""
    from repro_torch.core import Mesh, make_mesh
    from repro_torch.pems_apps import psrs_sort

    keys = torch.arange(64, dtype=torch.int32)
    kw = {knob: value}
    if item in ("item 6", "item 9"):
        from _jax_ref import apps
        with pytest.raises(ValueError) as port:
            psrs_sort(keys, v=4, device="cpu", **kw)
        with pytest.raises(ValueError) as ref:
            apps.psrs_sort(keys.numpy(), v=4, **kw)
        assert str(port.value) == str(ref.value)
        return
    assert item == "item 7"
    kw.update(P=2, mesh=Mesh(["cuda:0", "cuda:1"]))
    with pytest.raises(ValueError, match="lies on cuda:0"):
        psrs_sort(keys, v=4, device="cpu", **kw)
    kw.update(mesh=make_mesh(2, device="cpu"))
    assert torch.equal(psrs_sort(keys.flip(0), v=4, device="cpu", **kw),
                       keys)


@pytest.mark.parametrize("kw", [
    dict(io_driver="sanitize:buffered"),
    dict(io_driver="faulty:buffered", fault_spec="eio@1"),
    dict(checksums=True),
], ids=["sanitize-wrapper", "faulty-wrapper", "checksums"])
def test_backing_tier_recovery_knobs_name_item_6(tmp_path, kw):
    """The recovery knobs of ROADMAP.md queue 1 item 6 run on the file
    tier: the sorted keys and every ledger counter equal the JAX
    package's, and so do the backing file's bytes (and its checksum
    sidecar's)."""
    from _jax_ref import apps
    from repro_torch.pems_apps import psrs_sort

    keys = np.random.default_rng(3).integers(-2**31, 2**31 - 1, 1024,
                                             dtype=np.int32)
    jpath, tpath = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jout, jpems = apps.psrs_sort(keys, v=4, k=2, tier="file",
                                 backing_path=jpath, return_pems=True, **kw)
    tout, tpems = psrs_sort(torch.from_numpy(keys), v=4, k=2, tier="file",
                            backing_path=tpath, device="cpu",
                            return_pems=True, **kw)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tout.numpy(), np.sort(keys))
    assert tpems.ledger.snapshot() == jpems.ledger.snapshot()
    assert tpems.backing.file.driver == jpems.backing.file.driver
    for suffix in ("", ".crc") if kw.get("checksums") else ("",):
        with open(jpath + suffix, "rb") as f, open(tpath + suffix, "rb") as g:
            assert f.read() == g.read(), suffix
