"""The port's ``allgather``, ``reduce`` and ``allreduce`` against the JAX
package, on the CPU.

Each case loads the same numpy-seeded store words into ``repro`` (the JAX
reference, ``tests/_jax_ref.py``) and ``repro_torch`` and holds them equal
after every call: integer fields (int32, and uint32 with values past 2^31)
bit for bit, sums that overflow included; float32 fields within a relative
1e-6 (the two packages may add in another order); and every ``IOLedger``
counter of ``snapshot()``.  Covered: the device tier at ``P == 1`` and, with
the JAX side in a subprocess of four host devices as in
``tests/test_torch_mesh.py``, at ``P == 4`` on a one-device mesh; the host,
memmap and file tiers with ``procs=`` subsets, where a tiered reduction
equals the port's device tier bit for bit, float32 too; the tiered
``allgather`` staging one row; and the JAX package's errors.
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

from _jax_ref import core as jcore, jnp
import repro_torch.core as tcore
from repro_torch import interop
from repro_torch.core import ContextLayout, Pems, PemsConfig, make_mesh

_ROOT = Path(__file__).resolve().parent.parent
V, N = 16, 6
DTYPES = {"int32": (torch.int32, np.int32), "uint32": (torch.uint32,
                                                       np.uint32),
          "float32": (torch.float32, np.float32)}
OPS = ("add", "max", "min")
# (name, shape): every field takes the case's dtype.
_FIELDS = [("x", (N,)), ("o", (N,)), ("g", (V, N))]


def _layout(dtype: str):
    """The JAX package's layout of :data:`_FIELDS` in ``dtype``."""
    lo = jcore.ContextLayout()
    for name, shape in _FIELDS:
        lo.add(name, shape, jnp.dtype(dtype))
    return lo


def _port_layout(dtype: str) -> ContextLayout:
    lo = ContextLayout()
    for name, shape in _FIELDS:
        lo.add(name, shape, DTYPES[dtype][0])
    return lo


def _vals(dtype: str, seed: int = 0) -> np.ndarray:
    """``[V, N]`` values of ``x``: full-range int32 and uint32 (most sums of
    16 leave 32 bits and wrap), a uint32 column past 2^31, finite
    float32."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-2**31, 2**31, (V, N), dtype=np.int64).astype(
            np.int32)
    if dtype == "uint32":
        x = rng.integers(0, 2**32, (V, N), dtype=np.uint64)
        x[:, 1] = rng.integers(2**31, 2**32, V)
        return x.astype(np.uint32)
    return rng.standard_normal((V, N)).astype(np.float32)


def _words(dtype: str, seed: int = 0) -> np.ndarray:
    """The initial ``[V, words]`` store words: ``x`` from :func:`_vals`,
    random bits in ``o`` and ``g`` (whatever a call leaves untouched must
    stay)."""
    lo = _layout(dtype)
    rng = np.random.default_rng(seed + 100)
    w = rng.integers(0, 2**32, (V, lo.words), dtype=np.uint64).astype(
        np.uint32)
    if dtype == "float32":                     # finite floats everywhere
        w[:] = rng.standard_normal(w.shape).astype(np.float32).view(
            np.uint32)
    off = lo.offset("x")
    w[:, off:off + N] = _vals(dtype, seed).view(np.uint32)
    return w


def _field(words: np.ndarray, lo, name: str, dtype: str) -> np.ndarray:
    off, n = lo.offset(name), lo.field_words(name)
    return words[:, off:off + n].view(DTYPES[dtype][1])


def _assert_words(got: np.ndarray, want: np.ndarray, dtype: str) -> None:
    """Store words equal: integer fields bit for bit, float32 within a
    relative 1e-6."""
    lo = _layout(dtype)
    for name, _ in _FIELDS:
        a, b = (_field(w, lo, name, dtype) for w in (got, want))
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _reference(op: str, vals: np.ndarray) -> np.ndarray:
    """The plain reduction over axis 0: integer sums wrap at 32 bits."""
    if op == "add":
        if vals.dtype == np.float32:
            return vals.sum(axis=0, dtype=np.float64).astype(np.float32)
        return vals.astype(np.int64).sum(axis=0).astype(vals.dtype)
    return getattr(vals, op)(axis=0)


def _calls(op: str):
    """The sequence each case runs: (method, args, kwargs)."""
    return [("allgather", ("x", "g"), {}),
            ("reduce", ("x", "o"), dict(op=op, root=3)),
            ("allreduce", ("x", "o"), dict(op=op))]


def _pair(dtype: str, tier: str = "device", P: int = 1, tmp_path=None,
          seed: int = 0):
    """The JAX and port executors and stores over the same words."""
    words = _words(dtype, seed)
    kw = dict(v=V, k=2, P=P, tier=tier)
    jp = jcore.Pems(jcore.PemsConfig(**kw), _layout(dtype))
    tp = Pems(PemsConfig(**kw), _port_layout(dtype), device="cpu")
    if tier == "device":
        js = jcore.ContextStore(jp.layout, jnp.asarray(words))
        ts = interop.store_from_numpy(tp.layout, words, device="cpu")
        return jp, js, tp, ts
    paths = [None, None] if tier == "host" else [
        str(tmp_path / "j.bin"), str(tmp_path / "t.bin")]
    js = jp.init(backing_path=paths[0])
    ts = tp.init(backing_path=paths[1])
    js.backing.write_block(0, V, words)
    ts.load_rows(0, words)
    return jp, js, tp, ts


def _store_words(store) -> np.ndarray:
    """The store's ``[V, words]`` uint32 words, any tier and package."""
    if hasattr(store, "backing"):
        return store.backing.read_block(0, V)
    if isinstance(store.data, torch.Tensor):
        return interop.store_to_numpy(store)
    return np.asarray(store.data)


# --------------------------------------------------------------------------- #
# The device tier, P == 1                                                      #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_collectives_match_jax_and_the_plain_reduction(dtype, op):
    jp, js, tp, ts = _pair(dtype)
    vals = _vals(dtype)
    for name, args, kw in _calls(op):
        js = getattr(jp, name)(js, *args, **kw)
        ts = getattr(tp, name)(ts, *args, **kw)
        assert ts.data.dtype == torch.int32
        _assert_words(_store_words(ts), _store_words(js), dtype)
        assert tp.ledger.snapshot() == jp.ledger.snapshot(), name
        if name == "allgather":
            for r in range(V):
                np.testing.assert_array_equal(ts.field("g")[r].numpy(), vals)
        else:
            want = _reference(op, vals)
            rows = ts.field("o").numpy()
            got = rows[3] if name == "reduce" else rows
            if dtype == "float32":
                np.testing.assert_allclose(got, np.broadcast_to(
                    want, got.shape), rtol=1e-6)
            else:
                np.testing.assert_array_equal(got, np.broadcast_to(
                    want, got.shape))


def test_collective_errors_match_jax():
    jp, js, tp, ts = _pair("float32")
    with pytest.raises(ValueError) as port:
        tp.reduce(ts, "x", "o", op="sub")
    with pytest.raises(ValueError) as ref:
        jp.reduce(js, "x", "o", op="sub")
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="unsupported reduce op"):
        tp.allreduce(ts, "x", "o", op="mul")
    for name, args, kw in _calls("add"):
        with pytest.raises(ValueError) as port:
            getattr(tp, name)(ts, *args, procs=[0], **kw)
        with pytest.raises(ValueError) as ref:
            getattr(jp, name)(js, *args, procs=[0], **kw)
        assert str(port.value) == str(ref.value)


# --------------------------------------------------------------------------- #
# The backing tiers                                                            #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("tier", ["host", "memmap", "file"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tiered_collectives_match_jax_and_the_device_tier(tmp_path, tier,
                                                          dtype):
    """Every op on a backing tier: the words and every ledger counter
    equal the JAX package's, and the words equal the port's device tier
    bit for bit, float32 sums too (the reduction runs on the device)."""
    _, _, dp, ds = _pair(dtype, seed=1)
    jp, js, tp, ts = _pair(dtype, tier, tmp_path=tmp_path, seed=1)
    for op in OPS:
        for name, args, kw in _calls(op):
            js = getattr(jp, name)(js, *args, **kw)
            getattr(tp, name)(ts, *args, **kw)
            getattr(dp, name)(ds, *args, **kw)
            got = _store_words(ts)
            _assert_words(got, _store_words(js), dtype)
            np.testing.assert_array_equal(got, _store_words(ds))
    assert tp.ledger.snapshot() == jp.ledger.snapshot()
    assert tp.tier_stats.peak_stage_bytes == jp.tier_stats.peak_stage_bytes


@pytest.mark.parametrize("tier", ["host", "memmap"])
@pytest.mark.parametrize("P, procs", [(1, [0]), (2, [1]), (4, [0, 2])])
@pytest.mark.parametrize("root", [3, 12])
def test_tiered_collectives_with_procs_match_jax(tmp_path, tier, P, procs,
                                                 root):
    """``procs=`` writes the listed processes' shards alone: the root row
    only when its shard is listed, the gathered and reduced rows only into
    the listed shards; the words, every shard's ledger and stats equal the
    JAX package's."""
    jp, js, tp, ts = _pair("uint32", tier, P=P, tmp_path=tmp_path, seed=2)
    before = _store_words(ts).copy()
    for name, args, kw in _calls("max"):
        if name == "reduce":
            kw = dict(kw, root=root)
        js = getattr(jp, name)(js, *args, procs=procs, **kw)
        getattr(tp, name)(ts, *args, procs=procs, **kw)
        np.testing.assert_array_equal(_store_words(ts), _store_words(js))
    assert ([led.snapshot() for led in tp.shard_ledgers]
            == [led.snapshot() for led in jp.shard_ledgers])
    assert ([s.peak_stage_bytes for s in tp.shard_stats]
            == [s.peak_stage_bytes for s in jp.shard_stats])
    m = V // P
    rows = set(np.flatnonzero((_store_words(ts) != before).any(axis=1)))
    assert rows <= {r for p in procs for r in range(p * m, (p + 1) * m)}


def test_tiered_allgather_stages_one_row():
    """The tiered allgather stages only the gathered [v, ω] row, never the
    [v, v·ω] broadcast (``tests/test_backing_tier.py``'s case, in the
    port, beside the JAX package)."""
    v = 8
    vals = np.arange(v * 4).reshape(v, 4).astype(np.int32)
    peaks = []
    for pkg, dt, dev in ((jcore, jnp.int32, {}),
                         (tcore, torch.int32, dict(device="cpu"))):
        lo = pkg.ContextLayout().add("x", (4,), dt).add("gath", (v, 4), dt)
        pems = pkg.Pems(pkg.PemsConfig(v=v, k=2, tier="host"), lo, **dev)
        st = pems.allgather(pems.init().with_field("x", vals), "x", "gath")
        for r in range(v):
            np.testing.assert_array_equal(np.asarray(st.field("gath"))[r],
                                          vals)
        peaks.append(pems.tier_stats.peak_stage_bytes)
    assert peaks == [v * 4 * 4] * 2


# --------------------------------------------------------------------------- #
# The device tier at P == 4 (the JAX side in a subprocess)                     #
# --------------------------------------------------------------------------- #

_JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import _jax_ref as R
    R.enable_mesh()
    jax, jnp, core = R.jax, R.jnp, R.core

    d = sys.argv[1]
    spec = json.load(open(os.path.join(d, "spec.json")))
    inp = np.load(os.path.join(d, "inputs.npz"))
    res = {}
    for dtype in spec["dtypes"]:
        for op in spec["ops"]:
            lo = core.ContextLayout()
            for name, shape in spec["fields"]:
                lo.add(name, tuple(shape), jnp.dtype(dtype))
            p = core.Pems(core.PemsConfig(v=spec["V"], k=2, P=4), lo,
                          mesh=R.auto_mesh(4))
            st = p.init()
            st = core.ContextStore(st.layout, jax.device_put(
                jnp.asarray(inp[dtype]), st.data.sharding))
            for i, (name, args, kw) in enumerate(spec["calls"][op]):
                st = getattr(p, name)(st, *args, **kw)
                res[f"{dtype}/{op}/{i}"] = R.store_words(st)
            res[f"{dtype}/{op}/ledger"] = np.array(
                json.dumps(p.ledger.snapshot()))
    np.savez(os.path.join(d, "jax.npz"), **res)
    print("JAX_MESH_OK")
""")


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_coll_mesh")
    spec = {"V": V, "fields": _FIELDS, "dtypes": list(DTYPES), "ops": OPS,
            "calls": {op: _calls(op) for op in OPS}}
    (d / "spec.json").write_text(json.dumps(spec))
    np.savez(d / "inputs.npz", **{dt: _words(dt, 3) for dt in DTYPES})
    env = {"PYTHONPATH": os.pathsep.join([str(_ROOT / "src"),
                                          str(_ROOT / "tests")]),
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           # Without an explicit platform jax probes for TPUs through the
           # cloud metadata URL and stalls for minutes.
           "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")}
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d)],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=str(_ROOT))
    assert "JAX_MESH_OK" in r.stdout, r.stderr[-3000:]
    with np.load(d / "jax.npz") as z:
        return {key: z[key] for key in z.files}


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_collectives_at_P4_match_jax(jax_mesh, dtype, op):
    """At ``P == 4`` on a one-device mesh: the words after each call equal
    the JAX package's over four devices, and the ledger too, whose network
    terms (the allgather's Alltoallv shape, ⌈log₂ P⌉ tree levels a
    reduction) are the only ones that differ from ``P == 1``."""
    pems = Pems(PemsConfig(v=V, k=2, P=4), _port_layout(dtype),
                mesh=make_mesh(4, device="cpu"), device="cpu")
    store = interop.store_from_numpy(pems.layout, _words(dtype, 3),
                                     device="cpu")
    for i, (name, args, kw) in enumerate(_calls(op)):
        store = getattr(pems, name)(store, *args, **kw)
        _assert_words(interop.store_to_numpy(store),
                      jax_mesh[f"{dtype}/{op}/{i}"], dtype)
    want = json.loads(str(jax_mesh[f"{dtype}/{op}/ledger"]))
    assert pems.ledger.snapshot() == want
    nb = pems.layout.field_bytes("o")
    assert pems.ledger.network == (V * (V - V // 4)
                                   * pems.layout.field_bytes("x")
                                   + 2 * 2 * nb)
