"""The port's ``P > 1`` slice against the JAX package, bit for bit.

``repro_torch`` runs ``P`` real processors as row blocks of one store on a
one-device :class:`~repro_torch.core.Mesh` (``make_mesh(P, device="cpu")``
here).  The JAX package runs them over a ``P``-device mesh, which needs
several host devices: XLA reads that count only before jax starts, and a
pytest worker has started it, so the whole JAX side of this module runs in
one subprocess (``--xla_force_host_platform_device_count=4``, the mesh shims
of ``tests/_jax_ref.py``).  A module-scoped fixture writes the inputs and the
case list, the subprocess writes every JAX result into an ``.npz`` beside
them, and each test reads its case from there.  The results are kept for
the test session in a directory every pytest worker shares, under a lock:
``tests/test_torch_mesh_cards.py`` (the mesh of cards, forced onto CPU
blocks) reads the same results, and the subprocess runs once a session.

Covered: ``alltoallv`` at P = 4, v = 16, k = 2 over α ∈ {None, 1, 2} ×
``use_kernel`` × (no counts | counts | counts + fill | float payload with
float recv counts | in place, send == recv); the fused route at P = 2 and
4 and with PSRS's exchange fields at odd word offsets, landing without a
``Mesh.all_to_all`` call; ``bcast`` and ``gather``;
``psrs_sort`` at P ∈ {2, 4} × k ∈ {1, 2} × the three drivers × α ∈ {None, 1}
× direct/indirect on random and duplicate-heavy keys (output equal to
``np.sort`` and to the port's ``P == 1`` run, the network terms and rounds
equal to the closed forms of the port's ``analysis``, and the full ledger
snapshot equal to JAX's for the ten configurations the JAX side runs); a
JAX ``P = 4`` store carried into the port after ``partition``; and the
errors.

Each JAX run compiles for seconds, so the JAX side runs a covering subset,
about a minute in all.  Its results do not depend on ``alpha`` or on its
kernel route (its own ``test_multiprocessor_alltoallv_subprocess`` holds
both), and its ledger does not depend on the keys or on the Alltoallv's
counts, fill and payload: so every Alltoallv variant runs there unchunked,
and the chunked runs take the fill variant only.
"""

from __future__ import annotations

import fcntl
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import ContextLayout, Mesh, Pems, PemsConfig, \
    analysis, make_mesh
from repro_torch.pems_apps import psrs_plan, psrs_sort

_ROOT = Path(__file__).resolve().parent.parent
V, K, P4 = 16, 2, 4
INT_MIN, INT_MAX = -2**31, 2**31 - 1

# (name, shape, kind): kind i/f is int32/float32.
_FIELDS = [("a", (5,), "i"),
           ("send", (V, 3), "i"), ("recv", (V, 3), "i"),
           ("fsend", (V, 3), "f"), ("frecv", (V, 3), "f"),
           ("scnt", (V,), "i"), ("rcnt", (V,), "i"), ("rcnt_f", (V,), "f"),
           ("root_in", (2,), "i"), ("root_out", (V, 2), "f")]

_VARIANTS = {
    "plain": dict(send="send", recv="recv"),
    "counts": dict(send="send", recv="recv", send_counts="scnt",
                   recv_counts="rcnt"),
    "fill": dict(send="send", recv="recv", send_counts="scnt",
                 recv_counts="rcnt", fill=-7),
    "float": dict(send="fsend", recv="frecv", send_counts="scnt",
                  recv_counts="rcnt_f", fill=-7.5),
    "in_place": dict(send="send", recv="send", send_counts="scnt",
                     recv_counts="scnt", fill=-3),
}
_ALPHAS = [None, 1, 2]
# PSRS's exchange fields at odd word offsets (bsend 3, brecv 85, bscnt 165,
# brcnt 181) and an odd row of 197 words, ω = 5.
_ODD_FIELDS = [("pad", (3,), "i"), ("bsend", (V, 5), "i"), ("gap", (2,), "i"),
               ("brecv", (V, 5), "i"), ("bscnt", (V,), "i"),
               ("brcnt", (V,), "i")]
_ODD = dict(send="bsend", recv="brecv", send_counts="bscnt",
            recv_counts="brcnt", fill=INT_MAX)

# PSRS configurations (P, k, driver, alpha, mode) the JAX side runs: every
# value of every axis, and every driver at P = 4 with and without alpha.
_JAX_PSRS = [
    (4, 2, "explicit", None, "direct"), (4, 2, "explicit", 1, "indirect"),
    (4, 2, "sliced", None, "indirect"), (4, 2, "sliced", 1, "direct"),
    (4, 2, "async", None, "direct"), (4, 2, "async", 1, "direct"),
    (4, 1, "explicit", 1, "direct"), (4, 1, "async", None, "indirect"),
    (2, 1, "explicit", None, "direct"), (2, 2, "sliced", None, "indirect"),
]
N_V = 64                                    # PSRS keys per context
# PSRS runs whose final store the JAX side keeps, (P, k, alpha), on random
# keys: every stage's words, which depend on the keys and v only.
_JAX_STORES = [(4, 2, None), (2, 1, 1)]
# allgather, reduce and allreduce: (name, shape, kind) of their fields, and
# the calls, (method, args, keywords).
_COLL_FIELDS = [("xf", (3,), "f"), ("xi", (3,), "i"), ("allf", (V, 3), "f"),
                ("sumf", (3,), "f"), ("maxi", (3,), "i"), ("sumi", (3,), "i"),
                ("mini", (3,), "i"), ("allsum", (3,), "f")]
_COLL_CALLS = [("allgather", ("xf", "allf"), {}),
               ("reduce", ("xf", "sumf"), {"op": "add", "root": 5}),
               ("reduce", ("xi", "maxi"), {"op": "max", "root": 13}),
               ("allreduce", ("xi", "sumi"), {"op": "add"}),
               ("allreduce", ("xi", "mini"), {"op": "min"}),
               ("allreduce", ("xf", "allsum"), {"op": "add"})]


def _words(fields=None):
    """The initial store words of the collective cases: random bits,
    counts words in ``[-1, ω + 1]`` (empty, partial, full and out-of-range
    masks) and finite float payloads; for ``_ODD_FIELDS`` counts in
    ``[-1, ω + 2]``; for ``_COLL_FIELDS`` finite float operands."""
    if fields is _COLL_FIELDS:
        lo = _layout(fields)
        rng = np.random.default_rng(17)
        w = rng.integers(0, 2**32, size=(V, lo.words),
                         dtype=np.uint64).astype(np.uint32)
        off = lo.offset("xf")
        w[:, off:off + 3] = np.float32(
            rng.standard_normal((V, 3)) * 1000).view(np.uint32)
        return w
    if fields is not None:
        lo = _layout(fields)
        rng = np.random.default_rng(13)
        w = rng.integers(0, 2**32, size=(V, lo.words),
                         dtype=np.uint64).astype(np.uint32)
        off = lo.offset("bscnt")
        w[:, off:off + V] = rng.integers(-1, 8, size=(V, V)).astype(
            np.int32).view(np.uint32)
        return w
    lo = _layout()
    rng = np.random.default_rng(11)
    w = rng.integers(0, 2**32, size=(V, lo.words),
                     dtype=np.uint64).astype(np.uint32)
    off = lo.offset("scnt")
    w[:, off:off + V] = rng.integers(-1, 5, size=(V, V)).astype(
        np.int32).view(np.uint32)
    for name in ("fsend", "a"):
        off, n = lo.offset(name), lo.field_words(name)
        w[:, off:off + n] = np.float32(
            rng.standard_normal((V, n))).view(np.uint32)
    return w


def _layout(fields=_FIELDS):
    dt = {"i": torch.int32, "f": torch.float32}
    lo = ContextLayout()
    for name, shape, kind in fields:
        lo.add(name, shape, dt[kind])
    return lo


def _keys(kind):
    rng = np.random.default_rng(5)
    n = V * N_V
    if kind == "random":
        x = rng.integers(INT_MIN, INT_MAX, size=n, endpoint=True,
                         dtype=np.int64)
    else:                                    # duplicate-heavy
        x = rng.integers(0, 3, size=n)
    return np.ascontiguousarray(x.astype(np.int32))


# --------------------------------------------------------------------------- #
# The JAX side, in one subprocess                                              #
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

    def layout(fields):
        dt = {"i": jnp.int32, "f": jnp.float32}
        lo = core.ContextLayout()
        for name, shape, kind in fields:
            lo.add(name, tuple(shape), dt[kind])
        return lo

    def pems(alpha=None, P=4, odd=False, coll=False):
        name = "odd" if odd else "coll" if coll else ""
        p = core.Pems(core.PemsConfig(v=spec["V"], k=spec["K"], P=P,
                                      alpha=alpha),
                      layout(spec[name + "_fields" if name else "fields"]),
                      mesh=R.auto_mesh(P))
        st = p.init()
        st = core.ContextStore(st.layout, jax.device_put(
            jnp.asarray(inp[name + "_words" if name else "words"]),
            st.data.sharding))
        return p, st

    def keep(tag, p, st):
        res[tag + "/words"] = R.store_words(st)
        res[tag + "/ledger"] = np.array(json.dumps(p.ledger.snapshot()))

    for alpha in spec["alphas"]:
        for name, kw in spec["variants"].items():
            if alpha is None or name == "fill":
                p, st = pems(alpha)
                st = p.alltoallv(st, use_kernel=False, **kw)
                keep(f"a2a/{alpha}/{name}", p, st)
    p, st = pems()
    st = p.alltoallv(st, use_kernel=True, **spec["variants"]["fill"])
    keep("a2a/kernel", p, st)
    for alpha in spec["alphas"]:
        p, st = pems(alpha, P=2)
        st = p.alltoallv(st, use_kernel=False, **spec["variants"]["fill"])
        keep(f"a2a_P2/{alpha}/fill", p, st)
        p, st = pems(alpha, odd=True)
        st = p.alltoallv(st, use_kernel=False, **spec["odd"])
        keep(f"a2a_odd/{alpha}", p, st)

    p, st = pems()
    st = p.bcast(st, "a", root=5)
    st = p.gather(st, "root_in", "root_out", root=13)
    keep("rooted", p, st)
    p, st = pems(coll=True)
    for method, args, kw in spec["coll_calls"]:
        st = getattr(p, method)(st, *args, **kw)
    keep("coll", p, st)

    keys = inp["keys_random"]
    for P, k, driver, alpha, mode in spec["psrs"]:
        out, led = R.psrs(keys, v=spec["V"], k=k, P=P, driver=driver,
                          alpha=alpha, mode=mode, mesh=R.auto_mesh(P),
                          use_kernel=False)
        tag = f"psrs/{P}/{k}/{driver}/{alpha}/{mode}"
        res[tag + "/out"] = out
        res[tag + "/ledger"] = np.array(json.dumps(led))

    keys = inp["keys_random"]
    n_v = keys.size // spec["V"]
    for P, k, alpha in spec["stores"]:
        p, load, steps, _ = R.apps.psrs_plan(
            spec["V"], n_v, k=k, P=P, alpha=alpha, mesh=R.auto_mesh(P),
            use_kernel=False)
        st = load(jnp.asarray(keys.reshape(spec["V"], n_v)))
        for name, step in steps:
            st = step(st)
        res[f"store/{P}/{k}/{alpha}"] = R.store_words(st)

    # A P = 4 store taken after partition, and the same run's end.
    keys = inp["keys_dups"]
    n_v = keys.size // spec["V"]
    p, load, steps, _ = R.apps.psrs_plan(
        spec["V"], n_v, k=2, P=4, alpha=1, mesh=R.auto_mesh(4),
        use_kernel=False)
    st = load(jnp.asarray(keys.reshape(spec["V"], n_v)))
    for name, step in steps:
        st = step(st)
        if name == "partition":
            res["carry/partition"] = R.store_words(st)
    res["carry/merge"] = R.store_words(st)
    np.savez(os.path.join(d, "jax.npz"), **res)
    print("JAX_MESH_OK")
""")


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    """Every JAX result, from one subprocess a test session: the first
    module to ask runs it, under a lock in a directory every pytest worker
    shares (the parent of a worker's base temp directory), and every other
    reads its ``.npz``."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    d = base / "jax_mesh"
    with open(base / "jax_mesh.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / "jax.npz").exists():
            _run_jax_side(d)
        with np.load(d / "jax.npz") as z:
            return {key: z[key] for key in z.files}


def _run_jax_side(d: Path) -> None:
    d.mkdir(exist_ok=True)
    spec = {"V": V, "K": K, "fields": _FIELDS, "alphas": _ALPHAS,
            "variants": _VARIANTS, "psrs": _JAX_PSRS,
            "odd_fields": _ODD_FIELDS, "odd": _ODD,
            "coll_fields": _COLL_FIELDS, "coll_calls": _COLL_CALLS,
            "stores": _JAX_STORES}
    (d / "spec.json").write_text(json.dumps(spec))
    np.savez(d / "inputs.npz", words=_words(),
             odd_words=_words(_ODD_FIELDS),
             coll_words=_words(_COLL_FIELDS),
             keys_random=_keys("random"), keys_dups=_keys("dups"))
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


def _ledger(ref, tag):
    return json.loads(str(ref[tag + "/ledger"]))


def _store(words, fields=_FIELDS):
    return interop.store_from_numpy(_layout(fields), words, device="cpu")


def _pems(P=P4, k=K, fields=_FIELDS, **kw):
    return Pems(PemsConfig(v=V, k=k, P=P, **kw), _layout(fields),
                mesh=make_mesh(P, device="cpu"), device="cpu")


# --------------------------------------------------------------------------- #
# Collectives                                                                  #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("variant", list(_VARIANTS))
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("alpha", _ALPHAS)
@pytest.mark.parametrize("k", [1, K])
def test_alltoallv_at_P4_matches_jax(jax_mesh, k, alpha, use_kernel,
                                     variant):
    """Every word after the call equals JAX's; at k = 1 and 2 (< m = 4) a
    chunk's landing off by one process or round would show."""
    pems = _pems(k=k, alpha=alpha)
    store = pems.alltoallv(_store(_words()), use_kernel=use_kernel,
                           **_VARIANTS[variant])
    # Payload, transposed counts and every other word, bit for bit.
    got = interop.store_to_numpy(store)
    np.testing.assert_array_equal(got, jax_mesh[f"a2a/None/{variant}/words"])
    if variant == "fill":
        np.testing.assert_array_equal(got, jax_mesh[f"a2a/{alpha}/fill/words"])
    if k == K:                                 # the JAX side runs k = 2
        assert pems.ledger.snapshot() == _ledger(jax_mesh,
                                                 f"a2a/{alpha}/fill")
    m, omega_b = V // P4, 3 * 4
    assert pems.ledger.network_rounds == (
        analysis.pems2_alltoallv_par_network_rounds(V, P4, k, alpha))
    assert pems.ledger.network == V * (V - m) * omega_b
    assert pems.ledger.io_total == analysis.pems2_alltoallv_par_io_exact(
        V, P4, k, pems.layout.live_bytes, omega_b, pems.cfg.block_bytes)


def test_alltoallv_kernel_route_matches_jax_kernel_route(jax_mesh):
    """The JAX package's own fused mesh route (its staging kernel's
    vectorised twin on the CPU) against the port's."""
    pems = _pems()
    store = pems.alltoallv(_store(_words()), **_VARIANTS["fill"])
    np.testing.assert_array_equal(interop.store_to_numpy(store),
                                  jax_mesh["a2a/kernel/words"])
    assert pems.ledger.snapshot() == _ledger(jax_mesh, "a2a/kernel")


@pytest.fixture
def exchanges(monkeypatch):
    """The calls of ``Mesh.all_to_all`` while the test runs."""
    calls = []
    ship = Mesh.all_to_all

    def counted(self, send, recv):
        calls.append(tuple(send.shape))
        ship(self, send, recv)

    monkeypatch.setattr(Mesh, "all_to_all", counted)
    return calls


@pytest.mark.parametrize("alpha", _ALPHAS)
@pytest.mark.parametrize("P", [2, P4])
def test_fused_alltoallv_on_one_device_lands_without_an_exchange(
        jax_mesh, exchanges, P, alpha):
    """On a one-device mesh the staging kernel lands every chunk in the
    receivers' rows: no ``Mesh.all_to_all`` call, and the words and the
    ledger (network rounds included) equal JAX's."""
    pems = _pems(P=P, alpha=alpha)
    store = pems.alltoallv(_store(_words()), **_VARIANTS["fill"])
    assert exchanges == []
    tag = f"a2a/{alpha}/fill" if P == P4 else f"a2a_P2/{alpha}/fill"
    np.testing.assert_array_equal(interop.store_to_numpy(store),
                                  jax_mesh[tag + "/words"])
    assert pems.ledger.snapshot() == _ledger(jax_mesh, tag)
    assert pems.ledger.network_rounds == (
        analysis.pems2_alltoallv_par_network_rounds(V, P, K, alpha))
    # The dense route still transposes through the exchange.
    _pems(P=P, alpha=alpha).alltoallv(_store(_words()), use_kernel=False,
                                      **_VARIANTS["fill"])
    assert exchanges


@pytest.mark.parametrize("alpha", _ALPHAS)
def test_fused_alltoallv_at_odd_word_offsets_matches_jax(jax_mesh, exchanges,
                                                        alpha):
    """PSRS's exchange fields at odd word offsets of an odd-length row: the
    landing reads and writes each message at its own word phase."""
    pems = _pems(fields=_ODD_FIELDS, alpha=alpha)
    lo = pems.layout
    assert [lo.offset(f) % 2 for f in ("bsend", "brecv", "bscnt", "brcnt")] \
        == [1, 1, 1, 1] and lo.words % 2 == 1
    store = pems.alltoallv(_store(_words(_ODD_FIELDS), _ODD_FIELDS), **_ODD)
    assert exchanges == []
    np.testing.assert_array_equal(interop.store_to_numpy(store),
                                  jax_mesh[f"a2a_odd/{alpha}/words"])
    assert pems.ledger.snapshot() == _ledger(jax_mesh, f"a2a_odd/{alpha}")


def test_bcast_and_gather_at_P4_match_jax(jax_mesh):
    pems = _pems()
    store = pems.bcast(_store(_words()), "a", root=5)
    store = pems.gather(store, "root_in", "root_out", root=13)
    np.testing.assert_array_equal(interop.store_to_numpy(store),
                                  jax_mesh["rooted/words"])
    assert pems.ledger.snapshot() == _ledger(jax_mesh, "rooted")
    lo = pems.layout
    assert pems.ledger.network == ((P4 - 1) * lo.field_bytes("a")
                                   + (V - V // P4) * lo.field_bytes("root_in"))


# --------------------------------------------------------------------------- #
# PSRS                                                                         #
# --------------------------------------------------------------------------- #

_P1 = {}


def _p1(kind):
    """The port's own ``P == 1`` output on the same keys."""
    if kind not in _P1:
        _P1[kind] = psrs_sort(torch.from_numpy(_keys(kind)), v=V, k=K,
                              device="cpu").numpy()
    return _P1[kind]


@pytest.mark.parametrize("keys", ["random", "dups"])
@pytest.mark.parametrize("mode", ["direct", "indirect"])
@pytest.mark.parametrize("alpha", [None, 1])
@pytest.mark.parametrize("driver", ["explicit", "sliced", "async"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("P", [2, 4])
def test_psrs_over_P_processors_matches_jax_and_P1(jax_mesh, P, k, driver,
                                                   alpha, mode, keys):
    x = _keys(keys)
    out, pems = psrs_sort(torch.from_numpy(x), v=V, k=k, P=P,
                          mesh=make_mesh(P, device="cpu"), alpha=alpha,
                          driver=driver, mode=mode, device="cpu",
                          return_pems=True)
    out = out.numpy()
    np.testing.assert_array_equal(out, np.sort(x))
    np.testing.assert_array_equal(out, _p1(keys))
    # The network terms: Alltoallv's v(v-m)ω (twice when indirect), the
    # splitters' bcast and the samples' gather.
    led, lo, m = pems.ledger, pems.layout, V // P
    hops = 1 if mode == "direct" else 2
    assert led.network == (hops * V * (V - m) * lo.field_bytes("bsend") // V
                           + (P - 1) * lo.field_bytes("gsplit")
                           + (V - m) * lo.field_bytes("samp"))
    assert led.network_rounds == (
        analysis.pems2_alltoallv_par_network_rounds(V, P, k, alpha)
        if mode == "direct" else 0)
    tag = f"psrs/{P}/{k}/{driver}/{alpha}/{mode}"
    if tag + "/ledger" in jax_mesh:
        assert led.snapshot() == _ledger(jax_mesh, tag)
        np.testing.assert_array_equal(jax_mesh[tag + "/out"],
                                      np.sort(_keys("random")))


def test_jax_P4_store_carries_over_after_partition(jax_mesh):
    """A JAX ``P = 4`` store (``np.asarray`` of the sharded array is the
    global ``[v, words]``) taken after ``partition`` finishes in the port's
    ``P = 4`` plan with the JAX run's final words."""
    x = _keys("dups")
    pems, _, steps, _ = psrs_plan(V, x.size // V, k=2, P=4, alpha=1,
                                  mesh=make_mesh(4, device="cpu"),
                                  device="cpu")
    store = interop.store_from_numpy(pems.layout,
                                     jax_mesh["carry/partition"],
                                     device="cpu")
    names = [name for name, _ in steps]
    for _, step in steps[names.index("partition") + 1:]:
        store = step(store)
    np.testing.assert_array_equal(interop.store_to_numpy(store),
                                  jax_mesh["carry/merge"])


# --------------------------------------------------------------------------- #
# Errors                                                                       #
# --------------------------------------------------------------------------- #

def test_P_gt_1_errors_match_jax():
    lo = _layout()
    with pytest.raises(ValueError, match="requires a mesh"):
        Pems(PemsConfig(v=V, k=K, P=4), lo, device="cpu")
    with pytest.raises(ValueError, match="mesh axis vp=2 != P=4"):
        Pems(PemsConfig(v=V, k=K, P=4), lo, mesh=make_mesh(2, device="cpu"),
             device="cpu")
    with pytest.raises(ValueError, match="mesh axis procs=None"):
        Pems(PemsConfig(v=V, k=K, P=4, vp_axis="procs"), lo,
             mesh=make_mesh(4, device="cpu"), device="cpu")
    Pems(PemsConfig(v=V, k=K, P=4, vp_axis="procs"), lo,
         mesh=make_mesh(4, axis="procs", device="cpu"), device="cpu")
    for alpha in (0, -1, V // 4 + 1, 1.5):
        with pytest.raises(ValueError, match="alpha"):
            PemsConfig(v=V, k=K, P=4, alpha=alpha)
    assert PemsConfig(v=V, k=K, P=4, alpha=4.0).alpha == 4
    with pytest.raises(ValueError, match="requires a mesh"):
        psrs_sort(torch.from_numpy(_keys("dups")), v=V, P=2, device="cpu")


def test_mesh_over_two_devices_is_not_ported(monkeypatch):
    """A mesh over several cards (this test once held that it raised): one
    that does not start on the executor's device is refused as a one-device
    mesh is, ``all_to_all`` over cards moves per-card blocks (forced onto
    CPU blocks here), and a mesh naming one device twice beside another is
    refused."""
    mesh = Mesh(["cuda:0", "cuda:1"])
    assert mesh.shape == {"vp": 2} and mesh.spans_devices
    assert not make_mesh(2, device="cpu").spans_devices
    with pytest.raises(ValueError, match="lies on cuda:0 but the executor "
                                         "on cpu"):
        Pems(PemsConfig(v=V, k=K, P=2), _layout(), mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="distinct device each"):
        Mesh(["cuda:0", "cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="lies on meta"):
        Pems(PemsConfig(v=V, k=K, P=2), _layout(),
             mesh=Mesh(["meta", "meta"]), device="cpu")
    monkeypatch.setattr(Mesh, "spans_devices", True)
    cards = make_mesh(3, device="cpu")
    send = [torch.arange(12).reshape(3, 4) + 100 * q for q in range(3)]
    recv = [torch.zeros(3, 4, dtype=torch.int64) for _ in range(3)]
    cards.all_to_all(send, recv)
    for p in range(3):
        for q in range(3):
            assert torch.equal(recv[p][q], send[q][p])
    with pytest.raises(ValueError, match="differ"):
        cards.all_to_all(send, [torch.zeros(3, 5) for _ in range(3)])


def _coll_close(got, want, lo):
    """Every word equal, but the float32 sums' (``sumf``, ``allsum``),
    which torch and XLA may add in another order: within 1e-6."""
    words = np.ones(lo.words, bool)
    for name in ("sumf", "allsum"):
        off = lo.offset(name)
        words[off:off + lo.field_words(name)] = False
        np.testing.assert_allclose(
            got[:, off:off + 3].view(np.float32),
            want[:, off:off + 3].view(np.float32), rtol=1e-6)
    np.testing.assert_array_equal(got[:, words], want[:, words])


def test_allgather_reduce_allreduce_at_P4_match_jax(jax_mesh):
    pems = _pems(fields=_COLL_FIELDS)
    store = _store(_words(_COLL_FIELDS), _COLL_FIELDS)
    for method, args, kw in _COLL_CALLS:
        store = getattr(pems, method)(store, *args, **kw)
    _coll_close(interop.store_to_numpy(store), jax_mesh["coll/words"],
                pems.layout)
    assert pems.ledger.snapshot() == _ledger(jax_mesh, "coll")
