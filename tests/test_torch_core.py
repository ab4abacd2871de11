"""Parity of the port's executor and collectives (``repro_torch.core``) with
the JAX package's on the device tier at ``P == 1``: the same store words after
every call, bit for bit, and the same ``IOLedger`` counters.

A JAX stage function runs per context (``fn(rho, ctx)`` under ``vmap``); the
port's takes the round's ``k`` contexts at once (``fn(rhos, ctx)``).  Each
case below writes the same arithmetic both ways.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _jax_ref import core as jcore, jnp, store_words
from repro_torch import interop
from repro_torch.core import ContextLayout, IOLedger, Mesh, Pems, PemsConfig

V = 4


# (name, shape, kind): kind i/f/u is int32/float32/uint32.
_FIELDS = [("a", (5,), "i"), ("b", (3,), "f"), ("c", (2,), "u"),
           ("d", (5,), "i"),
           ("send", (V, 3), "i"), ("recv", (V, 3), "i"),
           ("fsend", (V, 3), "f"), ("frecv", (V, 3), "f"),
           ("scnt", (V,), "i"), ("rcnt", (V,), "i"), ("rcnt_f", (V,), "f"),
           ("root_in", (2,), "i"), ("root_out", (V, 2), "f")]


def _layouts():
    dt = {"i": (jnp.int32, torch.int32), "f": (jnp.float32, torch.float32),
          "u": (jnp.uint32, torch.uint32)}
    jl, tl = jcore.ContextLayout(), ContextLayout()
    for name, shape, kind in _FIELDS:
        jl.add(name, shape, dt[kind][0])
        tl.add(name, shape, dt[kind][1])
    return jl, tl


def _pair(driver="explicit", k=2, seed=0):
    """The same random store on both sides, counts words in ``[-1, ω + 1]``
    so that masks see empty, partial, full and out-of-range counts."""
    jl, tl = _layouts()
    words = np.random.default_rng(seed).integers(
        0, 2**32, size=(V, jl.words), dtype=np.uint64).astype(np.uint32)
    off = jl.offset("scnt")
    words[:, off:off + V] = np.random.default_rng(seed + 1).integers(
        -1, 5, size=(V, V)).astype(np.int32).view(np.uint32)
    off = jl.offset("b")                          # finite float32 payloads
    words[:, off:off + 3] = np.float32(
        np.random.default_rng(seed + 2).standard_normal((V, 3))).view(
        np.uint32)
    jp = jcore.Pems(jcore.PemsConfig(v=V, k=k, driver=driver), jl)
    tp = Pems(PemsConfig(v=V, k=k, driver=driver), tl, device="cpu")
    js = jcore.ContextStore(jl, jnp.asarray(words))
    ts = interop.store_from_numpy(tl, words, device="cpu")
    return jp, js, tp, ts


def _check(jp, js, tp, ts):
    np.testing.assert_array_equal(interop.store_to_numpy(ts), store_words(js))
    assert tp.ledger.snapshot() == jp.ledger.snapshot()


# --------------------------------------------------------------------------- #
# Executor                                                                     #
# --------------------------------------------------------------------------- #

def _jax_stage(rho, ctx):
    a = ctx.get("a") * 3 + rho + ctx.get("c").astype(jnp.int32).sum()
    b = ctx.get("b") * 2.0
    # "c" is not declared as read below: the sliced driver shows it as zero.
    # "d" is set but not declared as written: sliced drops it.
    return ctx.set("a", a).set("b", b).set("d", jnp.full((5,), rho + 100))


def _torch_stage(rhos, ctx):
    c = ctx.get("c").view(torch.int32).sum(dim=1, dtype=torch.int32)
    a = ctx.get("a") * 3 + rhos[:, None] + c[:, None]
    b = ctx.get("b") * 2.0
    return (ctx.set("a", a).set("b", b)
            .set("d", (rhos + 100)[:, None].expand(ctx.k, 5)))


@pytest.mark.parametrize("driver", ["explicit", "sliced", "async"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_superstep_drivers_match_jax(driver, k):
    jp, js, tp, ts = _pair(driver, k, seed=k)
    before = interop.store_to_numpy(ts).copy()
    js = jp.superstep(js, _jax_stage, reads=["a", "b"], writes=["a", "b"])
    ts = tp.superstep(ts, _torch_stage, reads=["a", "b"], writes=["a", "b"])
    _check(jp, js, tp, ts)
    after = interop.store_to_numpy(ts)
    lo = tp.layout
    d = slice(lo.offset("d"), lo.offset("d") + 5)
    if driver == "sliced":
        # Undeclared reads are zero-filled, undeclared writes never land.
        np.testing.assert_array_equal(after[:, d], before[:, d])
        a_off = lo.offset("a")
        a0 = before[:, a_off:a_off + 5].view(np.int32)
        rho = np.arange(V, dtype=np.int32)[:, None]
        np.testing.assert_array_equal(
            after[:, a_off:a_off + 5].view(np.int32), a0 * 3 + rho)
    else:
        np.testing.assert_array_equal(
            after[:, d].view(np.int32),
            np.repeat(np.arange(100, 100 + V, dtype=np.int32)[:, None], 5, 1))


def test_superstep_without_declarations_swaps_everything_under_sliced():
    jp, js, tp, ts = _pair("sliced", 2, seed=9)
    js = jp.superstep(js, _jax_stage)
    ts = tp.superstep(ts, _torch_stage)
    _check(jp, js, tp, ts)


def test_executor_rejects_what_jax_rejects():
    _, tl = _layouts()
    with pytest.raises(ValueError, match="unknown driver"):
        PemsConfig(v=4, driver="nope")
    with pytest.raises(ValueError, match="unknown tier"):
        PemsConfig(v=4, tier="tape")
    with pytest.raises(ValueError, match="v/P must be divisible by k"):
        PemsConfig(v=4, k=3)
    with pytest.raises(ValueError, match="merge_tile"):
        PemsConfig(v=4, merge_tile=6)
    with pytest.raises(ValueError, match="device_cap_bytes"):
        Pems(PemsConfig(v=4, device_cap_bytes=8), tl, device="cpu")
    p = Pems(PemsConfig(v=4), tl, device="cpu")
    st = p.init()
    with pytest.raises(ValueError, match="procs"):
        p.superstep(st, _torch_stage, procs=[0])
    # A backing tier runs (ROADMAP.md queue 1 item 5): the store lives in
    # host memory and its fields come back as CPU tensors.
    st = p.init(tier="host")
    assert st.tier == "host" and st.field("a").shape == (4, 5)
    # P > 1 runs on a one-device mesh or a mesh of cards; a mesh of cards
    # must start on the executor's device, whatever its axis name.
    with pytest.raises(ValueError, match="lies on cuda:0 but the executor"):
        Pems(PemsConfig(v=4, P=2), tl, mesh=Mesh(["cuda:0", "cuda:1"]),
             device="cpu")
    with pytest.raises(ValueError, match="lies on cuda:0 but the executor"):
        Pems(PemsConfig(v=4, P=2, vp_axis="procs"), tl,
             mesh=Mesh(["cuda:0", "cuda:1"], ("procs",)), device="cpu")


def test_pems_ledger_requires_the_jax_disk_space():
    jl, tl = _layouts()
    jp = jcore.Pems(jcore.PemsConfig(v=8, k=2), jl)
    tp = Pems(PemsConfig(v=8, k=2), tl, device="cpu")
    assert tp.ledger.snapshot() == jp.ledger.snapshot()
    assert isinstance(tp.ledger, IOLedger)


# --------------------------------------------------------------------------- #
# Collectives                                                                  #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("mode, use_kernel", [
    ("direct", True), ("direct", False), ("indirect", True)])
@pytest.mark.parametrize("fill", [None, 2**31 - 1])
@pytest.mark.parametrize("recv_counts", ["rcnt", "rcnt_f"])
def test_alltoallv_matches_jax(mode, use_kernel, fill, recv_counts):
    jp, js, tp, ts = _pair(seed=3)
    kw = dict(send_counts="scnt", recv_counts=recv_counts, mode=mode,
              fill=fill, use_kernel=use_kernel)
    js = jp.alltoallv(js, "send", "recv", **kw)
    ts = tp.alltoallv(ts, "send", "recv", **kw)
    _check(jp, js, tp, ts)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_alltoallv_float_payload_without_counts_and_in_place(use_kernel):
    jp, js, tp, ts = _pair(seed=4)
    js = jp.alltoallv(js, "fsend", "frecv", use_kernel=use_kernel)
    ts = tp.alltoallv(ts, "fsend", "frecv", use_kernel=use_kernel)
    _check(jp, js, tp, ts)
    # send == recv: delivery must read every message before overwriting it.
    kw = dict(send_counts="scnt", recv_counts="scnt", fill=-3,
              use_kernel=use_kernel)
    js = jp.alltoallv(js, "send", "send", **kw)
    ts = tp.alltoallv(ts, "send", "send", **kw)
    _check(jp, js, tp, ts)


def test_alltoallv_rejects_what_jax_rejects():
    _, _, tp, ts = _pair()
    with pytest.raises(ValueError, match="unknown mode"):
        tp.alltoallv(ts, "send", "recv", mode="carrier-pigeon")
    with pytest.raises(ValueError, match="fill requires"):
        tp.alltoallv(ts, "send", "recv", fill=0)
    with pytest.raises(ValueError, match="out of range"):
        tp.alltoallv(ts, "send", "recv", "scnt", "rcnt", fill=2**31)
    with pytest.raises(ValueError, match="shapes must match"):
        tp.alltoallv(ts, "send", "a")
    with pytest.raises(ValueError, match="backing-tier"):
        tp.alltoallv(ts, "send", "recv", procs=[0])


@pytest.mark.parametrize("root", [0, 3])
def test_bcast_and_gather_match_jax(root):
    jp, js, tp, ts = _pair(seed=5)
    js = jp.bcast(js, "a", root=root)
    ts = tp.bcast(ts, "a", root=root)
    _check(jp, js, tp, ts)
    js = jp.gather(js, "root_in", "root_out", root=root)
    ts = tp.gather(ts, "root_in", "root_out", root=root)
    _check(jp, js, tp, ts)
    with pytest.raises(ValueError, match="recv must be"):
        tp.gather(ts, "a", "root_out")
