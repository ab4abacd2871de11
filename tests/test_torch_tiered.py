"""The port's backing tiers end to end against the JAX package: PSRS with its
population in host memory, in a memmap file or behind the I/O engine, the
tiered collectives, and stores carried across between the two packages.

Each case runs the same numpy-seeded input through ``repro`` (the JAX
reference, ``tests/_jax_ref.py``) and ``repro_torch`` on the CPU and holds
them equal bit for bit: the sorted keys, the final store words, every
``IOLedger`` counter (the modeled ones and the measured ``h2d``/``d2h``/
``disk_*``/``syscall_*`` bytes, per shard at ``P > 1``) and the
deterministic ``TierStats`` fields.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import pytest
import torch

from _jax_ref import apps, core as jcore, jnp, psrs_plan_run
from repro_torch import interop
from repro_torch.core import ContextLayout, Pems, PemsConfig, TieredStore
from repro_torch.pems_apps import psrs_plan, psrs_sort

V, K, N = 8, 2, 4096
DETERMINISTIC = ("rounds", "merge_prefetch_events", "peak_stage_bytes")


def _keys(seed=0):
    return np.random.default_rng(seed).integers(
        -2**31, 2**31 - 1, size=N, dtype=np.int32)


def _words(backing) -> np.ndarray:
    """The whole population's words, through the block API (any tier)."""
    return backing.read_block(0, backing.v)


def _tier_state(pems):
    """Everything held equal: every ledger (main and per shard) and the
    deterministic stats of every shard."""
    return ([led.snapshot() for led in [pems.ledger] + pems.shard_ledgers],
            [{f: getattr(st, f) for f in DETERMINISTIC}
             for st in pems.shard_stats])


@functools.lru_cache(maxsize=None)
def _jax_run(tier, driver, P, path):
    out, pems = apps.psrs_sort(_keys(), v=V, k=K, P=P, tier=tier,
                               driver=driver, backing_path=path,
                               return_pems=True)
    return np.asarray(out), _words(pems.backing), _tier_state(pems)


def _port_run(tier, driver, P, path, **kw):
    out, pems = psrs_sort(torch.from_numpy(_keys()), v=V, k=K, P=P,
                          tier=tier, driver=driver, backing_path=path,
                          device="cpu", return_pems=True, **kw)
    assert out.device.type == "cpu" and out.dtype == torch.int32
    return out.numpy(), _words(pems.backing), _tier_state(pems), pems


MATRIX = ([(t, d, 1) for t in ("host", "memmap", "file")
           for d in ("explicit", "sliced", "async")]
          + [(t, d, 2) for t in ("host", "file") for d in ("sliced", "async")])


@pytest.mark.parametrize("tier, driver, P", MATRIX)
def test_psrs_on_the_tiers_matches_jax(tmp_path, tier, driver, P):
    jpath = tpath = None
    if tier != "host":
        jpath = str(tmp_path / "jax.bin")
        tpath = str(tmp_path / "port.bin")
    jout, jwords, (jledgers, jstats) = _jax_run(tier, driver, P, jpath)
    tout, twords, (tledgers, tstats), pems = _port_run(tier, driver, P,
                                                       tpath)
    np.testing.assert_array_equal(jout, np.sort(_keys()))
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_array_equal(twords, jwords)
    assert tledgers == jledgers
    assert tstats == jstats
    measured = pems.merged_shard_ledger()
    assert measured.h2d_bytes > 0 and measured.d2h_bytes > 0
    assert (measured.disk_read_bytes > 0) == (tier != "host")
    assert (measured.syscall_read_bytes > 0) == (tier == "file")
    if tier != "host":
        # The bytes on disk are the JAX package's (a shard file a process).
        names = [""] if P == 1 else [f".shard{p}" for p in range(P)]
        for s in names:
            with open(jpath + s, "rb") as f, open(tpath + s, "rb") as g:
                assert f.read() == g.read()


def test_psrs_on_the_tiers_at_p4_bills_the_p1_disk_bytes(tmp_path):
    """The sharding invariant: the per-shard ledgers sum to the P == 1
    run's measured bytes, and the output is the same."""
    one = _port_run("file", "async", 1, str(tmp_path / "a.bin"))
    four = _port_run("file", "async", 4, str(tmp_path / "b.bin"))
    np.testing.assert_array_equal(four[0], one[0])
    np.testing.assert_array_equal(four[1], one[1])
    m1, m4 = one[3].merged_shard_ledger(), four[3].merged_shard_ledger()
    for f in ("h2d_bytes", "d2h_bytes", "disk_read_bytes",
              "disk_write_bytes", "syscall_read_bytes",
              "syscall_write_bytes"):
        assert getattr(m4, f) == getattr(m1, f), f


@pytest.mark.parametrize("io_driver", ["odirect", "mmap"])
def test_psrs_through_each_io_driver_matches_jax(tmp_path, io_driver):
    jout, jpems = apps.psrs_sort(_keys(1), v=V, k=K, tier="file",
                                 driver="sliced", io_driver=io_driver,
                                 backing_path=str(tmp_path / "j.bin"),
                                 return_pems=True)
    tout, tpems = psrs_sort(torch.from_numpy(_keys(1)), v=V, k=K,
                            tier="file", driver="sliced",
                            io_driver=io_driver,
                            backing_path=str(tmp_path / "t.bin"),
                            device="cpu", return_pems=True)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tpems.ledger.snapshot() == jpems.ledger.snapshot()


def test_async_writeback_waits_for_its_buffer(tmp_path):
    """The aliasing hazard of the async file tier: an in-flight writeback
    reads from the (pinned, on the card) buffer it was submitted from until
    it completes.  Every write here is slowed, one request in flight at a
    time over many rounds, so a buffer refilled before its requests
    finished would land the next round's words in the file.
    ``tests/test_torch_gpu.py`` runs it on the card."""
    v, k = 16, 1
    keys = _keys(2)[:v * 64]
    ref = np.sort(keys)
    pems, load, steps, extract = psrs_plan(
        v, 64, k=k, driver="async", tier="file", io_queue_depth=1,
        backing_path=str(tmp_path / "slow.bin"), device="cpu")
    store = load(torch.from_numpy(keys.reshape(v, 64)))
    f = pems.backing.file
    fast = f.pwrite

    def slow(offset, data):
        time.sleep(0.002)
        return fast(offset, data)

    f.pwrite = slow
    for _, step in steps:
        store = step(store)
    result, rcount, oflow = extract(store)
    assert not oflow.any()
    out = torch.cat([result[i, :rcount[i, 0]] for i in range(v)])
    np.testing.assert_array_equal(out.numpy(), ref)
    assert pems.tier_stats.rounds == 4 * v


def test_psrs_tiers_refuse_what_the_cap_cannot_hold(tmp_path):
    # Three k·μ round blocks under the async driver must fit the cap.
    lo = ContextLayout().add("x", (1024,), torch.int32)
    with pytest.raises(ValueError, match="3·k·mu"):
        Pems(PemsConfig(v=8, k=2, tier="host", driver="async",
                        device_cap_bytes=3 * 2 * 4096 - 1), lo, device="cpu")
    Pems(PemsConfig(v=8, k=2, tier="host", driver="async",
                    device_cap_bytes=3 * 2 * 4096), lo, device="cpu")
    # P > 1 on a backing tier needs no mesh; on the device tier it does.
    Pems(PemsConfig(v=8, k=2, P=2, tier="file"), lo, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        Pems(PemsConfig(v=8, k=2, P=2), lo, device="cpu")


# --------------------------------------------------------------------------- #
# Tiered collectives                                                           #
# --------------------------------------------------------------------------- #

W = 5           # ω of the collective layout


def _coll_layout(lo, dt):
    return (lo.add("send", (V, W), dt.int32).add("recv", (V, W), dt.int32)
            .add("scnt", (V,), dt.int32).add("rcnt", (V,), dt.int32)
            .add("x", (3,), dt.float32).add("allx", (V, 3), dt.float32))


def _coll_pair(tier, tmp_path, P=2, alpha=None, cap=None, seed=0, k=2):
    jl = _coll_layout(jcore.ContextLayout(), jnp)
    tl = _coll_layout(ContextLayout(), torch)
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(V, jl.words),
                         dtype=np.uint64).astype(np.uint32)
    off = jl.offset("scnt")
    words[:, off:off + V] = rng.integers(-1, W + 2, size=(V, V)).astype(
        np.int32).view(np.uint32)
    off = jl.offset("x")
    words[:, off:off + 3] = rng.standard_normal((V, 3)).astype(
        np.float32).view(np.uint32)
    kw = dict(v=V, k=k, P=P, tier=tier, alpha=alpha, device_cap_bytes=cap)
    jp = jcore.Pems(jcore.PemsConfig(**kw), jl)
    tp = Pems(PemsConfig(**kw), tl, device="cpu")
    path = None if tier == "host" else str(tmp_path / "j.bin")
    js = jp.init(backing_path=path)
    path = None if tier == "host" else str(tmp_path / "t.bin")
    ts = tp.init(backing_path=path)
    js.backing.write_block(0, V, words)
    ts.load_rows(0, words)
    return jp, js, tp, ts


def _coll_check(jp, js, tp, ts):
    np.testing.assert_array_equal(_words(ts.backing), _words(js.backing))
    assert _tier_state(tp) == _tier_state(jp)


@pytest.mark.parametrize("tier", ["host", "file"])
@pytest.mark.parametrize("alpha", [1, None])
@pytest.mark.parametrize("fill", [None, -7])
def test_tiered_alltoallv_matches_jax(tmp_path, tier, alpha, fill):
    jp, js, tp, ts = _coll_pair(tier, tmp_path, alpha=alpha)
    kw = dict(send_counts="scnt", recv_counts="rcnt", fill=fill)
    js = jp.alltoallv(js, "send", "recv", **kw)
    tp.alltoallv(ts, "send", "recv", **kw)
    _coll_check(jp, js, tp, ts)


@pytest.mark.parametrize("tier", ["memmap", "file"])
def test_tiered_alltoallv_clamps_its_chunks_under_the_cap(tmp_path, tier):
    # The least cap the executor admits (two k·μ round blocks, k = 1) holds
    # fewer destination columns than a process has: the chunks shrink.  The
    # file tier stages a read copy beside each chunk.
    copies = 2 if tier == "file" else 1
    mu = _coll_layout(ContextLayout(), torch).mu_bytes
    cap = 2 * mu
    alpha = cap // (copies * V * W * 4)
    assert 1 <= alpha < V
    jp, js, tp, ts = _coll_pair(tier, tmp_path, P=1, cap=cap, seed=1, k=1)
    js = jp.alltoallv(js, "send", "recv", "scnt", "rcnt", fill=0)
    tp.alltoallv(ts, "send", "recv", "scnt", "rcnt", fill=0)
    _coll_check(jp, js, tp, ts)
    assert tp.tier_stats.peak_stage_bytes == copies * alpha * V * W * 4


def test_tiered_alltoallv_in_place_snapshots_or_refuses(tmp_path):
    jp, js, tp, ts = _coll_pair("host", tmp_path, seed=2)
    js = jp.alltoallv(js, "send", "send", "scnt", "scnt", fill=1)
    tp.alltoallv(ts, "send", "send", "scnt", "scnt", fill=1)
    _coll_check(jp, js, tp, ts)
    # The snapshot alone fills this cap: no room for a chunk beside it.
    jp, js, tp, ts = _coll_pair("host", tmp_path, cap=V * V * W * 4, seed=2,
                                k=1)
    with pytest.raises(ValueError, match="snapshot"):
        jp.alltoallv(js, "send", "send")
    with pytest.raises(ValueError, match="snapshot"):
        tp.alltoallv(ts, "send", "send")


@pytest.mark.parametrize("tier", ["host", "memmap"])
@pytest.mark.parametrize("procs", [None, [1]])
@pytest.mark.parametrize("root", [0, 5])
def test_tiered_bcast_and_gather_match_jax(tmp_path, tier, procs, root):
    jp, js, tp, ts = _coll_pair(tier, tmp_path, seed=3)
    js = jp.bcast(js, "x", root=root, procs=procs)
    tp.bcast(ts, "x", root=root, procs=procs)
    _coll_check(jp, js, tp, ts)
    js = jp.gather(js, "x", "allx", root=root, procs=procs)
    tp.gather(ts, "x", "allx", root=root, procs=procs)
    _coll_check(jp, js, tp, ts)
    jp.alltoallv(js, "send", "recv", procs=procs)
    tp.alltoallv(ts, "send", "recv", procs=procs)
    _coll_check(jp, js, tp, ts)


# --------------------------------------------------------------------------- #
# Carrying state across                                                        #
# --------------------------------------------------------------------------- #

def test_a_jax_memmap_backing_resumes_in_the_port(tmp_path):
    """JAX runs the stages through partition on a memmap backing; the port
    reopens that file by path and finishes: JAX's full run's result."""
    keys = _keys(4)
    path = str(tmp_path / "carry.bin")
    jfull = np.asarray(apps.psrs_sort(keys, v=V, k=K, tier="memmap",
                                      backing_path=str(tmp_path / "f.bin")))
    _, jstore = psrs_plan_run(keys, V, "partition", k=K, tier="memmap",
                              backing_path=path)
    jstore.flush()
    pems, _, steps, extract = psrs_plan(V, N // V, k=K, tier="memmap",
                                        backing_path=path, device="cpu")
    store = pems.init()
    names = [name for name, _ in steps]
    for _, step in steps[names.index("partition") + 1:]:
        store = step(store)
    result, rcount, oflow = extract(store)
    assert not oflow.any()
    out = torch.cat([result[i, :rcount[i, 0]] for i in range(V)])
    np.testing.assert_array_equal(out.numpy(), jfull)


@pytest.mark.parametrize("tier", ["host", "file"])
def test_a_jax_store_carried_into_a_tiered_store_finishes(tmp_path, tier):
    keys = _keys(5)
    _, jstore = psrs_plan_run(keys, V, "bcast_splitters", k=K)
    pems, _, steps, extract = psrs_plan(V, N // V, k=K, tier=tier,
                                        device="cpu")
    path = None if tier == "host" else str(tmp_path / "c.bin")
    store = interop.tiered_store_from_numpy(
        pems.layout, np.asarray(jstore.data), tier, path,
        ledger=pems.ledger)
    assert isinstance(store, TieredStore) and store.tier == tier
    names = [name for name, _ in steps]
    for _, step in steps[names.index("bcast_splitters") + 1:]:
        store = step(store)
    result, rcount, _ = extract(store)
    out = torch.cat([result[i, :rcount[i, 0]] for i in range(V)])
    np.testing.assert_array_equal(out.numpy(), np.sort(keys))


def test_tiered_init_fn_fills_k_contexts_at_a_time(tmp_path):
    lo = ContextLayout().add("a", (3,), torch.int32).add("b", (2,),
                                                         torch.float32)
    jl = (jcore.ContextLayout().add("a", (3,), jnp.int32)
          .add("b", (2,), jnp.float32))
    tp = Pems(PemsConfig(v=V, k=2, tier="memmap"), lo, device="cpu")
    jp = jcore.Pems(jcore.PemsConfig(v=V, k=2, tier="memmap"), jl)
    ts = tp.init(lambda rhos: {"a": rhos[:, None] * 3 + torch.arange(3),
                               "b": rhos[:, None] * 0.5 + torch.zeros(2)},
                 backing_path=str(tmp_path / "t.bin"))
    js = jp.init(lambda rho: {"a": rho * 3 + jnp.arange(3),
                              "b": rho * 0.5 + jnp.zeros(2)},
                 backing_path=str(tmp_path / "j.bin"))
    np.testing.assert_array_equal(_words(ts.backing), _words(js.backing))
    assert tp.ledger.snapshot() == jp.ledger.snapshot()
    assert os.path.getsize(str(tmp_path / "t.bin")) == V * lo.mu_bytes
