"""The port's other BSP applications against the JAX package, on the CPU:
the prefix sum, list ranking and the Euler tour (``repro_torch.pems_apps``).

Each case runs the same numpy-seeded input through ``repro`` (the JAX
reference, ``tests/_jax_ref.py``) and ``repro_torch`` with ``device="cpu"``
and holds the two equal, exactly: the prefix sums (which wrap at 32 bits),
the ranks, the Euler tour's five arrays, and every ``IOLedger`` counter of
``snapshot()``.  Mirrors ``tests/test_pems_apps.py`` (prefix sum over v, k
and driver, the sliced driver moving less; list ranking of a chain, of
several lists and of random lists in both Alltoallv modes; the Euler tour of
a tree and of a forest, its ranks as tour distances) and
``tests/test_backing_tier.py``'s prefix sum on the host, memmap and file
tiers, plus the JAX package's errors.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _jax_ref import apps, jnp
import repro.pems_apps.common as jcommon
from repro_torch.pems_apps import euler_tour, list_rank, prefix_sum
from repro_torch.pems_apps.common import take_from_slots

DRIVERS = ("explicit", "sliced", "async")


def _int32(rng, n):
    """Full-range int32 values: their prefix sums wrap."""
    return rng.integers(-2**31, 2**31, size=n, dtype=np.int64).astype(
        np.int32)


def _wrapped_cumsum(x):
    return np.cumsum(x.astype(np.int64)).astype(np.int32)


# --------------------------------------------------------------------------- #
# Prefix sum                                                                   #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("v,k", [(4, 1), (8, 2), (16, 4)])
@pytest.mark.parametrize("driver", DRIVERS)
def test_prefix_sum_matches_jax(v, k, driver):
    x = _int32(np.random.default_rng(3), 1024)
    jout, jp = apps.prefix_sum(x, v=v, k=k, driver=driver, return_pems=True)
    tout, tp = prefix_sum(torch.from_numpy(x), v=v, k=k, driver=driver,
                          return_pems=True, device="cpu")
    assert tout.dtype == torch.int32 and tout.device.type == "cpu"
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tout.numpy(), _wrapped_cumsum(x))
    assert tp.ledger.snapshot() == jp.ledger.snapshot()


def test_prefix_sum_sliced_moves_less():
    x = np.ones(4096, np.int32)
    _, pe = prefix_sum(x, v=4, driver="explicit", return_pems=True,
                       device="cpu")
    _, ps = prefix_sum(x, v=4, driver="sliced", return_pems=True,
                       device="cpu")
    _, jps = apps.prefix_sum(x, v=4, driver="sliced", return_pems=True)
    assert ps.ledger.swap_total < pe.ledger.swap_total
    assert ps.ledger.swap_total == jps.ledger.swap_total


@pytest.mark.parametrize("tier", ["host", "memmap", "file"])
@pytest.mark.parametrize("driver", DRIVERS)
def test_prefix_sum_on_the_tiers_matches_jax_and_the_device_tier(
        tmp_path, tier, driver):
    """On a backing tier: the device tier's bits and modeled ledger, and
    the JAX package's whole ledger (measured swap and disk bytes too)."""
    x = _int32(np.random.default_rng(5), 1024)
    ref, dp = prefix_sum(x, v=8, k=4, return_pems=True, driver=driver,
                         device="cpu")
    paths = [None, None] if tier == "host" else [
        str(tmp_path / "j.bin"), str(tmp_path / "t.bin")]
    jout, jp = apps.prefix_sum(x, v=8, k=4, driver=driver, tier=tier,
                               backing_path=paths[0], return_pems=True)
    tout, tp = prefix_sum(x, v=8, k=4, driver=driver, tier=tier,
                          backing_path=paths[1], return_pems=True,
                          device="cpu")
    assert tout.device.type == "cpu"
    np.testing.assert_array_equal(tout.numpy(), ref.numpy())
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tp.ledger.snapshot() == jp.ledger.snapshot()
    measured = ("h2d", "d2h", "disk_", "syscall_", "tier_total")
    modeled = {k: val for k, val in tp.ledger.snapshot().items()
               if not k.split(".", 1)[1].startswith(measured)}
    assert modeled == {k: dp.ledger.snapshot()[k] for k in modeled}
    assert tp.ledger.h2d_bytes > 0
    assert (tp.ledger.disk_read_bytes > 0) == (tier != "host")


def test_prefix_sum_on_the_file_tier_under_a_device_cap(tmp_path):
    """k = 2 of 16 contexts on the device under a budget of exactly the
    async driver's three round blocks, as ``chip_smoke.py`` runs it."""
    x = _int32(np.random.default_rng(6), 2048)
    mu = (2 * 128 + 1 + 16 + 16) * 4
    out, pems = prefix_sum(x, v=16, k=2, driver="async", tier="file",
                           backing_path=str(tmp_path / "c.bin"),
                           device_cap_bytes=3 * 2 * mu, return_pems=True,
                           device="cpu")
    assert pems.layout.mu_bytes == mu
    np.testing.assert_array_equal(out.numpy(), _wrapped_cumsum(x))
    with pytest.raises(ValueError, match="device_cap_bytes"):
        prefix_sum(x, v=16, k=2, driver="async", tier="host",
                   device_cap_bytes=3 * 2 * mu - 1, device="cpu")


# --------------------------------------------------------------------------- #
# List ranking                                                                 #
# --------------------------------------------------------------------------- #

def _random_lists(rng, n):
    """Random permutation split into several disjoint linked lists
    (``tests/test_pems_apps.py``'s construction)."""
    perm = rng.permutation(n)
    succ = np.arange(n)
    cuts = sorted(rng.choice(n, size=max(1, n // 16), replace=False))
    prev_cut = 0
    for c in list(cuts) + [n]:
        seg = perm[prev_cut:c]
        for a, b in zip(seg[:-1], seg[1:]):
            succ[a] = b
        if len(seg):
            succ[seg[-1]] = seg[-1]
        prev_cut = c
    return succ


def _rank_oracle(succ):
    succ = np.asarray(succ)
    rank = np.zeros(len(succ), np.int64)
    for i in range(len(succ)):
        j, r = i, 0
        while succ[j] != j:
            j = succ[j]
            r += 1
            assert r <= len(succ), "cycle"
        rank[i] = r
    return rank


def _both(succ, **kw):
    """The JAX and the port's ranks (checked equal, ledgers too)."""
    jr, jp = apps.list_rank(succ, return_pems=True, **kw)
    tr, tp = list_rank(succ, return_pems=True, device="cpu", **kw)
    assert tr.dtype == torch.int32 and tr.device.type == "cpu"
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tp.ledger.snapshot() == jp.ledger.snapshot()
    return tr.numpy()


@pytest.mark.parametrize("v,k", [(4, 1), (8, 2), (16, 4)])
def test_list_rank_single_chain(v, k):
    n = 64
    succ = np.arange(1, n + 1)
    succ[-1] = n - 1
    rank = _both(succ, v=v, k=k)
    np.testing.assert_array_equal(rank, np.arange(n - 1, -1, -1))


@pytest.mark.parametrize("mode", ["direct", "indirect"])
@pytest.mark.parametrize("driver", DRIVERS)
def test_list_rank_multiple_lists(mode, driver):
    succ = _random_lists(np.random.default_rng(4), 128)
    rank = _both(succ, v=8, k=2, mode=mode, driver=driver)
    np.testing.assert_array_equal(rank, _rank_oracle(succ))


@pytest.mark.parametrize("seed, n, v, k", [(0, 32, 4, 1), (1, 96, 4, 2),
                                           (2, 1024, 16, 4),
                                           (3, 1 << 14, 16, 4)])
@pytest.mark.parametrize("mode", ["direct", "indirect"])
def test_list_rank_random_lists(seed, n, v, k, mode):
    rng = np.random.default_rng(seed)
    succ = _random_lists(rng, n)
    rank = _both(succ, v=v, k=k, mode=mode)
    if n <= 1024:
        np.testing.assert_array_equal(rank, _rank_oracle(succ))


@pytest.mark.parametrize("w", [None, 2])
def test_take_from_slots_matches_jax_per_context(w):
    """The batched inverse of ``group_by_dest`` equals the JAX package's
    per-context one for each of the round's contexts."""
    rng = np.random.default_rng(7)
    k, v, cap, n = 3, 4, 5, 9
    shape = (k, v, cap) if w is None else (k, v, cap, w)
    msgs = rng.integers(-50, 50, shape).astype(np.int32)
    dests = rng.integers(0, v, (k, n)).astype(np.int32)
    spos = rng.integers(0, cap, (k, n)).astype(np.int32)
    got = take_from_slots(torch.from_numpy(msgs), torch.from_numpy(dests),
                          torch.from_numpy(spos))
    for b in range(k):
        want = jcommon.take_from_slots(jnp.asarray(msgs[b]),
                                       jnp.asarray(dests[b]),
                                       jnp.asarray(spos[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


# --------------------------------------------------------------------------- #
# Euler tour                                                                   #
# --------------------------------------------------------------------------- #

def _dfs_tour_oracle(parent):
    """Euler tour via DFS with children in index order; returns edge id list
    (down=2i, up=2i+1)."""
    n = len(parent)
    children = [[] for _ in range(n)]
    roots = []
    for i, p in enumerate(parent):
        if p == i:
            roots.append(i)
        else:
            children[p].append(i)
    tour = []

    def visit(u):
        for c in children[u]:
            tour.append(2 * c)
            visit(c)
            tour.append(2 * c + 1)

    for r in roots:
        visit(r)
    return tour


def _random_forest(rng, n, n_trees=1):
    parent = np.zeros(n, np.int64)
    for i in range(n_trees):
        parent[i] = i
    for i in range(n_trees, n):
        parent[i] = rng.integers(0, i)  # parents have smaller index
    return parent


def _tour_both(parent, **kw):
    """The JAX and the port's Euler tour (checked equal, key by key)."""
    want = apps.euler_tour(parent, **kw)
    got = euler_tour(parent, device="cpu", **kw)
    assert set(got) == set(want)
    for key in want:
        assert got[key].device.type == "cpu"
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
        assert got[key].numpy().dtype == np.asarray(want[key]).dtype, key
    return {key: t.numpy() for key, t in got.items()}


@pytest.mark.parametrize("n,v", [(15, 4), (32, 4), (63, 8), (500, 16)])
def test_euler_tour_single_tree(n, v):
    parent = _random_forest(np.random.default_rng(5), n, 1)
    res = _tour_both(parent, v=v)
    oracle = _dfs_tour_oracle(parent)
    got = [e for e in np.argsort(-res["rank"], kind="stable")
           if res["valid"][e]]
    # Rank strictly decreases along the tour, so descending rank = tour order.
    assert got[: len(oracle)] == oracle


@pytest.mark.parametrize("n, trees, v, k", [(24, 3, 4, 1), (300, 4, 16, 4)])
def test_euler_tour_forest(n, trees, v, k):
    parent = _random_forest(np.random.default_rng(6), n, trees)
    res = _tour_both(parent, v=v, k=k)
    oracle = _dfs_tour_oracle(parent)
    root_of = np.arange(n)
    for i in range(n):
        r = i
        while parent[r] != r:
            r = parent[r]
        root_of[i] = r
    for root in set(root_of):
        tree_edges = [e for e in oracle if root_of[e // 2] == root]
        got = sorted(tree_edges, key=lambda e: -res["rank"][e])
        assert got == tree_edges


def test_euler_tour_ranks_are_tour_distances():
    parent = np.array([0, 0, 1, 2])
    res = _tour_both(parent, v=4)
    # Tour: d1 d2 d3 u3 u2 u1 → ranks 5..0.
    oracle = _dfs_tour_oracle(parent)
    np.testing.assert_array_equal(res["rank"][oracle],
                                  np.arange(len(oracle) - 1, -1, -1))


# --------------------------------------------------------------------------- #
# The JAX package's errors                                                     #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("app, args, kw", [
    ("prefix_sum", (np.zeros(30, np.int32),), dict(v=4)),
    ("list_rank", (np.arange(30),), dict(v=4)),
    ("euler_tour", (np.arange(46341),), dict(v=4)),
])
def test_errors_match_jax(app, args, kw):
    """``n % v`` and, for the Euler tour, more than 46,340 nodes, where the
    packed (parent, child) keys leave 32 bits."""
    port = {"prefix_sum": prefix_sum, "list_rank": list_rank,
            "euler_tour": euler_tour}[app]
    with pytest.raises(ValueError) as got:
        port(*args, device="cpu", **kw)
    with pytest.raises(ValueError) as want:
        getattr(apps, app)(*args, **kw)
    assert str(got.value) == str(want.value)


def test_euler_tour_at_the_packed_key_limit_runs():
    """46,340 nodes is the largest forest the packed keys allow (its
    padding keys reach n² + 12, under 2^31): a star runs, in DFS order."""
    n = 46340
    parent = np.arange(n)
    parent[1:] = 0                                  # a star: one tree
    res = euler_tour(parent, v=16, k=4, device="cpu")
    tour = np.argsort(-res["rank"].numpy(), kind="stable")
    tour = tour[res["valid"].numpy()[tour]]
    want = np.stack([2 * np.arange(1, n), 2 * np.arange(1, n) + 1], 1)
    np.testing.assert_array_equal(tour, want.reshape(-1))
