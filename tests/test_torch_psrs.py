"""The port's PSRS slice against the JAX package: ``repro_torch.pems_apps.
psrs_sort(device="cpu")`` gives the same sorted keys as
``repro.pems_apps.psrs_sort``, bit for bit, with equal ``IOLedger``
counters, over driver × ``use_kernel`` × ``merge_kernel`` × mode at
v ∈ {4, 8, 16}, on hard key distributions, and with the same overflow error.
A JAX store taken mid-plan finishes in the port with the JAX run's result.

The JAX side is compiled once per configuration, so each JAX result and
ledger is computed once and shared by the port's cases that need it.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from _jax_ref import jnp, np_out, psrs as jax_psrs, psrs_plan_run
from repro.pems_apps.common import group_by_dest as jax_group_by_dest
from repro_torch import interop
from repro_torch.pems_apps import psrs_plan, psrs_sort
from repro_torch.pems_apps.common import group_by_dest

INT_MIN, INT_MAX = -2**31, 2**31 - 1
N_V = {4: 64, 8: 96, 16: 128}               # keys per context at each v


def _keys(v, kind, seed=0):
    n = v * N_V[v]
    rng = np.random.default_rng(seed + v)
    if kind == "random":
        x = rng.integers(INT_MIN, INT_MAX, size=n, endpoint=True,
                         dtype=np.int64)
    elif kind == "presorted":
        x = np.sort(rng.integers(INT_MIN, INT_MAX, size=n, dtype=np.int64))
    elif kind == "reversed":
        x = np.sort(rng.integers(INT_MIN, INT_MAX, size=n,
                                 dtype=np.int64))[::-1]
    elif kind == "constant":
        x = np.full(n, -5)
    elif kind == "dups":
        x = rng.integers(0, 3, size=n)
    else:                                        # extremes
        x = rng.choice([INT_MIN, -1, 0, INT_MAX], size=n)
    return np.ascontiguousarray(x.astype(np.int32))


@functools.lru_cache(maxsize=None)
def _jax(v, kind, driver="explicit", mode="direct", k=2):
    """JAX psrs_sort (kernel routes off, the quickest to compile) →
    (sorted keys, ledger).  The ledger depends only on the configuration's
    driver and mode, not on the kernel knobs."""
    return jax_psrs(_keys(v, kind), v=v, k=k, driver=driver, mode=mode,
                    use_kernel=False)


def _port(keys, v, **kw):
    out, pems = psrs_sort(torch.from_numpy(keys), v=v, device="cpu",
                          return_pems=True, **kw)
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    return out.numpy(), pems.ledger.snapshot()


@pytest.mark.parametrize("w", [None, 3])
@pytest.mark.parametrize("cap", [16, 5])          # 5: some groups overflow
def test_group_by_dest_matches_jax_per_context(w, cap):
    rng = np.random.default_rng(cap)
    k, n, v = 3, 40, 6
    dests = rng.integers(0, v, size=(k, n)).astype(np.int32)
    vals = rng.integers(-9, 9, size=(k, n) if w is None else (k, n, w))
    vals = vals.astype(np.int32)
    msgs, counts, slot_pos, ok = group_by_dest(
        torch.from_numpy(vals), torch.from_numpy(dests), v, cap, fill=-100)
    for b in range(k):
        jm, jc, js, jok = np_out(jax_group_by_dest(
            jnp.asarray(vals[b]), jnp.asarray(dests[b]), v, cap, fill=-100))
        np.testing.assert_array_equal(counts[b].numpy(), jc)
        np.testing.assert_array_equal(slot_pos[b].numpy(), js)
        assert bool(ok[b]) == bool(jok)
        if jok:      # an overflowing slot holds any one of its writers
            np.testing.assert_array_equal(msgs[b].numpy(), jm)
    assert not bool(ok.all()) or cap == 16


@pytest.mark.parametrize("v", [4, 8, 16])
@pytest.mark.parametrize("driver", ["explicit", "sliced", "async"])
@pytest.mark.parametrize("mode", ["direct", "indirect"])
@pytest.mark.parametrize("use_kernel, merge_kernel", [
    (True, True), (True, False), (False, True), (False, False)])
def test_psrs_matrix_bit_identical_with_equal_ledgers(
        v, driver, mode, use_kernel, merge_kernel):
    keys = _keys(v, "random")
    want, want_ledger = _jax(v, "random", driver, mode)
    got, ledger = _port(keys, v, k=2, driver=driver, mode=mode,
                        use_kernel=use_kernel, merge_kernel=merge_kernel)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(keys))
    assert ledger == want_ledger


@pytest.mark.parametrize("kind", ["presorted", "reversed", "constant",
                                  "dups", "extremes"])
def test_psrs_hard_keys_bit_identical(kind):
    keys = _keys(8, kind)
    want, want_ledger = _jax(8, kind)
    for use_kernel in (True, False):
        got, ledger = _port(keys, 8, k=2, use_kernel=use_kernel)
        np.testing.assert_array_equal(got, want)
        assert ledger == want_ledger


def test_psrs_kernel_routes_of_the_jax_package_agree():
    """One JAX run with every kernel route on (the k-way merge, the bitonic
    sort and the fused delivery) against the port's default."""
    keys = _keys(16, "dups")
    want, want_ledger = jax_psrs(keys, v=16, k=4, driver="async",
                                 merge_tile=8)
    got, ledger = _port(keys, 16, k=4, driver="async", merge_tile=8)
    np.testing.assert_array_equal(got, want)
    assert ledger == want_ledger


def test_psrs_overflow_raises_like_jax():
    # Constant keys all go to one receiver: an 8-key message cap cannot
    # hold a context's share.  (rcap = v·cap keeps the dense merge's
    # v·cap-wide sort no narrower than its result field.)
    keys = _keys(4, "constant")
    with pytest.raises(OverflowError, match="capacity exceeded"):
        jax_psrs(keys, v=4, cap=8, rcap=32, use_kernel=False)
    for use_kernel in (True, False):
        with pytest.raises(OverflowError, match="capacity exceeded"):
            psrs_sort(torch.from_numpy(keys), v=4, cap=8, rcap=32,
                      use_kernel=use_kernel, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        psrs_sort(torch.from_numpy(keys[:-1]), v=4, device="cpu")


def test_psrs_rcap_overflow_is_flagged_by_the_merge():
    # Each receiver gets about n_v random keys: rcap = n_v/2 cannot hold
    # them, and the merge stage raises the flag itself.
    keys = _keys(4, "random")
    for merge_kernel in (True, False):
        with pytest.raises(OverflowError):
            psrs_sort(torch.from_numpy(keys), v=4, rcap=N_V[4] // 2,
                      merge_kernel=merge_kernel, device="cpu")


@pytest.mark.parametrize("upto", ["partition", "alltoallv"])
def test_jax_store_carries_over_mid_plan(upto):
    """Run the JAX plan through ``upto``, move its store into the port with
    ``interop.store_from_numpy`` and finish the remaining stages there:
    ``(result, rcount, oflow)`` equal the full JAX run's."""
    v, keys = 8, _keys(8, "dups", seed=3)
    n_v = N_V[v]
    jp, jstore = psrs_plan_run(keys, v, upto, k=2, use_kernel=False)
    _, full = psrs_plan_run(keys, v, "merge", k=2, use_kernel=False)
    pems, _, steps, extract = psrs_plan(v, n_v, k=2, device="cpu")
    store = interop.store_from_numpy(pems.layout, np.asarray(jstore.data),
                                     device="cpu")
    names = [name for name, _ in steps]
    for _, step in steps[names.index(upto) + 1:]:
        store = step(store)
    np.testing.assert_array_equal(interop.store_to_numpy(store),
                                  np.asarray(full.data))
    result, rcount, oflow = extract(store)
    jl = full.layout
    for name, got in (("result", result), ("rcount", rcount),
                      ("oflow", oflow)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(full.field(name)))
        assert got.shape == (v,) + jl.field(name).shape
    assert int(rcount.sum()) == keys.size and int(oflow.sum()) == 0
