"""Each ported kernel's plain PyTorch version against the JAX package's Pallas
kernel run in interpret mode, and against the port's own oracle (``ref.py``),
on small shapes with the edge cases.  Every path is integer (or an exact
float32 copy), so the tolerance is zero: outputs compare bit for bit.

On the CPU a kernel wrapper takes its plain version; the CUDA kernels are
held against the same plain versions on the card (``tests/test_torch_gpu.py``
and ``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _jax_ref import bitonic, bitonic_ops, deliver as jdeliver, jax, jnp, \
    kway as jkway, np_out
from repro_torch.kernels import alltoallv_deliver as tdeliver
from repro_torch.kernels import kway_merge as tkway
from repro_torch.kernels.alltoallv_deliver import ref as deliver_ref
from repro_torch.kernels.bitonic_sort import bitonic_network, \
    bitonic_sort, bitonic_sort_rows
from repro_torch.kernels.bitonic_sort.ref import sort_ref

INT_MIN, INT_MAX = -2**31, 2**31 - 1

# The JAX kernels in interpret mode, jitted once per shape and static
# argument so that cases differing only in their data reuse the compile.
_j_bitonic_rows = jax.jit(lambda x: bitonic.bitonic_sort_rows(
    x, interpret=True))
_j_tile_grid = jax.jit(lambda x: jkway.merge_tile_grid(x, interpret=True))
_j_kway = jax.jit(jkway.kway_merge, static_argnames=(
    "rcap", "tile", "fill", "interpret"))


def _keys(rng, shape, kind="random"):
    if kind == "random":
        return rng.integers(INT_MIN, INT_MAX, size=shape, endpoint=True,
                            dtype=np.int64).astype(np.int32)
    if kind == "dups":
        return rng.integers(-2, 3, size=shape).astype(np.int32)
    pool = np.array([INT_MIN, INT_MIN + 1, -1, 0, 1, INT_MAX - 1, INT_MAX],
                    np.int32)
    return pool[rng.integers(0, len(pool), size=shape)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint32) if got.itemsize == 4
                                  else got,
                                  want.view(np.uint32) if want.itemsize == 4
                                  else want)


# --------------------------------------------------------------------------- #
# Kernel 1: bitonic_sort_rows                                                  #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("rows, n", [(1, 1), (1, 2), (3, 8), (2, 64),
                                     (2, 512)])
@pytest.mark.parametrize("kind", ["random", "dups", "extremes"])
def test_bitonic_rows_match_pallas_interpret(rows, n, kind):
    x = _keys(np.random.default_rng(rows * n), (rows, n), kind)
    want = np_out(_j_bitonic_rows(jnp.asarray(x)))
    _eq(bitonic_sort_rows(_t(x)), want)
    _eq(bitonic_network(_t(x)), want)
    _eq(sort_ref(_t(x)), want)


def test_bitonic_rows_take_strided_rows_and_reject_ragged():
    x = _keys(np.random.default_rng(5), (3, 40))
    view = _t(x)[:, 4:36]                      # rows 40 words apart
    _eq(bitonic_sort_rows(view), np.sort(x[:, 4:36], axis=-1))
    with pytest.raises(ValueError, match="power of two"):
        bitonic_sort_rows(_t(x)[:, :6])


@pytest.mark.parametrize("shape", [(1,), (5,), (100,), (3, 7), (2, 1000)])
@pytest.mark.parametrize("kind", ["random", "dups", "extremes"])
def test_sort_pads_non_power_of_two_like_jax(shape, kind):
    x = _keys(np.random.default_rng(len(shape) * 31 + shape[-1]), shape, kind)
    want = np_out(bitonic_ops.sort(jnp.asarray(x), interpret=True))
    _eq(bitonic_sort(_t(x)), want)
    _eq(bitonic_sort(_t(x), use_kernel=False), want)


def test_sort_float32_pads_with_the_float_max():
    x = np.random.default_rng(3).standard_normal((2, 37)).astype(np.float32)
    x[0, 0] = np.finfo(np.float32).max
    want = np_out(bitonic_ops.sort(jnp.asarray(x), interpret=True))
    _eq(bitonic_sort(_t(x)), want)


# --------------------------------------------------------------------------- #
# Kernel 2: deliver_tiles                                                      #
# --------------------------------------------------------------------------- #

def _deliver_case(v, omega, seed, dtype=np.int32):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        msgs = rng.standard_normal((v, v, omega)).astype(np.float32)
    else:
        msgs = _keys(rng, (v, v, omega))
    counts = rng.integers(0, omega + 1, size=(v, v)).astype(np.int32)
    counts[0, 0] = 0
    counts[-1, 0] = omega                      # empty and full messages
    payload = rng.integers(0, 1000, size=(v, v)).astype(np.int32)
    return msgs, counts, payload


@pytest.mark.parametrize("v, omega", [(1, 1), (3, 100), (4, 129), (2, 300)])
@pytest.mark.parametrize("fill", [None, INT_MAX, -7])
@pytest.mark.parametrize("with_payload", [False, True])
def test_deliver_tiles_match_pallas_interpret(v, omega, fill, with_payload):
    msgs, counts, payload = _deliver_case(v, omega, v * omega)
    cp = payload if with_payload else None
    want_out, want_ct = np_out(jdeliver.deliver_tiles(
        jnp.asarray(msgs), jnp.asarray(counts),
        None if cp is None else jnp.asarray(cp), fill=fill, interpret=True))
    got_out, got_ct = tdeliver.deliver_tiles(
        _t(msgs), _t(counts), None if cp is None else _t(cp), fill=fill)
    _eq(got_out, want_out)
    assert (got_ct is None) == (want_ct is None)
    if want_ct is not None:
        _eq(got_ct, want_ct)
    ref_out, ref_ct = deliver_ref.deliver_fused_ref(
        _t(msgs), _t(counts), None if cp is None else _t(cp), fill=fill)
    _eq(ref_out, want_out)
    fused_out, _ = tdeliver.deliver_fused(
        _t(msgs), _t(counts), None if cp is None else _t(cp), fill=fill)
    _eq(fused_out, want_out)


def test_deliver_float32_payload_and_defaults_match_jax():
    msgs, counts, _ = _deliver_case(3, 130, 11, np.float32)
    want = np_out(jdeliver.deliver(jnp.asarray(msgs), jnp.asarray(counts),
                                   fill=-1.5, interpret=True))
    _eq(tdeliver.deliver(_t(msgs), _t(counts), fill=-1.5), want)
    _eq(tdeliver.deliver(_t(msgs), _t(counts), fill=-1.5, use_kernel=False),
        want)
    want0 = np_out(jdeliver.deliver(jnp.asarray(msgs), jnp.asarray(counts),
                                    interpret=True))
    _eq(tdeliver.deliver(_t(msgs), _t(counts)), want0)


def test_deliver_words_moves_between_store_word_ranges():
    """The kernel's store form: message (s -> d) from row s at
    ``src_off + d·ww`` into row d at ``dst_off + s·ww``, counts words
    transposed into their own range, all in one call."""
    rng = np.random.default_rng(7)
    v, ww = 3, 5
    store = _keys(rng, (v, 40))
    store[:, 30:33] = rng.integers(-1, ww + 2, size=(v, v))   # counts words
    want = store.copy()
    for s in range(v):
        for d in range(v):
            c = store[s, 30 + d]
            msg = store[s, 0 + d * ww:0 + (d + 1) * ww].copy()
            msg[max(c, 0):] = -9
            want[d, 15 + s * ww:15 + (s + 1) * ww] = msg
            want[d, 35 + s] = store[s, 30 + d]
    got = _t(store.copy())
    tdeliver.deliver_words(got, 0, got, 15, v, ww, got, 30, -9, got, 30,
                           got, 35)
    _eq(got, want)
    with pytest.raises(ValueError, match="fill requires counts"):
        tdeliver.deliver_words(got, 0, got, 15, v, ww, fill=-9)


@pytest.mark.parametrize("fill, dtype", [
    (INT_MAX, np.int32), (2**31, np.int32), (-1, np.uint32), (2.5, np.int32),
    (3.0, np.int32), (1e39, np.float32), (float("inf"), np.float32),
    (10**400, np.float32), ("x", np.int32),
])
def test_check_fill_range_agrees_with_jax(fill, dtype):
    def outcome(fn):
        try:
            fn(fill, dtype)
        except ValueError:
            return "ValueError"
        return "ok"

    assert outcome(tdeliver.check_fill_range) == outcome(
        jdeliver.check_fill_range)


# --------------------------------------------------------------------------- #
# Kernel 3: merge_tile_grid and the k-way merge around it                      #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("G, tile", [(1, 2), (5, 8), (3, 256)])
@pytest.mark.parametrize("kind", ["random", "dups", "extremes"])
def test_merge_tile_grid_matches_pallas_interpret(G, tile, kind):
    x = _keys(np.random.default_rng(G * tile), (G, tile), kind)
    want = np_out(_j_tile_grid(jnp.asarray(x)))
    _eq(tkway.merge_tile_grid(_t(x)), want)
    _eq(tkway.sort_tile_rows(_t(x)), want)


def _buckets(rng, k, v, cap, kind):
    if kind == "constant":
        b = np.full((k, v, cap), 42, np.int32)
    elif kind == "presorted":
        b = np.arange(k * v * cap, dtype=np.int32).reshape(k, v, cap)
    else:
        b = np.sort(_keys(rng, (k, v, cap), kind), axis=-1)
    counts = rng.integers(0, cap + 1, size=(k, v)).astype(np.int32)
    counts[0, 0], counts[-1, -1] = 0, cap
    return b, counts


def _kway_case(rcap, tile, kind):
    k, v, cap = 2, 4, 16
    rng = np.random.default_rng(rcap * tile + len(kind))
    b, counts = _buckets(rng, k, v, cap, kind)
    merged, total, over = tkway.kway_merge(_t(b), _t(counts), rcap=rcap,
                                           tile=tile, fill=INT_MAX)
    assert merged.shape == (k, rcap)
    return b, counts, merged, total, over


@pytest.mark.parametrize("rcap", [20, 64, 100])   # below, at, above v·cap
@pytest.mark.parametrize("tile", [2, 8, 256])
@pytest.mark.parametrize("kind", ["dups", "constant", "presorted", "random"])
def test_kway_merge_matches_ref(rcap, tile, kind):
    b, counts, merged, total, over = _kway_case(rcap, tile, kind)
    _eq(merged, tkway.kway_merge_ref(_t(b), _t(counts), rcap=rcap,
                                     fill=INT_MAX).numpy())
    np.testing.assert_array_equal(total.numpy(), counts.sum(axis=1))
    np.testing.assert_array_equal(over.numpy(), counts.sum(axis=1) > rcap)
    for c in range(b.shape[0]):
        _eq(tkway.kway_merge_ref(_t(b[c]), _t(counts[c]), rcap=rcap,
                                 fill=INT_MAX),
            np_out(jkway.kway_merge_ref(jnp.asarray(b[c]),
                                        jnp.asarray(counts[c]), rcap=rcap,
                                        fill=INT_MAX)))
    plain, _, _ = tkway.kway_merge(_t(b), _t(counts), rcap=rcap, tile=tile,
                                   fill=INT_MAX, use_kernel=False)
    _eq(plain, merged.numpy())


@pytest.mark.parametrize("rcap, tile", [(20, 2), (64, 8), (100, 256)])
@pytest.mark.parametrize("kind", ["dups", "constant", "presorted", "random"])
def test_kway_merge_matches_jax_interpret(rcap, tile, kind):
    b, counts, merged, total, over = _kway_case(rcap, tile, kind)
    for c in range(b.shape[0]):
        jm, jt, jo = np_out(_j_kway(
            jnp.asarray(b[c]), jnp.asarray(counts[c]), rcap=rcap, tile=tile,
            fill=INT_MAX, interpret=True))
        _eq(merged[c], jm)
        assert (int(total[c]), int(over[c])) == (int(jt), int(jo))


def test_kway_merge_single_context_and_checks():
    rng = np.random.default_rng(9)
    b, counts = _buckets(rng, 1, 4, 8, "dups")
    m, total, over = tkway.kway_merge(_t(b[0]), _t(counts[0]), rcap=40,
                                      tile=8, fill=INT_MAX)
    assert m.shape == (40,) and total.dim() == 0
    assert int(over) == int(counts.sum() > 40)
    with pytest.raises(ValueError, match="dtype maximum"):
        tkway.kway_merge(_t(b), _t(counts), rcap=8, fill=0)
    with pytest.raises(ValueError, match="power of two"):
        tkway.kway_merge(_t(b), _t(counts), rcap=8, tile=6, fill=INT_MAX)
    with pytest.raises(ValueError, match="rcap"):
        tkway.kway_merge(_t(b), _t(counts), rcap=0, fill=INT_MAX)
    with pytest.raises(ValueError, match="int32"):
        tkway.kway_merge(_t(b).to(torch.float32), _t(counts), rcap=8,
                         fill=INT_MAX)
