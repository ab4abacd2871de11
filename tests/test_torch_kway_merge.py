"""The fused k-way merge (exact splitters at the segment boundaries, then one
block a segment) against the JAX package's ``kway_merge``.

Inputs are made with numpy from a seed.  The plain versions follow the CUDA
kernels' own decomposition (coarse starts, the windows between them, the
merge of each segment), and the segment size is an argument, so these
small shapes cut many segments and reach every segment edge: boundaries
inside runs of equal keys, all-equal buckets, one bucket supplying a whole
segment, counts of 0 and of ``cap``, fill-only segments (total < ``rcap``),
overflow (total > ``rcap``), ``rcap`` past ``v·cap`` and not a multiple of
the tile or the segment, v of 1, 16 and 33 (past one warp), tiles of 2, 8
and 256.  The JAX side runs its Pallas tile grid in interpret mode; every
comparison is exact.  The same cases run in uint32 (the keys' bits, each
bucket's valid prefix sorted as uint32, fill ``0xFFFFFFFF``): keys at and
past 2^31 sort after the rest, as the JAX package's ``kway_merge`` sorts
them.  The kernels are held against the same plain versions
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from _jax_ref import jax, jnp, kway as jkway, np_out
from repro_torch.kernels import kway_merge as tkway

km = importlib.import_module("repro_torch.kernels.kway_merge.kway_merge")
jops = importlib.import_module("repro.kernels.kway_merge.ops")

INT_MIN, INT_MAX = -2**31, 2**31 - 1

_j_kway = jax.jit(jkway.kway_merge, static_argnames=(
    "rcap", "tile", "fill", "interpret"))
_j_starts = jax.jit(jops._exact_starts)

# (v, cap, key kind, counts kind, rcap, tile, segment tiles); k = 2.
CASES = [
    (4, 40, "dups", "random", 150, 8, 2),        # boundaries in equal runs
    (4, 16, "equal", "random", 64, 8, 2),        # all-equal buckets
    (4, 16, "equal", "full", 40, 2, 3),
    (4, 64, "presorted", "full", 256, 8, 4),     # one bucket a segment
    (4, 64, "presorted", "random", 200, 8, 1),
    (16, 24, "random", "zero", 200, 8, 2),       # nothing valid: fill only
    (16, 24, "dups", "full", 200, 8, 2),         # total > rcap
    (16, 24, "random", "random", 384, 8, 4),     # total < rcap: fill only
    (16, 24, "extremes", "random", 437, 8, 4),   # rcap > v·cap, ragged
    (16, 20, "dups", "random", 101, 2, 8),       # rcap ragged at tile 2
    (1, 50, "dups", "random", 70, 8, 2),         # v = 1
    (1, 50, "random", "full", 33, 2, 1),
    (33, 8, "dups", "random", 300, 8, 2),        # v past one warp
    (33, 8, "extremes", "full", 264, 2, 16),
    (16, 40, "random", "random", 640, 256, 1),   # tile 256
    (4, 200, "dups", "random", 700, 256, 2),
]


def _case(v, cap, kind, cnt_kind, seed):
    rng = np.random.default_rng(seed)
    k = 2
    if kind == "random":
        b = rng.integers(INT_MIN, INT_MAX, size=(k, v, cap), endpoint=True)
    elif kind == "dups":
        b = rng.integers(-2, 3, size=(k, v, cap))
    elif kind == "equal":
        b = np.full((k, v, cap), 7)
    elif kind == "presorted":                   # bucket j below bucket j+1
        b = np.arange(k * v * cap).reshape(k, v, cap)
    else:
        pool = np.array([INT_MIN, INT_MIN + 1, -1, 0, 1, INT_MAX - 1,
                         INT_MAX])
        b = pool[rng.integers(0, len(pool), size=(k, v, cap))]
    b = np.sort(b, axis=-1).astype(np.int32)
    # Lanes past the count hold garbage: the merge must mask them itself.
    counts = {"random": rng.integers(0, cap + 1, size=(k, v)),
              "full": np.full((k, v), cap),
              "zero": np.zeros((k, v))}[cnt_kind].astype(np.int32)
    if cnt_kind == "random":
        counts[0, 0], counts[-1, -1] = 0, cap
    lane = np.arange(cap)
    garbage = rng.integers(INT_MIN, INT_MAX, size=b.shape, endpoint=True)
    b = np.where(lane < counts[..., None], b, garbage).astype(np.int32)
    return b, counts


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


U32_MAX = 2**32 - 1


def _case_u32(v, cap, kind, cnt_kind, seed):
    """The int32 case's bits as uint32 buckets, each valid prefix sorted in
    uint32 order (the lanes past the count keep their garbage)."""
    b, counts = _case(v, cap, kind, cnt_kind, seed)
    bu = b.view(np.uint32)
    valid = np.arange(cap) < counts[..., None]
    srt = np.sort(np.where(valid, bu, np.uint32(U32_MAX)), axis=-1)
    return np.where(valid, srt, bu).astype(np.uint32), counts


def _jax_merge(b, counts, rcap, tile):
    """The JAX package's kway_merge of each context (its Pallas tile grid in
    interpret mode) and its dense oracle."""
    out = []
    for c in range(b.shape[0]):
        m, t, o = np_out(_j_kway(jnp.asarray(b[c]), jnp.asarray(counts[c]),
                                 rcap=rcap, tile=tile, fill=INT_MAX,
                                 interpret=True))
        ref = np_out(jkway.kway_merge_ref(jnp.asarray(b[c]),
                                          jnp.asarray(counts[c]), rcap=rcap,
                                          fill=INT_MAX))
        np.testing.assert_array_equal(m, ref)
        assert (int(t), int(o)) == (int(counts[c].sum()),
                                    int(counts[c].sum() > rcap))
        out.append(m)
    return np.stack(out)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_exact_splitters_plain_match_jax_exact_starts(case):
    v, cap, kind, cnt_kind, rcap, tile, S = case
    b, counts = _case(v, cap, kind, cnt_kind, CASES.index(case))
    ranks = km.coarse_ranks(rcap, tile, S, v * cap, "cpu")
    starts = tkway.exact_splitters_plain(_t(b), _t(counts), ranks)
    assert starts.shape == (2, ranks.numel(), v)
    masked = np.where(np.arange(cap) < counts[..., None], b, INT_MAX)
    for c in range(2):
        rows = jnp.asarray(masked[c].astype(np.int32).view(np.uint32)
                           ^ np.uint32(0x80000000))
        want = np_out(_j_starts(rows, jnp.asarray(ranks.numpy())))
        np.testing.assert_array_equal(starts[c].numpy(), want)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_merge_segments_plain_matches_jax_kway_merge(case):
    v, cap, kind, cnt_kind, rcap, tile, S = case
    b, counts = _case(v, cap, kind, cnt_kind, CASES.index(case))
    want = _jax_merge(b, counts, rcap, tile)
    ranks = km.coarse_ranks(rcap, tile, S, v * cap, "cpu")
    starts = tkway.exact_splitters(_t(b), _t(counts), ranks)
    got = tkway.merge_segments(_t(b), _t(counts), starts, rcap=rcap,
                               tile=tile, seg_tiles=S)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tkway.kway_merge_ref(_t(b), _t(counts), rcap=rcap,
                                          fill=INT_MAX).numpy())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_kway_merge_on_the_cpu_matches_jax_kway_merge(case):
    v, cap, kind, cnt_kind, rcap, tile, _ = case
    b, counts = _case(v, cap, kind, cnt_kind, CASES.index(case))
    want = _jax_merge(b, counts, rcap, tile)
    for use_kernel in (True, False):
        got, total, over = tkway.kway_merge(_t(b), _t(counts), rcap=rcap,
                                            tile=tile, fill=INT_MAX,
                                            use_kernel=use_kernel)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(total.numpy(), counts.sum(axis=1))
        np.testing.assert_array_equal(over.numpy(),
                                      counts.sum(axis=1) > rcap)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_exact_splitters_plain_match_jax_exact_starts_uint32(case):
    v, cap, kind, cnt_kind, rcap, tile, S = case
    b, counts = _case_u32(v, cap, kind, cnt_kind, CASES.index(case))
    ranks = km.coarse_ranks(rcap, tile, S, v * cap, "cpu")
    starts = tkway.exact_splitters_plain(_t(b), _t(counts), ranks)
    masked = np.where(np.arange(cap) < counts[..., None], b,
                      np.uint32(U32_MAX))
    for c in range(2):
        want = np_out(_j_starts(jnp.asarray(masked[c]),
                                jnp.asarray(ranks.numpy())))
        np.testing.assert_array_equal(starts[c].numpy(), want)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_kway_merge_uint32_on_the_cpu_matches_jax_kway_merge(case):
    v, cap, kind, cnt_kind, rcap, tile, S = case
    b, counts = _case_u32(v, cap, kind, cnt_kind, CASES.index(case))
    want = np.stack([np_out(_j_kway(
        jnp.asarray(b[c]), jnp.asarray(counts[c]), rcap=rcap, tile=tile,
        fill=U32_MAX, interpret=True))[0] for c in range(2)])
    assert want.dtype == np.uint32
    for use_kernel in (True, False):
        got, total, _ = tkway.kway_merge(_t(b), _t(counts), rcap=rcap,
                                         tile=tile, fill=U32_MAX,
                                         use_kernel=use_kernel)
        assert got.dtype == torch.uint32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(total.numpy(), counts.sum(axis=1))
    ranks = km.coarse_ranks(rcap, tile, S, v * cap, "cpu")
    starts = tkway.exact_splitters(_t(b), _t(counts), ranks)
    got = tkway.merge_segments(_t(b), _t(counts), starts, rcap=rcap,
                               tile=tile, seg_tiles=S)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tkway.kway_merge_ref(_t(b), _t(counts), rcap=rcap,
                             fill=U32_MAX).numpy(), want)
    tiles, _, _ = _gather_u32(b, counts, rcap, tile)
    np.testing.assert_array_equal(
        tkway.sort_tile_rows(tiles).reshape(2, -1)[:, :rcap].numpy(), want)


def _gather_u32(b, counts, rcap, tile):
    """The gather route's tiles of the port, in uint32."""
    from repro_torch.kernels.kway_merge.ops import gather_tiles
    tiles = gather_tiles(_t(b), _t(counts), rcap=rcap, tile=tile,
                         fill=U32_MAX)
    assert tiles[0].dtype == torch.uint32
    return tiles


def test_kway_merge_rejects_a_fill_below_the_uint32_maximum():
    b, counts = _case_u32(4, 16, "dups", "random", 1)
    with pytest.raises(ValueError, match="dtype maximum 4294967295"):
        tkway.kway_merge(_t(b), _t(counts), rcap=32, tile=8, fill=INT_MAX)
    with pytest.raises(ValueError, match="int32 and uint32"):
        tkway.kway_merge(_t(b).to(torch.int64), _t(counts), rcap=32, tile=8,
                         fill=INT_MAX)


def test_segment_size_and_routes():
    """S is chosen by size: 2^13 keys a segment while it fits two blocks an
    SM, 0 (the gather route) for a tile past one segment; each route gives
    the same merge."""
    assert km.segment_tiles(16, 256) == 32        # PSRS: 2^13 keys, 2 x 32 KiB
    assert km.segment_tiles(16, 8192) == 1
    assert km.segment_tiles(16, 16384) == 0       # past a segment: gather
    for v in (1, 16, 33, 3000, 20000):
        for tile in (1, 2, 8, 256, 4096):
            S = km.segment_tiles(v, tile)
            if S == 0:                            # even one tile is too big
                assert km.segment_smem_bytes(1, tile, v) > km.SEGMENT_SMEM
                continue
            assert S & (S - 1) == 0 and S * tile <= km.SEGMENT_KEYS
            assert km.segment_smem_bytes(S, tile, v) <= km.SEGMENT_SMEM
            assert (2 * S * tile > km.SEGMENT_KEYS or km.segment_smem_bytes(
                2 * S, tile, v) > km.SEGMENT_SMEM)
    # 125 tiles of 8 in segments of 4: ranks 32c, the last at tile 125,
    # clamped at v·cap = 900.
    assert km.coarse_ranks(1000, 8, 4, 900, "cpu").tolist() == [
        min(32 * c, 1000, 900) for c in range(33)]
    b, counts = _case(16, 300, "dups", "random", 3)
    want = tkway.kway_merge_ref(_t(b), _t(counts), rcap=2100, fill=INT_MAX)
    for tile in (16384, 2048, 256, 8):            # gather, then fused
        got, _, _ = tkway.kway_merge(_t(b), _t(counts), rcap=2100, tile=tile,
                                     fill=INT_MAX)
        assert torch.equal(got, want), tile


def test_plain_versions_read_strided_buckets():
    """The buckets as the merge stage finds them: a [k, v, cap] view of
    wider store rows, counts a view too."""
    b, counts = _case(16, 30, "dups", "random", 5)
    store = np.full((2, 16 * 30 + 50), -9, np.int32)
    store[:, 10:10 + 16 * 30] = b.reshape(2, -1)
    store[:, 500:516] = counts
    st = torch.from_numpy(store)
    view = st[:, 10:10 + 16 * 30].reshape(2, 16, 30)
    cview = st[:, 500:516]
    assert view.stride() == (16 * 30 + 50, 30, 1)
    got, _, _ = tkway.kway_merge(view, cview, rcap=700, tile=8, fill=INT_MAX)
    want, _, _ = tkway.kway_merge(_t(b), _t(counts), rcap=700, tile=8,
                                  fill=INT_MAX)
    assert torch.equal(got, want)


def test_library_hash_covers_the_headers(tmp_path, monkeypatch):
    """The kernel library's name hashes every source and every ``.cuh``
    header beside them: an edited header builds anew instead of loading a
    stale library (nothing is compiled here)."""
    from repro_torch.kernels import _build
    for name in _build.SOURCES:
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    bare = _build.library_path()
    (tmp_path / "shared.cuh").write_text("// a shared helper\n")
    with_header = _build.library_path()
    (tmp_path / "shared.cuh").write_text("// the helper, edited\n")
    assert len({bare, with_header, _build.library_path()}) == 3
