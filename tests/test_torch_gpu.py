"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device and skips
when there is none (this is decided while the test runs, never while the
module is imported).  On a machine with an NVIDIA H100 and the CUDA toolkit::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The first test builds the kernels (``build/kernels``).  The integer kernels
(data movement and comparison) compare exactly; the float kernels within the
tolerances stated above their tests.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

INT_MIN, INT_MAX = -2**31, 2**31 - 1

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel(name):
    return importlib.import_module(f"repro_torch.kernels.{name}.{name}")


def _keys(shape, dev, seed, kind="random"):
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "random":
        return torch.randint(INT_MIN, INT_MAX + 1, shape, generator=g,
                             device=dev, dtype=torch.int64).to(torch.int32)
    if kind == "equal":
        return torch.full(shape, -5, dtype=torch.int32, device=dev)
    if kind == "extremes":
        pool = torch.tensor([INT_MIN, INT_MIN + 1, -1, 0, 1, INT_MAX - 1,
                             INT_MAX], dtype=torch.int32, device=dev)
        return pool[torch.randint(0, len(pool), shape, generator=g,
                                  device=dev)]
    return torch.randint(-2, 3, shape, generator=g, device=dev,
                         dtype=torch.int32)


@pytest.mark.parametrize("rows, n", [(1, 1), (3, 8), (2, 8192), (2, 16384),
                                     (3, 1 << 17)])
@pytest.mark.parametrize("kind", ["random", "dups"])
def test_bitonic_kernel_matches_plain(cuda, rows, n, kind):
    bs = _kernel("bitonic_sort")
    x = _keys((rows, n), cuda, rows * n, kind)
    before = bs.LAUNCHES
    got = bs.bitonic_sort_rows(x)
    torch.cuda.synchronize()
    assert bs.LAUNCHES == before + 1
    assert torch.equal(got, bs.bitonic_network(x))
    assert torch.equal(got, torch.sort(x, dim=-1).values)


def test_bitonic_kernel_reads_strided_rows(cuda):
    bs = _kernel("bitonic_sort")
    x = _keys((3, 3000), cuda, 1)
    assert torch.equal(bs.bitonic_sort_rows(x[:, 100:2148]),
                       torch.sort(x[:, 100:2148], dim=-1).values)


# Rows past one shared-memory segment take the radix kernel: 2^14 (just
# past it), 2^16 (16 tiles), the PSRS local sort's [4, 2^23] as strided rows
# of a wider store; all-equal rows put a whole row in one bin of every pass.
@pytest.mark.parametrize("rows, n, pad", [(2, 1 << 14, 0), (3, 1 << 16, 0),
                                          (2, 1 << 16, 100),
                                          (4, 1 << 23, 1024)])
@pytest.mark.parametrize("kind", ["random", "dups", "extremes", "equal"])
def test_radix_kernel_matches_torch_sort_and_plain(cuda, rows, n, pad, kind):
    bs = _kernel("bitonic_sort")
    x = _keys((rows, n + pad), cuda, rows * n + pad, kind)[:, pad // 2:][:, :n]
    before = bs.LAUNCHES
    got = bs.bitonic_sort_rows(x)
    torch.cuda.synchronize()
    assert bs.LAUNCHES == before + 1
    assert torch.equal(got, torch.sort(x, dim=-1).values)
    assert torch.equal(got, bs.radix_sort_plain(x))


# The warp-register sort up to 1024 keys a tile; 2048 and past take the
# bitonic kernel's shared-memory and global passes.
@pytest.mark.parametrize("tile", [2, 8, 256, 1024, 2048, 8192, 16384])
def test_tile_kernel_matches_plain(cuda, tile):
    km = _kernel("kway_merge")
    t = _keys((max(1, (1 << 16) // tile), tile), cuda, tile, "dups")
    before = km.LAUNCHES
    got = km.merge_tile_grid(t)
    torch.cuda.synchronize()
    assert km.LAUNCHES == before + 1
    assert torch.equal(got, km.sort_tile_rows(t))


# Kernel 1 in every key dtype: (torch dtype, the signed view of its width).
_SORT_DTYPES = {torch.bool: torch.int8, torch.int8: torch.int8,
                torch.uint8: torch.int8, torch.int16: torch.int16,
                torch.uint16: torch.int16, torch.int32: torch.int32,
                torch.uint32: torch.int32, torch.float16: torch.int16,
                torch.bfloat16: torch.int16, torch.float32: torch.int32}


def _dtype_keys(shape, dev, seed, dtype):
    """Keys of ``dtype``: random bits, with (floats) ±0, NaNs of both signs
    and several payloads, ±inf and subnormals, or (integers) the type's
    extremes, at a third of the places."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=g, device=dev).bool()
    view = _SORT_DTYPES[dtype]
    width = view.itemsize * 8
    bits = torch.randint(-2**(width - 1), 2**(width - 1), shape, generator=g,
                         device=dev, dtype=torch.int64).to(view)
    if dtype.is_floating_point:
        x = (torch.randn(shape, generator=g, device=dev) * 4).to(dtype)
        sign = -2**(width - 1)
        inf = {torch.float32: 0x7F800000, torch.float16: 0x7C00,
               torch.bfloat16: 0x7F80}[dtype]
        special = [0, sign, inf, sign | inf, inf | 1, inf | (inf >> 1),
                   sign | inf | 5, 1, sign | 3, inf - 1]
    else:
        info = torch.iinfo(dtype)
        x = bits.view(dtype)
        special = [v - (1 << width) if v >= 1 << (width - 1) else v
                   for v in (info.min, info.min + 1, 0, 1, info.max - 1,
                             info.max)]
    pool = torch.tensor(special, dtype=torch.int64, device=dev).to(view)
    pick = pool[torch.randint(0, len(special), shape, generator=g,
                              device=dev)]
    at = torch.rand(shape, generator=g, device=dev) < 1 / 3
    return torch.where(at, pick, x.view(view)).view(dtype)


def _sort_bits(x):
    return x.view(torch.int8) if x.dtype == torch.bool else \
        x.view(_SORT_DTYPES[x.dtype])


def _stable_sort_ref(x):
    """``torch.sort(stable=True)`` of the keys on the CPU, whose order is
    ``jnp.sort``'s (NaNs tie after +inf, ±0 tie); the card's ``torch.sort``
    (2.11) puts negative NaNs first and orders NaN payloads by their bits."""
    return torch.sort(x.cpu(), dim=-1, stable=True).values.to(x.device)


# One shared-memory pass up to 2^13 keys a row (float rows sort (image,
# index) pairs there), the radix kernel past it (one pass a byte).
@pytest.mark.parametrize("rows, n", [(1, 1), (3, 8), (2, 8192), (2, 16384),
                                     (3, 1 << 17)])
@pytest.mark.parametrize("dtype", list(_SORT_DTYPES), ids=str)
def test_sort_kernels_take_every_key_dtype(cuda, rows, n, dtype):
    bs = _kernel("bitonic_sort")
    x = _dtype_keys((rows, n), cuda, rows * n, dtype)
    before = bs.LAUNCHES
    got = bs.bitonic_sort_rows(x)
    torch.cuda.synchronize()
    assert bs.LAUNCHES == before + 1 and got.dtype == dtype
    assert torch.equal(_sort_bits(got), _sort_bits(bs.radix_sort_plain(x)))
    assert torch.equal(_sort_bits(got), _sort_bits(_stable_sort_ref(x)))


@pytest.mark.parametrize("dtype", list(_SORT_DTYPES), ids=str)
def test_sort_kernels_read_strided_rows_of_every_dtype(cuda, dtype):
    """Rows a wider row apart (both kernels), and ``ops.sort`` on a ragged
    width (padded with a key that ties with the largest)."""
    bs = _kernel("bitonic_sort")
    from repro_torch.kernels.bitonic_sort import bitonic_sort
    x = _dtype_keys((3, 1 << 15), cuda, 3, dtype)
    for n in (2048, 1 << 14):
        view = x[:, 100:100 + n]
        assert torch.equal(_sort_bits(bs.bitonic_sort_rows(view)),
                           _sort_bits(_stable_sort_ref(view)))
    for n in (1000, 20000):
        before = bs.LAUNCHES
        got = bitonic_sort(x[:, :n])
        assert bs.LAUNCHES == before + 1
        assert torch.equal(_sort_bits(got),
                           _sort_bits(_stable_sort_ref(x[:, :n])))


def _u32_buckets(b, cnt):
    """int32 buckets' bits as uint32 buckets, each valid prefix sorted in
    uint32 order (lanes past the count keep their words)."""
    img = b.view(torch.int32) ^ INT_MIN               # signed images
    valid = torch.arange(b.shape[-1], device=b.device) < cnt[..., None]
    srt = torch.sort(torch.where(valid, img, INT_MAX), dim=-1).values
    b.copy_(torch.where(valid, srt ^ INT_MIN, b))     # in place: the layout
    return b.view(torch.uint32)


# The fused k-way merge's edges, (k, v, cap, keys, counts, rcap, tile,
# segment tiles): v of 1, 16, 33 and 64 (one and two warps of buckets, odd
# merge levels), windows cut inside runs of equal keys, all-equal buckets,
# one bucket a segment, counts of 0 and of cap, fill-only segments, total
# past rcap, rcap past v·cap and ragged, tiles of 1 to 1024, many segments,
# the built size (32 tiles of 256) and twice it.
_KWAY = [(2, 1, 300, "dups", "random", 600, 256, 1),
         (3, 16, 300, "dups", "random", 600, 8, 4),
         (2, 16, 300, "equal", "full", 2000, 2, 64),
         (2, 33, 100, "extremes", "random", 1500, 8, 8),
         (2, 16, 1000, "random", "zero", 1000, 256, 2),
         (2, 16, 4096, "random", "random", 8192, 256, 32),
         (2, 16, 4096, "dups", "random", 9000, 256, 64),
         (2, 4, 5000, "presorted", "full", 20000, 256, 64),
         (2, 16, 300, "random", "full", 1000, 256, 2),
         (2, 16, 64, "dups", "random", 999, 1024, 4),
         (1, 64, 50, "dups", "random", 3000, 16, 16),
         (2, 8, 40, "extremes", "random", 333, 1, 32)]


def _kway_inputs(dev, k, v, cap, kind, cnt_kind, seed):
    """Sorted buckets whose lanes past the counts hold random words, laid
    out as the merge stage finds them: a [k, v, cap] view of wider rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "presorted":
        b = torch.arange(k * v * cap, device=dev, dtype=torch.int32)
        b = b.reshape(k, v, cap)
    else:
        b = torch.sort(_keys((k, v, cap), dev, seed, kind), dim=-1).values
    cnt = {"random": torch.randint(0, cap + 1, (k, v), generator=g,
                                   device=dev, dtype=torch.int32),
           "full": torch.full((k, v), cap, device=dev, dtype=torch.int32),
           "zero": torch.zeros((k, v), device=dev, dtype=torch.int32)}[
               cnt_kind]
    if cnt_kind == "random":
        cnt[0, 0], cnt[-1, -1] = 0, cap
    lane = torch.arange(cap, device=dev)
    b = torch.where(lane < cnt[..., None], b, _keys((k, v, cap), dev, seed + 1))
    rows = torch.zeros((k, v * cap + v + 40), dtype=torch.int32, device=dev)
    rows[:, 24:24 + v * cap] = b.reshape(k, -1)
    rows[:, 24 + v * cap:24 + v * cap + v] = cnt
    return (rows[:, 24:24 + v * cap].view(k, v, cap),
            rows[:, 24 + v * cap:24 + v * cap + v])


@pytest.mark.parametrize("case", _KWAY, ids=str)
def test_kway_merge_kernels_match_plain(cuda, case):
    k, v, cap, kind, cnt_kind, rcap, tile, S = case
    km = _kernel("kway_merge")
    b, cnt = _kway_inputs(cuda, k, v, cap, kind, cnt_kind, v * cap + rcap)
    ranks = km.coarse_ranks(rcap, tile, S, v * cap, cuda)
    before = km.SPLIT_LAUNCHES, km.SEGMENT_LAUNCHES
    starts = km.exact_splitters(b, cnt, ranks)
    got = km.merge_segments(b, cnt, starts, rcap=rcap, tile=tile,
                            seg_tiles=S)
    torch.cuda.synchronize()
    assert (km.SPLIT_LAUNCHES, km.SEGMENT_LAUNCHES) == (before[0] + 1,
                                                       before[1] + 1)
    assert torch.equal(starts, km.exact_splitters_plain(b, cnt, ranks))
    assert torch.equal(got, km.merge_segments_plain(
        b, cnt, starts, rcap=rcap, tile=tile, seg_tiles=S))
    from repro_torch.kernels.kway_merge import kway_merge, kway_merge_ref
    assert torch.equal(got, kway_merge_ref(b, cnt, rcap=rcap, fill=INT_MAX))
    merged, _, _ = kway_merge(b, cnt, rcap=rcap, tile=tile, fill=INT_MAX)
    assert torch.equal(merged, got)


@pytest.mark.parametrize("case", _KWAY, ids=str)
def test_kway_merge_kernels_take_uint32_buckets(cuda, case):
    """The same edges in uint32 (fill 0xFFFFFFFF): keys at and past 2^31
    sort after the rest; the kernels read the uint32 words as they lie."""
    k, v, cap, kind, cnt_kind, rcap, tile, S = case
    km = _kernel("kway_merge")
    b, cnt = _kway_inputs(cuda, k, v, cap, kind, cnt_kind, v * cap + rcap)
    b = _u32_buckets(b, cnt)
    ranks = km.coarse_ranks(rcap, tile, S, v * cap, cuda)
    before = km.SPLIT_LAUNCHES, km.SEGMENT_LAUNCHES
    starts = km.exact_splitters(b, cnt, ranks)
    got = km.merge_segments(b, cnt, starts, rcap=rcap, tile=tile,
                            seg_tiles=S)
    torch.cuda.synchronize()
    assert (km.SPLIT_LAUNCHES, km.SEGMENT_LAUNCHES) == (before[0] + 1,
                                                       before[1] + 1)
    assert got.dtype == torch.uint32
    assert torch.equal(starts, km.exact_splitters_plain(b, cnt, ranks))
    plain = km.merge_segments_plain(b, cnt, starts, rcap=rcap, tile=tile,
                                    seg_tiles=S)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    from repro_torch.kernels.kway_merge import kway_merge, kway_merge_ref
    ref = kway_merge_ref(b, cnt, rcap=rcap, fill=2**32 - 1)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    merged, _, _ = kway_merge(b, cnt, rcap=rcap, tile=tile, fill=2**32 - 1)
    assert torch.equal(merged.view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("tile", [8, 256, 1024, 2048])
def test_tile_kernel_takes_uint32_tiles(cuda, tile):
    km = _kernel("kway_merge")
    t = _keys((max(1, (1 << 16) // tile), tile), cuda, tile).view(
        torch.uint32)
    before = km.LAUNCHES
    got = km.merge_tile_grid(t)
    torch.cuda.synchronize()
    assert km.LAUNCHES == before + 1 and got.dtype == torch.uint32
    assert torch.equal(got.view(torch.int32),
                       km.sort_tile_rows(t).view(torch.int32))


def test_kway_merge_wrappers_reject_what_the_kernels_do_not_take(cuda):
    km = _kernel("kway_merge")
    b = torch.zeros((2, 4, 16), dtype=torch.int32, device=cuda)
    cnt = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    ranks = km.coarse_ranks(64, 8, 2, 64, cuda)
    starts = km.exact_splitters(b, cnt, ranks)
    before = km.SPLIT_LAUNCHES, km.SEGMENT_LAUNCHES
    with pytest.raises(TypeError, match="int32"):
        km.exact_splitters(b.float(), cnt, ranks)
    with pytest.raises(ValueError, match="contiguous"):
        km.exact_splitters(b.transpose(1, 2).contiguous().transpose(1, 2),
                           cnt, ranks)
    with pytest.raises(ValueError, match="int64"):
        km.exact_splitters(b, cnt, ranks.to(torch.int32))
    with pytest.raises(ValueError, match="do not fit"):
        km.merge_segments(b, cnt, starts, rcap=64, tile=1 << 16, seg_tiles=1)
    with pytest.raises(ValueError, match="starts"):
        km.merge_segments(b, cnt, starts[:, :-1], rcap=64, tile=8,
                          seg_tiles=2)
    assert (km.SPLIT_LAUNCHES, km.SEGMENT_LAUNCHES) == before


@pytest.mark.parametrize("v, ww", [(1, 1), (3, 100), (4, 129), (16, 1000)])
@pytest.mark.parametrize("fill", [None, INT_MAX])
def test_deliver_kernel_matches_plain(cuda, v, ww, fill):
    dv = _kernel("alltoallv_deliver")
    src = _keys((v, v * ww + 7), cuda, v * ww)
    cnt = torch.randint(-2, ww + 3, (v, v + 2), device=cuda,
                        dtype=torch.int32)
    outs = []
    for fn in (dv.deliver_words, dv.deliver_words_plain):
        dst = torch.zeros((v, v * ww + 10), dtype=torch.int32, device=cuda)
        ct = torch.zeros((v, v + 3), dtype=torch.int32, device=cuda)
        fn(src, 7, dst, 10, v, ww, None if fill is None else cnt, 2, fill,
           cnt, 1, ct, 3)
        outs += [dst, ct]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])


def test_psrs_on_the_card_matches_the_cpu_and_launches_every_kernel(cuda):
    from repro_torch.pems_apps import psrs_sort

    mods = [_kernel(n) for n in ("bitonic_sort", "kway_merge",
                                 "alltoallv_deliver")]
    keys = _keys((1 << 16,), cuda, 7, "dups")
    bs, km, dv = mods
    bs.LAUNCHES = dv.LAUNCHES = 0
    km.SPLIT_LAUNCHES = km.SEGMENT_LAUNCHES = 0
    for driver in ("explicit", "sliced", "async"):
        got = psrs_sort(keys, v=16, k=4, driver=driver)
        assert got.device.type == "cuda"
        assert torch.equal(got, torch.sort(keys).values)
    # The merge stage runs the fused merge: the splitters and the segments.
    assert all(c > 0 for c in (bs.LAUNCHES, dv.LAUNCHES, km.SPLIT_LAUNCHES,
                               km.SEGMENT_LAUNCHES))
    cpu = psrs_sort(keys.cpu(), v=16, k=4, device="cpu")
    assert torch.equal(got.cpu(), cpu)


# (m, P, nq, s0, s, c0, d, ww): P of 1, 2 and 4, ragged ω and ω past one
# block's 1024-word chunk, α-chunk offsets s0, c0 != 0.
_ASSEMBLE = [(1, 1, 1, 0, 1, 0, 1, 1), (4, 2, 2, 0, 4, 0, 4, 127),
             (4, 4, 4, 2, 2, 1, 1, 300), (4, 4, 3, 1, 3, 2, 2, 1030),
             (2, 4, 4, 0, 2, 0, 2, 1)]


@pytest.mark.parametrize("m, P, nq, s0, s, c0, d, ww", _ASSEMBLE)
@pytest.mark.parametrize("fill", [None, -7, INT_MAX])
@pytest.mark.parametrize("with_payload", [False, True])
def test_assemble_kernel_matches_plain(cuda, m, P, nq, s0, s, c0, d, ww,
                                       fill, with_payload):
    dv = _kernel("alltoallv_deliver")
    v = m * P
    src = _keys((v, 9 + v * ww), cuda, v * ww)
    # Counts of 0, of ω, past ω and negative.
    cnt = torch.randint(-2, ww + 3, (v, v + 4), device=cuda,
                        dtype=torch.int32)
    cnt[0, 4:8] = torch.tensor([0, ww, ww + 5, -3], device=cuda)[:v]
    outs = []
    for fn in (dv.assemble_words, dv.assemble_words_plain):
        out = torch.zeros(nq * P * d * s * ww, dtype=torch.int32,
                          device=cuda)
        ct = (torch.zeros(nq * P * d * s, dtype=torch.int32, device=cuda)
              if with_payload else None)
        fn(src, 9, m, P, nq, s0, s, c0, d, ww, out,
           None if fill is None else cnt, 4, fill,
           cnt if with_payload else None, 4, ct)
        outs += [out, ct]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[2])
    if with_payload:
        assert torch.equal(outs[1], outs[3])


# (send offset, recv offset) mod 4 over a row stride of 2 mod 4 words, as
# the PSRS store has it: every head and the 16-, 8- and 4-byte loads.
_PHASES = [(0, 0), (1, 3), (2, 2), (3, 1), (2, 0), (1, 1)]


@pytest.mark.parametrize("m, P, nq, s0, s, c0, d, ww", _ASSEMBLE)
@pytest.mark.parametrize("layout", ["buffer", "rows"])
@pytest.mark.parametrize("phases", _PHASES)
@pytest.mark.parametrize("fill, with_payload", [(None, False), (-7, True),
                                                (INT_MAX, False)])
def test_assemble_kernel_matches_plain_in_both_layouts_at_every_phase(
        cuda, m, P, nq, s0, s, c0, d, ww, layout, phases, fill, with_payload):
    """The destination either a buffer starting off a 16-byte boundary or
    the recv rows of the store the chunk reads; exact."""
    dv = _kernel("alltoallv_deliver")
    v, (ps, pr) = m * P, phases
    off_s = 4 + ps
    off_r = off_s + v * ww + (pr - ps - v * ww) % 4 + 4
    off_c = off_r + v * ww
    W = off_c + 2 * v + 1
    W += (2 - W) % 4
    gen = torch.Generator(device=cuda).manual_seed(v * ww + ps)
    store = _keys((v, W), cuda, v * ww + pr)
    cnt = torch.randint(-2, ww + 3, (v, v), generator=gen, device=cuda,
                        dtype=torch.int32)
    cnt.view(-1)[:4] = torch.tensor([0, ww, ww + 5, -3], device=cuda)[:v * v]
    store[:, off_c:off_c + v] = cnt
    outs = []
    for fn in (dv.assemble_words, dv.assemble_words_plain):
        st = store.clone()
        if layout == "rows":
            rows = st[:, off_r:off_r + v * ww].view(P, m, P, m, ww)
            rc = st[:, off_c + v:off_c + 2 * v].view(P, m, P, m)
            out = rows[:, c0:c0 + d, :nq, s0:s0 + s].permute(2, 0, 1, 3, 4)
            ct = rc[:, c0:c0 + d, :nq, s0:s0 + s].permute(2, 0, 1, 3)
        else:
            n = nq * P * d * s
            out = torch.zeros(pr + n * ww, dtype=torch.int32,
                              device=cuda)[pr:]
            ct = torch.zeros(n, dtype=torch.int32, device=cuda)
        fn(st, off_s, m, P, nq, s0, s, c0, d, ww, out,
           None if fill is None else st, off_c, fill,
           st if with_payload else None, off_c, ct if with_payload else None)
        outs.append((st, out, ct))
    torch.cuda.synchronize()
    (st_k, out_k, ct_k), (st_p, out_p, ct_p) = outs
    assert torch.equal(st_k, st_p) and torch.equal(out_k, out_p)
    assert torch.equal(ct_k, ct_p)


def test_psrs_at_P4_on_the_card_matches_P1_and_launches_kernel_4(cuda):
    from repro_torch.core import make_mesh
    from repro_torch.pems_apps import psrs_sort

    dv = _kernel("alltoallv_deliver")
    keys = _keys((1 << 20,), cuda, 9)
    want = psrs_sort(keys, v=16, k=2)
    assert torch.equal(want, torch.sort(keys).values)
    for driver, alpha in (("async", None), ("explicit", 1), ("sliced", 2)):
        dv.ASSEMBLE_LAUNCHES = 0
        got, pems = psrs_sort(keys, v=16, k=2, P=4, mesh=make_mesh(4),
                              alpha=alpha, driver=driver, return_pems=True)
        assert torch.equal(got, want)
        assert dv.ASSEMBLE_LAUNCHES == pems.ledger.network_rounds > 0


def _cards(n: int):
    """``Mesh(["cuda:0", ..., f"cuda:{n - 1}"])``; skips with the reason on
    a machine with fewer cards."""
    from repro_torch.core import Mesh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    have = torch.cuda.device_count()
    if have < n:
        pytest.skip(f"needs {n} CUDA cards for a mesh of cards, {have} "
                    "visible")
    return Mesh([f"cuda:{i}" for i in range(n)])


def _psrs_store(keys, v, **kw):
    """``(sorted keys, final store words on the first card, pems)``."""
    from repro_torch.core.context import MeshStore
    from repro_torch.pems_apps import psrs_plan
    from repro_torch.pems_apps.psrs import _result_fields, _sorted_keys

    pems, load, steps, _ = psrs_plan(v, keys.numel() // v, **kw)
    store = load(keys.reshape(v, -1))
    for _, step in steps:
        store = step(store)
    pems.synchronize()
    words = store.gather() if isinstance(store, MeshStore) else store.data
    return _sorted_keys(_result_fields(store)), words, pems


@pytest.mark.parametrize("driver, alpha", [("async", None), ("explicit", 1)])
def test_cards_route_forced_on_one_card_matches_the_fused_route(
        cuda, monkeypatch, driver, alpha):
    """The mesh-of-cards route forced onto four blocks of one card: the
    sorted keys and every final store word equal the one-card fused
    route's, and kernel 4 stages once a sender a chunk."""
    from repro_torch.core import Mesh, analysis, make_mesh

    dv = _kernel("alltoallv_deliver")
    keys = _keys((1 << 18,), cuda, 12)
    kw = dict(k=2, P=4, alpha=alpha, driver=driver)
    want, want_words, _ = _psrs_store(keys, 16, mesh=make_mesh(4), **kw)
    monkeypatch.setattr(Mesh, "spans_devices", True)
    dv.ASSEMBLE_LAUNCHES = 0
    got, words, pems = _psrs_store(keys, 16, mesh=make_mesh(4), **kw)
    assert pems.cards
    assert torch.equal(got, want) and torch.equal(got, torch.sort(keys).values)
    assert torch.equal(words, want_words)
    assert dv.ASSEMBLE_LAUNCHES == 4 * (
        analysis.pems2_alltoallv_par_network_rounds(16, 4, 2, alpha))


@pytest.mark.parametrize("n", [2, 4])
def test_psrs_over_a_mesh_of_cards_matches_one_card(cuda, n):
    """Each block on its own card, and the sorted keys, every final store
    word and the ledger equal the one-card mesh's."""
    from repro_torch.core import make_mesh

    mesh = _cards(n)
    keys = _keys((1 << 18,), cuda, 13)
    for driver, alpha in (("async", None), ("explicit", 1), ("sliced", 2)):
        kw = dict(k=2, P=n, alpha=alpha, driver=driver)
        want, want_words, one = _psrs_store(keys, 16, mesh=make_mesh(n),
                                            **kw)
        got, words, pems = _psrs_store(keys, 16, mesh=mesh, **kw)
        assert torch.equal(got, want)
        assert torch.equal(words, want_words)
        assert pems.ledger.snapshot() == one.ledger.snapshot()
    store = pems.init()
    assert [b.device for b in store.blocks] == list(mesh.devices)


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_over_a_mesh_of_cards_match_one_card(cuda, n):
    """Every Alltoallv route and the five collectives over cards equal the
    one-card mesh's bit for bit (float32 sums included)."""
    from repro_torch import interop
    from repro_torch.core import ContextLayout, Pems, PemsConfig, make_mesh

    mesh = _cards(n)
    v, w = 16, 1000
    g = torch.Generator().manual_seed(18)
    lo = (ContextLayout().add("x", (w,), torch.float32)
          .add("i", (w,), torch.int32).add("o", (w,), torch.float32)
          .add("m", (w,), torch.int32).add("g", (v, w), torch.float32)
          .add("s", (v, 5), torch.int32).add("r", (v, 5), torch.int32)
          .add("sc", (v,), torch.int32).add("rc", (v,), torch.float32)
          .add("gi", (v, w), torch.int32))
    words = torch.randint(0, 2**32, (v, lo.words), generator=g,
                          dtype=torch.int64).to(torch.uint32).numpy()
    words[:, :w] = torch.randn((v, w), generator=g).numpy().view("uint32")
    sc = lo.offset("sc")
    words[:, sc:sc + v] = torch.randint(-1, 7, (v, v), generator=g).to(
        torch.int32).numpy().view("uint32")
    got = {}
    for where in (make_mesh(n), mesh):
        out = []
        for alpha, mode, uk in ((None, "direct", True), (1, "direct", True),
                                (2, "indirect", True), (1, "direct", False)):
            pems = Pems(PemsConfig(v=v, k=2, P=n, alpha=alpha), lo,
                        mesh=where, device=cuda)
            store = interop.store_from_numpy(lo, words, mesh=where)
            store = pems.alltoallv(store, "s", "r", "sc", "rc", mode=mode,
                                   fill=-9, use_kernel=uk)
            store = pems.alltoallv(store, "s", "s", "sc", "sc", fill=5,
                                   use_kernel=uk)
            store = pems.bcast(store, "i", root=5)
            store = pems.gather(store, "i", "gi", root=3)
            store = pems.allgather(store, "x", "g")
            store = pems.reduce(store, "x", "o", op="add", root=9)
            store = pems.reduce(store, "i", "m", op="max", root=2)
            store = pems.allreduce(store, "x", "o", op="add")
            store = pems.allreduce(store, "i", "m", op="min")
            out.append((interop.store_to_numpy(store),
                        pems.ledger.snapshot()))
        got[where.spans_devices] = out
    for (a, la), (b, lb) in zip(got[False], got[True]):
        np.testing.assert_array_equal(a, b)
        assert la == lb


def test_a_launch_on_another_card_keeps_the_current_device(cuda):
    """A kernel entry sets its card current (``cudaSetDevice``); the launch
    wrapper sets the caller's back."""
    bs = _kernel("bitonic_sort")
    _cards(2)
    torch.cuda.set_device(0)
    x = _keys((4, 1 << 14), torch.device("cuda:1"), 14)
    got = bs.bitonic_sort_rows(x)
    assert torch.cuda.current_device() == 0
    assert torch.equal(got, torch.sort(x, dim=-1).values)


@pytest.mark.parametrize("tier, driver, P", [
    ("host", "async", 1), ("memmap", "sliced", 1), ("file", "async", 2),
    ("file", "explicit", 1)])
def test_tiered_psrs_on_the_card_matches_the_cpu_and_launches_kernels(
        cuda, tmp_path, tier, driver, P):
    """A backing tier on the card: each round's block runs the local sort
    and the merge's splitters and segments as on the device tier, and the
    run gives the CPU run's output, store words, ledgers and deterministic
    stats; the result comes back on the CPU."""
    from repro_torch.pems_apps import psrs_sort

    bs, km = _kernel("bitonic_sort"), _kernel("kway_merge")
    keys = _keys((1 << 16,), cuda, 11)
    runs = []
    for i, dev in enumerate(("cpu", cuda)):
        bs.LAUNCHES = km.SPLIT_LAUNCHES = km.SEGMENT_LAUNCHES = 0
        path = None if tier == "host" else str(tmp_path / f"{i}.bin")
        out, pems = psrs_sort(keys.to(dev), v=16, k=2, P=P, tier=tier,
                              driver=driver, backing_path=path, device=dev,
                              return_pems=True)
        assert out.device.type == "cpu"
        st = [(s.rounds, s.merge_prefetch_events, s.peak_stage_bytes)
              for s in pems.shard_stats]
        runs.append((out, pems.backing.read_block(0, 16),
                     [led.snapshot() for led in pems.shard_ledgers], st))
    assert torch.equal(runs[1][0], torch.sort(keys).values.cpu())
    assert torch.equal(runs[1][0], runs[0][0])
    assert (runs[1][1] == runs[0][1]).all()
    assert runs[1][2:] == runs[0][2:]
    assert all(c > 0 for c in (bs.LAUNCHES, km.SPLIT_LAUNCHES,
                               km.SEGMENT_LAUNCHES))


def test_tiered_async_writeback_waits_for_its_pinned_buffer(cuda, tmp_path):
    """tests/test_torch_tiered.py's aliasing case on the card, where the
    writeback reads a pinned buffer the next round's device-to-host copy
    would refill: every write slowed, one request in flight at a time."""
    import time

    from repro_torch.pems_apps import psrs_plan

    v, n_v = 16, 64
    keys = _keys((v * n_v,), cuda, 12)
    pems, load, steps, extract = psrs_plan(
        v, n_v, k=1, driver="async", tier="file", io_queue_depth=1,
        backing_path=str(tmp_path / "slow.bin"), device=cuda)
    store = load(keys.reshape(v, n_v))
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
    assert torch.equal(out, torch.sort(keys).values.cpu())


def test_recoverable_psrs_killed_on_the_card_resumes_there(cuda, tmp_path):
    """A recoverable file-tier run on the card, killed (kill -9, with its
    CUDA context live) in the merge stage in a child; a fresh child resumes
    it on the card, and the resume here reruns nothing."""
    import _chaos
    from repro_torch.pems_apps import psrs_run_recoverable

    sd = str(tmp_path / "state")
    _chaos.assert_killed(_chaos.run_child(sd, kind="in", stage="merge",
                                          device="cuda"))
    _chaos.assert_ok(_chaos.run_child(sd, device="cuda"))
    keys = torch.from_numpy(_chaos.keys())
    bs, km = _kernel("bitonic_sort"), _kernel("kway_merge")
    bs.LAUNCHES = km.SEGMENT_LAUNCHES = 0
    out = psrs_run_recoverable(keys, v=_chaos.V, k=_chaos.K, state_dir=sd,
                               io_queue_depth=4, device=cuda)
    assert torch.equal(out, torch.sort(keys).values)
    assert bs.LAUNCHES == km.SEGMENT_LAUNCHES == 0


def test_checksummed_recoverable_run_on_the_card_matches_the_cpu(
        cuda, tmp_path):
    """Checksums on, the file tier, the card against the CPU: the same
    output, the same backing and sidecar bytes, and the local sort and
    merge kernels launched once a round."""
    from repro_torch.pems_apps import psrs_run_recoverable

    bs, km = _kernel("bitonic_sort"), _kernel("kway_merge")
    keys = _keys((1 << 16,), cuda, 13).cpu()
    files = []
    for dev in ("cpu", cuda):
        bs.LAUNCHES = km.SPLIT_LAUNCHES = km.SEGMENT_LAUNCHES = 0
        sd = tmp_path / str(dev)
        out = psrs_run_recoverable(keys, v=16, k=2, state_dir=str(sd),
                                   driver="async", checksums=True,
                                   device=dev)
        assert torch.equal(out, torch.sort(keys).values)
        files.append([(sd / f).read_bytes()
                      for f in ("ctx.bin", "ctx.bin.crc", "cursor.json")])
    assert files[1] == files[0]
    assert bs.LAUNCHES == km.SPLIT_LAUNCHES == km.SEGMENT_LAUNCHES == 8


@pytest.mark.parametrize("tier, driver", [
    ("device", "explicit"), ("device", "sliced"), ("device", "async"),
    ("host", "sliced"), ("file", "async")])
def test_prefix_sum_on_the_card_matches_the_cpu(cuda, tmp_path, tier,
                                                driver):
    """The prefix sum of full-range keys (the sums wrap) on the card: the
    CPU run's output and ledger, on the device tier and on a backing tier
    with k = 2 of 16 contexts on the card."""
    from repro_torch.pems_apps import prefix_sum

    x = _keys((1 << 16,), cuda, 14)
    want = torch.cumsum(x.to(torch.int64), 0).to(torch.int32)
    runs = []
    for i, dev in enumerate((cuda, "cpu")):
        path = None if tier != "file" else str(tmp_path / f"{i}.bin")
        out, pems = prefix_sum(x.to(dev), v=16, k=2, driver=driver,
                               tier=tier, backing_path=path, device=dev,
                               return_pems=True)
        runs.append((out.cpu(), pems.ledger.snapshot()))
    assert torch.equal(runs[0][0], want.cpu())
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]


@pytest.mark.parametrize("mode, driver", [
    ("direct", "explicit"), ("direct", "async"), ("indirect", "sliced")])
def test_list_rank_on_the_card_matches_the_cpu(cuda, mode, driver):
    """List ranking on the card: the CPU run's ranks and ledger, and in
    direct mode two launches of the delivery kernel a round."""
    import math

    from repro_torch.pems_apps import list_rank

    dv = _kernel("alltoallv_deliver")
    n = 1 << 12
    g = torch.Generator().manual_seed(15)
    perm = torch.randperm(n, generator=g)
    succ = torch.empty(n, dtype=torch.int64)
    succ[perm[:-1]] = perm[1:]
    succ[perm[-1]] = perm[-1]                 # one list through them all
    want = torch.empty(n, dtype=torch.int32)
    want[perm] = torch.arange(n - 1, -1, -1, dtype=torch.int32)
    dv.LAUNCHES = 0
    got, gp = list_rank(succ.to(cuda), v=16, k=4, mode=mode, driver=driver,
                        return_pems=True, device=cuda)
    launches = dv.LAUNCHES
    ref, cp = list_rank(succ, v=16, k=4, mode=mode, driver=driver,
                        device="cpu", return_pems=True)
    assert torch.equal(got.cpu(), want) and torch.equal(ref, want)
    assert gp.ledger.snapshot() == cp.ledger.snapshot()
    rounds = math.ceil(math.log2(n))
    assert launches == (2 * rounds if mode == "direct" else 0)


def test_euler_tour_on_the_card_matches_the_cpu(cuda):
    """The Euler tour of a forest on the card: the CPU run's five arrays
    bit for bit, with the local sort, the merge and the delivery kernels
    launched."""
    import numpy as np

    from repro_torch.pems_apps import euler_tour

    rng = np.random.default_rng(16)
    n = 3000
    parent = np.arange(n)
    parent[4:] = rng.integers(0, np.arange(4, n))
    bs, km, dv = (_kernel(m) for m in ("bitonic_sort", "kway_merge",
                                       "alltoallv_deliver"))
    bs.LAUNCHES = km.SPLIT_LAUNCHES = km.SEGMENT_LAUNCHES = dv.LAUNCHES = 0
    got = euler_tour(parent, v=16, k=4, device=cuda)
    assert all(c > 0 for c in (bs.LAUNCHES, km.SPLIT_LAUNCHES,
                               km.SEGMENT_LAUNCHES, dv.LAUNCHES))
    ref = euler_tour(parent, v=16, k=4, device="cpu")
    for key, want in ref.items():
        assert got[key].device.type == "cuda"
        assert torch.equal(got[key].cpu(), want), key


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32, torch.float32])
@pytest.mark.parametrize("tier, P", [("device", 1), ("device", 4),
                                     ("host", 1), ("host", 2)])
def test_collectives_on_the_card_match_the_cpu(cuda, dtype, tier, P):
    """allgather, reduce and allreduce on the card: integer results equal
    the CPU run's, float32 sums within 1e-6 of the sum of their terms'
    magnitudes (16 float32 additions in any order stay within 15·2^-24 of
    it); the ledger equals the CPU run's; a backing tier's results equal
    the card's device tier's bit for bit."""
    from repro_torch.core import ContextLayout, Pems, PemsConfig, make_mesh

    v, w = 16, 1000
    g = torch.Generator().manual_seed(17)
    x = (torch.randn((v, w), generator=g) if dtype == torch.float32 else
         torch.randint(INT_MIN, INT_MAX + 1, (v, w), generator=g,
                       dtype=torch.int64).to(torch.int32).view(dtype))
    lo = (ContextLayout().add("x", (w,), dtype).add("o", (w,), dtype)
          .add("g", (v, w), dtype))
    words = {}
    for where, t, p in ((cuda, tier, P), ("cpu", tier, P),
                        (cuda, "device", 1)):
        mesh = make_mesh(p, device=where) if t == "device" and p > 1 \
            else None
        pems = Pems(PemsConfig(v=v, k=2, P=p, tier=t), lo, mesh=mesh,
                    device=where)
        store = pems.init().with_field("x", x.to(where))
        outs = []
        for op in ("add", "max", "min"):
            store = pems.allgather(store, "x", "g")
            store = pems.reduce(store, "x", "o", op=op, root=3)
            outs.append(store.field("o")[3].cpu().clone())
            store = pems.allreduce(store, "x", "o", op=op)
            outs.append(store.field("o").cpu().clone())
        outs.append(store.field("g").cpu().clone())
        words[(str(where), t, p)] = (outs, pems.ledger.snapshot())
    card, cpu = words[(str(cuda), tier, P)], words[("cpu", tier, P)]
    assert card[1] == cpu[1]
    for i, (a, b) in enumerate(zip(card[0], cpu[0])):
        if dtype == torch.float32 and i in (0, 1):
            assert ((a - b).abs() <= 1e-6 * x.abs().sum(0)).all()
        else:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), i
    for a, b in zip(card[0], words[(str(cuda), "device", 1)][0]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("tier, P", [("device", 1), ("device", 4),
                                     ("file", 1), ("file", 2)])
def test_traced_psrs_on_the_card_matches_untraced(cuda, tmp_path, tier, P):
    """Tracing on the card: the keys and every ledger counter equal the
    untraced run's, and each stage span begins and ends on a drained
    stream, so ``sort_sample``'s lasts at least its local-sort launches'
    CUDA-event time; on the file tier the report's overlap is
    TierStats'."""
    from repro_torch.core import make_mesh
    from repro_torch.kernels.bitonic_sort import bitonic_sort
    from repro_torch.obs import load_trace, summarize
    from repro_torch.pems_apps import psrs_sort

    keys = _keys((1 << 20,), cuda, 11)
    events = []

    def timed_sort(x):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        y = bitonic_sort(x)
        b.record()
        events.append((a, b))
        return y

    kw = dict(v=16, k=2, P=P, driver="async", device=cuda, tier=tier,
              return_pems=True, local_sort=timed_sort)
    if tier == "device" and P > 1:
        kw["mesh"] = make_mesh(P, device=cuda)
    runs = []
    for trace in (False, True):
        events.clear()
        tp = str(tmp_path / f"t{trace}.json")
        extra = dict(trace=True, trace_path=tp) if trace else {}
        if tier == "file":
            extra["backing_path"] = str(tmp_path / f"b{trace}.bin")
        out, pems = psrs_sort(keys, **kw, **extra)
        runs.append((out.cpu(), pems.merged_shard_ledger().snapshot()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[1][0], torch.sort(keys).values.cpu())
    assert runs[0][1] == runs[1][1]
    trace = load_trace(tp)
    stage = {e["name"]: e["dur"] / 1e3 for e in trace["traceEvents"]
             if e.get("cat") == "stage"}
    assert len(stage) == 7
    kernel_ms = sum(a.elapsed_time(b) for a, b in events)
    assert stage["stage:sort_sample"] >= kernel_ms > 0
    if tier == "file":
        s = summarize(trace)
        assert abs(s["overlap_fraction"] - s["metrics_overlap"]) <= 1e-9


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    bs = _kernel("bitonic_sort")
    with pytest.raises(TypeError, match="float64"):
        bs.bitonic_sort_rows(torch.zeros((2, 8), device=cuda,
                                         dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        bs.bitonic_sort_rows(
            torch.zeros((8, 2), dtype=torch.int32, device=cuda).t())


# --------------------------------------------------------------------------- #
# The serving path's float kernels: flash attention and the SSD scan.         #
# fp32 cases compare within atol 1e-5 (the kernels sum in another order);     #
# bf16 outputs within 2^-10 + 2^-7 |plain|: kernel and plain both sum in fp32 #
# and round once to bf16 (the kernel's P enters P·V as bf16 hi + lo, exact to #
# about 2^-16), so they differ by one bf16 ulp at most.                       #
# --------------------------------------------------------------------------- #

# (b, sq, sk, hq, hkv, d, causal, sk_valid, q_offset, dtype)
_ATTN = [
    (2, 128, 150, 12, 2, 128, True, 128, 0, torch.bfloat16),
    (8, 1, 300, 12, 2, 128, True, 201, 200, torch.bfloat16),
    (1, 1, 1096, 12, 2, 128, False, 1061, 0, torch.bfloat16),
    (2, 128, 150, 12, 2, 128, True, 128, 0, torch.float32),
    (8, 1, 1096, 12, 2, 128, True, 1062, 1061, torch.float32),
    (2, 37, 37, 4, 2, 16, True, 37, 0, torch.float32),
    (2, 100, 130, 6, 1, 64, True, 90, 0, torch.float32),
    (3, 5, 70, 2, 2, 32, False, 33, 0, torch.float32),
    (1, 3, 80, 4, 1, 32, True, 61, 58, torch.float32),
    (1, 1, 100, 6, 1, 64, False, 0, 0, torch.float32),
    # bf16 on the tensor cores: ragged row counts (74, 600, 5, 12, 420),
    # groups 1, 2, 4, 6 and head dims 16, 32, 64, 128; sk_valid 0; a decode
    # call split over the keys whose causal end (position 50) leaves every
    # split past the first unseen (l = 0 into the merge).
    (2, 37, 37, 4, 2, 16, True, 37, 0, torch.bfloat16),
    (2, 100, 130, 6, 1, 64, True, 90, 0, torch.bfloat16),
    (3, 5, 70, 2, 2, 32, False, 33, 0, torch.bfloat16),
    (1, 3, 80, 4, 1, 32, True, 61, 58, torch.bfloat16),
    (1, 1, 100, 6, 1, 64, False, 0, 0, torch.bfloat16),
    (2, 70, 150, 12, 2, 128, True, 76, 5, torch.bfloat16),
    (2, 1, 320, 6, 1, 128, True, 300, 50, torch.bfloat16),
]


@pytest.mark.parametrize("case", _ATTN, ids=str)
def test_flash_attention_kernel_matches_plain(cuda, case):
    b, sq, sk, hq, hkv, d, causal, sk_valid, q_offset, dtype = case
    fa = _kernel("flash_attention")
    g = torch.Generator(device=cuda).manual_seed(sq * sk)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    before = fa.LAUNCHES
    got = fa.attend(q, k, v, causal=causal, sk_valid=sk_valid,
                    q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want = fa.attend_plain(q, k, v, causal=causal, sk_valid=sk_valid,
                           q_offset=q_offset)
    rtol, atol = (0, 1e-5) if dtype == torch.float32 else (2**-7, 2**-10)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


# (b, sq, sk, hq, hkv, d, causal, sk_valid, q_offset, window, dtype): the
# sliding window at recurrentgemma's heads (10 of 256 over one KV head) and
# smaller ones.  Decode calls cut the live keys into splits; the first split
# holds the window's first key, and in the fp32 call with 4 query rows the
# second row tile sees no key of the first split (l = 0 in the merge).
_WINDOWED = [
    (2, 64, 80, 10, 1, 256, True, 80, 0, 16, torch.bfloat16),
    (2, 70, 90, 4, 1, 256, True, 90, 20, 16, torch.float32),
    (8, 1, 3144, 10, 1, 256, True, 3108, 3107, 2048, torch.bfloat16),
    (8, 1, 3144, 10, 1, 256, True, 3108, 3107, 2048, torch.float32),
    (4, 1, 700, 10, 1, 256, True, 650, 649, 300, torch.bfloat16),
    (1, 4, 110, 10, 1, 256, True, 104, 100, 8, torch.float32),
    (1, 1, 40, 10, 1, 256, True, 40, 39, 64, torch.float32),
    (2, 33, 80, 6, 2, 64, False, 70, 10, 20, torch.float32),
    (1, 40, 40, 2, 2, 16, True, 40, 0, 1, torch.float32),
    # bf16: window edges inside a key tile, ragged row counts (280, 198,
    # 40, 600), groups 1, 3, 4, 6 and 10, head dims 16, 64, 128 and 256; in
    # the call with 8 query rows of 10 heads, the second row tile sees no
    # key of the first split.
    (2, 70, 90, 4, 1, 256, True, 90, 20, 16, torch.bfloat16),
    (1, 8, 120, 10, 1, 256, True, 108, 100, 8, torch.bfloat16),
    (1, 4, 110, 10, 1, 256, True, 104, 100, 8, torch.bfloat16),
    (1, 1, 40, 10, 1, 256, True, 40, 39, 64, torch.bfloat16),
    (2, 33, 80, 6, 2, 64, False, 70, 10, 20, torch.bfloat16),
    (1, 40, 40, 2, 2, 16, True, 40, 0, 1, torch.bfloat16),
    (2, 50, 200, 12, 2, 128, True, 200, 150, 37, torch.bfloat16),
]


@pytest.mark.parametrize("case", _WINDOWED, ids=str)
def test_windowed_flash_attention_kernel_matches_plain(cuda, case):
    b, sq, sk, hq, hkv, d, causal, sk_valid, q_offset, window, dtype = case
    fa = _kernel("flash_attention")
    g = torch.Generator(device=cuda).manual_seed(sq * sk + window)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    kw = dict(causal=causal, sk_valid=sk_valid, q_offset=q_offset,
              window=window)
    before = fa.LAUNCHES
    got = fa.attend(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want = fa.attend_plain(q, k, v, **kw)
    rtol, atol = (0, 1e-5) if dtype == torch.float32 else (2**-7, 2**-10)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


# (b, sq, sk, hq, hkv, d, sk_valid, q_offset, window, prefix, dtype): the
# prefix-LM mask (paligemma's patches) on both kernels: a prefix of 1, one
# ending inside a key tile and one past a tile, with a window, a decode
# call split over the keys, arctic's group of 7 (56 query heads over 8) and
# paligemma's group of 8 at head dim 256.
_PREFIXED = [
    (b, sq, sk, hq, hkv, d, kv, off, w, pre, dtype)
    for dtype in (torch.float32, torch.bfloat16)
    for b, sq, sk, hq, hkv, d, kv, off, w, pre in (
        (2, 40, 40, 4, 2, 16, 40, 0, 0, 1),
        (2, 100, 130, 6, 1, 64, 100, 0, 0, 37),
        (2, 100, 130, 6, 1, 64, 100, 0, 0, 70),
        (2, 90, 100, 4, 1, 128, 90, 0, 20, 50),
        (8, 1, 400, 8, 1, 256, 301, 300, 0, 256),
        (2, 70, 80, 56, 8, 128, 70, 0, 0, 33),
        (2, 300, 320, 8, 1, 256, 300, 0, 0, 256))]


@pytest.mark.parametrize("case", _PREFIXED, ids=str)
def test_prefix_flash_attention_kernel_matches_plain(cuda, case):
    b, sq, sk, hq, hkv, d, sk_valid, q_offset, window, prefix, dtype = case
    fa = _kernel("flash_attention")
    g = torch.Generator(device=cuda).manual_seed(sq * sk + prefix)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    kw = dict(causal=True, sk_valid=sk_valid, q_offset=q_offset,
              window=window, prefix=prefix)
    before = fa.LAUNCHES
    got = fa.attend(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want = fa.attend_plain(q, k, v, **kw)
    rtol, atol = (0, 1e-5) if dtype == torch.float32 else (2**-7, 2**-10)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def test_bf16_flash_attention_rejects_misaligned_tensors(cuda):
    """The tensor-core kernel copies K/V tiles in 16-byte pieces: a bf16 or
    fp16 tensor whose data or strides are not 16-byte aligned raises, and
    launches nothing."""
    fa = _kernel("flash_attention")
    g = torch.Generator(device=cuda).manual_seed(3)
    for dtype in (torch.bfloat16, torch.float16):
        q = torch.randn((2, 8, 4, 128), generator=g, device=cuda).to(dtype)
        kv = torch.randn((2, 8, 2, 128), generator=g, device=cuda).to(dtype)
        wide = torch.randn((2, 8, 2, 130), generator=g,
                           device=cuda).to(dtype)
        wide_q = torch.randn((2, 8, 4, 136), generator=g,
                             device=cuda).to(dtype)
        before = fa.LAUNCHES
        for qq, k, v in ((q, wide[..., :128], kv),        # k: head stride 130
                         (q[:, :1], kv, wide[..., 2:]),   # v: 4 bytes past 16
                         (wide_q[..., 4:132], kv, kv)):   # q: 8 bytes past 16
            with pytest.raises(ValueError, match="16-byte"):
                fa.attend(qq, k, v, causal=True)
        assert fa.LAUNCHES == before


# Kernel 7: one step, ragged lengths, one chunk of its chunked scan (32
# steps) and a step past it, recurrentgemma's training microbatch (row 7t,
# the chunked scan) and its serving prefill (row 7) and a shorter one (the
# one-pass kernel, from ONE_PASS_CHANNELS channels).
@pytest.mark.parametrize("b, s, d", [(1, 1, 1), (2, 37, 64), (1, 300, 100),
                                     (3, 17, 2560), (8, 1024, 2560),
                                     (2, 32, 64), (2, 33, 100),
                                     (2, 3072, 2560), (8, 3072, 2560)])
def test_lru_kernel_matches_plain(cuda, b, s, d):
    ls = _kernel("lru_scan")
    assert ls.CHUNK == 32 and (b * d >= ls.ONE_PASS_CHANNELS) == (b == 8)
    g = torch.Generator(device=cuda).manual_seed(s * d)
    a = 0.5 + 0.499 * torch.rand((b, s, d), generator=g, device=cuda)
    x = torch.randn((b, s, d), generator=g, device=cuda)
    before = ls.LAUNCHES
    h, h_fin = ls.lru_scan_chunked(a, x)
    torch.cuda.synchronize()
    assert ls.LAUNCHES == before + 1
    h_want, fin_want = ls.lru_chunked_plain(a, x, 256)
    torch.testing.assert_close(h, h_want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h_fin, fin_want, rtol=1e-5, atol=1e-5)
    assert torch.equal(h_fin, h[:, -1])
    again = ls.lru_scan_chunked(a, x)
    assert torch.equal(again[0], h) and torch.equal(again[1], h_fin)
    # The same operands as strided views: a column slice and every second
    # step of a longer tensor.
    wide = torch.zeros((b, s, 2 * d), device=cuda)
    wide[..., d:] = a
    long = torch.zeros((b, 2 * s, d), device=cuda)
    long[:, ::2] = x
    hv, fin_v = ls.lru_scan_chunked(wide[..., d:], long[:, ::2])
    assert torch.equal(hv, h) and torch.equal(fin_v, h_fin)


# Kernel 7 in bf16 and fp16: h in a's dtype within one output ulp of the
# plain version rounded (both sum in fp32 and round once: eps |plain|, plus
# the fp32 sums' order near zero), h_fin fp32 within 1e-5 (1 + |plain|);
# both the chunked scan and the one-pass kernel (8 x 2560 channels).
@pytest.mark.parametrize("b, s, d", [(1, 1, 1), (2, 37, 64), (3, 17, 2560),
                                     (2, 33, 100), (8, 300, 2560)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_lru_kernel_takes_narrow_dtypes(cuda, b, s, d, dtype):
    ls = _kernel("lru_scan")
    g = torch.Generator(device=cuda).manual_seed(s * d + 1)
    a = (0.5 + 0.499 * torch.rand((b, s, d), generator=g,
                                  device=cuda)).to(dtype)
    x = torch.randn((b, s, d), generator=g, device=cuda).to(dtype)
    before = ls.LAUNCHES
    h, h_fin = ls.lru_scan_chunked(a, x)
    torch.cuda.synchronize()
    assert ls.LAUNCHES == before + 1
    assert h.dtype == dtype and h_fin.dtype == torch.float32
    h_want, fin_want = ls.lru_chunked_plain(a, x, 256)
    _narrow_close(h, h_want, dtype, 1e-5)
    torch.testing.assert_close(h_fin, fin_want, rtol=1e-5, atol=1e-5)
    assert torch.equal(h, ls.lru_scan_chunked(a, x)[0])


def _narrow_close(got, want, dtype, tol):
    eps = 2**-7 if dtype == torch.bfloat16 else 2**-10
    want = want.float()
    diff = (got.float() - want).abs()
    bound = eps * want.abs() + tol * (1 + want.abs())
    assert bool((diff <= bound).all()), float(diff.max())


# Kernel 6 in bf16 and fp16 (every operand narrow, and one narrow operand
# among fp32 ones): y in x's dtype within one output ulp plus the fp32
# check's 1e-4 (1 + |plain|); S_fin fp32 within 1e-4 (1 + |plain|).
@pytest.mark.parametrize("b, h, s, p, n", [(2, 3, 37, 16, 16),
                                           (1, 2, 65, 64, 128),
                                           (8, 24, 256, 64, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("which", ["all", "x", "dt", "A", "B", "C"])
def test_ssd_kernel_takes_narrow_dtypes(cuda, b, h, s, p, n, dtype, which):
    ss = _kernel("ssd_scan")
    x, dt, A, Bm, Cm, _, _ = _ssd_operands(cuda, b, h, s, p, n, s + n)
    ops = [x, dt, A, Bm, Cm]
    names = ["x", "dt", "A", "B", "C"]
    ops = [t.to(dtype) if which in ("all", nm) else t
           for t, nm in zip(ops, names)]
    before = ss.LAUNCHES
    y, s_fin = ss.ssd_scan_chunked(*ops)
    torch.cuda.synchronize()
    assert ss.LAUNCHES == before + 1
    assert y.dtype == ops[0].dtype and s_fin.dtype == torch.float32
    y_want, s_want = ss.ssd_chunked_plain(*ops, 128)
    if y.dtype == torch.float32:
        torch.testing.assert_close(y, y_want, rtol=1e-4, atol=1e-4)
    else:
        _narrow_close(y, y_want, dtype, 1e-4)
    torch.testing.assert_close(s_fin, s_want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_narrow_scans_under_autograd_launch_their_kernels(cuda, dtype):
    """Kernels 6 and 7 on narrow operands that require grad, then kernels
    6b and 7b in fp32 on the operands cast: each gradient in its operand's
    dtype, equal to the backward wrappers' on the cast operands."""
    ss, ls = _kernel("ssd_scan"), _kernel("lru_scan")
    x, dt, A, Bm, Cm, dy, _ = _ssd_operands(cuda, 2, 3, 100, 64, 128, 8)
    nar = [t.to(dtype) for t in (x, dt, A, Bm, Cm)]
    ops = [t.clone().requires_grad_(True) for t in nar]
    f0, b0 = ss.LAUNCHES, ss.BWD_LAUNCHES
    y, _ = ss.ssd_scan_chunked(*ops)
    got = torch.autograd.grad(y, ops, dy.to(dtype))
    assert (ss.LAUNCHES - f0, ss.BWD_LAUNCHES - b0) == (1, 1)
    with torch.no_grad():
        f32 = [t.float() for t in nar]
        _, _, states = ss._forward(*f32, 128)
        want = ss.ssd_scan_backward(*f32, dy.to(dtype).float(),
                                    states=states)
    assert all(u.dtype == dtype and torch.equal(u, v.to(dtype))
               for u, v in zip(got, want))
    g = torch.Generator(device=cuda).manual_seed(9)
    a = (0.5 + 0.499 * torch.rand((2, 77, 256), generator=g,
                                  device=cuda)).to(dtype)
    xb, dh = (torch.randn((2, 77, 256), generator=g, device=cuda).to(dtype)
              for _ in range(2))
    a, xb = a.requires_grad_(True), xb.requires_grad_(True)
    f0, b0 = ls.LAUNCHES, ls.BWD_LAUNCHES
    h, _ = ls.lru_scan_chunked(a, xb)
    got = torch.autograd.grad(h, (a, xb), dh)
    assert (ls.LAUNCHES - f0, ls.BWD_LAUNCHES - b0) == (1, 1)
    want = ls.lru_scan_backward(a.detach().float(), h.detach().float(),
                                dh.float())
    assert all(u.dtype == dtype and torch.equal(u, v.to(dtype))
               for u, v in zip(got, want))


# The kernel's chunks of 64 (built) and 128: S = 64, 65, 128 and 129 are one
# chunk and one step past it, for each.
@pytest.mark.parametrize("b, h, s, p, n", [(8, 24, 256, 64, 128),
                                           (2, 3, 37, 16, 16),
                                           (1, 2, 100, 64, 64),
                                           (2, 2, 33, 32, 32), (1, 1, 1, 16, 16),
                                           (1, 2, 64, 64, 128),
                                           (1, 2, 65, 64, 128),
                                           (1, 2, 128, 64, 128),
                                           (1, 2, 129, 64, 128)])
@pytest.mark.parametrize("q", [64, 128])
def test_ssd_kernel_matches_plain(cuda, b, h, s, p, n, q, monkeypatch):
    ss = _kernel("ssd_scan")
    monkeypatch.setattr(ss, "KERNEL_CHUNK", q)
    g = torch.Generator(device=cuda).manual_seed(s * n)
    x = torch.randn((b, h, s, p), generator=g, device=cuda)
    dt = torch.nn.functional.softplus(torch.randn((b, h, s), generator=g,
                                                  device=cuda))
    A = -torch.exp(0.5 * torch.randn((h,), generator=g, device=cuda))
    Bm, Cm = (torch.randn((b, s, n), generator=g, device=cuda) / n ** 0.5
              for _ in range(2))
    before = ss.LAUNCHES
    y, s_fin = ss.ssd_scan_chunked(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert ss.LAUNCHES == before + 1
    y_want, s_want = ss.ssd_chunked_plain(x, dt, A, Bm, Cm, 128)
    torch.testing.assert_close(y, y_want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s_fin, s_want, rtol=1e-4, atol=1e-4)


def test_ssd_kernel_reads_views_not_16_byte_aligned(cuda):
    """x, B and C as column slices of a projection whose rows are 3 floats
    past a multiple of 4: the kernel copies them 4 bytes at a time."""
    ss = _kernel("ssd_scan")
    b, h, s, p, n = 2, 3, 70, 64, 128
    g = torch.Generator(device=cuda).manual_seed(5)
    proj = torch.randn((b, s, h * p + 2 * n + 3), generator=g, device=cuda)
    x = proj[..., 1:1 + h * p].reshape(b, s, h, p).transpose(1, 2)
    Bm = proj[..., 1 + h * p:1 + h * p + n] / n ** 0.5
    Cm = proj[..., 1 + h * p + n:1 + h * p + 2 * n] / n ** 0.5
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g,
                                                  device=cuda)).transpose(1, 2)
    A = -torch.exp(0.5 * torch.randn((h,), generator=g, device=cuda))
    y, s_fin = ss.ssd_scan_chunked(x, dt, A, Bm, Cm)
    y_want, s_want = ss.ssd_chunked_plain(x, dt, A, Bm, Cm, 128)
    torch.testing.assert_close(y, y_want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s_fin, s_want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-130m",
                                  "recurrentgemma-2b", "kimi-k2-1t-a32b",
                                  "arctic-480b", "paligemma-3b"])
def test_smoke_models_on_the_card_match_the_cpu(cuda, arch, monkeypatch):
    """The model's glue around the kernels, in float32 with TF32 off: the
    card's prefill logits and greedy tokens equal the CPU's (40-token
    prompts and 16 steps: past recurrentgemma's smoke window of 16;
    paligemma's 8 patches before them)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServeEngine

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = get_config(arch).smoke()
    params = init_params(cfg, torch.Generator().manual_seed(1))
    gpu = Model(cfg, device=cuda, params=params)
    cpu = Model(cfg, device="cpu", params=params)
    prompts = torch.randint(0, cfg.vocab, (4, 40),
                            generator=torch.Generator().manual_seed(2))
    extra = ({"patches": torch.randn(
        (4, cfg.n_frontend_tokens, cfg.d_model),
        generator=torch.Generator().manual_seed(3))}
        if cfg.n_frontend_tokens else {})
    lg, _ = gpu.prefill({"tokens": prompts.to(cuda),
                         **{k: t.to(cuda) for k, t in extra.items()}},
                        gpu.init_cache(4, 64))
    lc, _ = cpu.prefill({"tokens": prompts, **extra}, cpu.init_cache(4, 64))
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    tg = ServeEngine(gpu, max_seq=64).generate(prompts, steps=16,
                                               extra_batch=extra)
    tc = ServeEngine(cpu, max_seq=64).generate(prompts, steps=16,
                                               extra_batch=extra)
    assert torch.equal(tg.cpu(), tc)


@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "arctic-480b"])
def test_moe_block_on_the_card_matches_the_cpu(cuda, arch, cf, monkeypatch):
    """The MoE block's dispatch, experts and combine at smoke width, in
    float32 with TF32 off, on 96 tokens in 2 groups: the dispatch indices
    equal the CPU's, ``y`` within 1e-5 and aux within 1e-6 (float sums in
    another order), at the smoke's capacity factor and the published 1.25,
    which drops tokens; and two runs on the card give the same bits."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import blocks

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = dataclasses.replace(get_config(arch).smoke(), capacity_factor=cf,
                              moe_groups=2)
    p = blocks.moe_params(torch.Generator().manual_seed(4), cfg)
    x = torch.randn((8, 12, cfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    pg = {k: (t.to(cuda) if isinstance(t, torch.Tensor) else
              {n: w.to(cuda) for n, w in t.items()}) for k, t in p.items()}
    yc, auxc = blocks.moe_apply(cfg, p, x)
    yg, auxg = blocks.moe_apply(cfg, pg, x.to(cuda))
    yg2, _ = blocks.moe_apply(cfg, pg, x.to(cuda))
    torch.testing.assert_close(yg.cpu(), yc, rtol=0, atol=1e-5)
    torch.testing.assert_close(auxg.cpu(), auxc, rtol=1e-6, atol=0)
    assert torch.equal(yg, yg2)
    n_groups, tg, cap = blocks.moe_groups(cfg, 96)
    dc = blocks.moe_dispatch(cfg, p["router"], x.reshape(n_groups, tg, -1),
                             cap)
    dg = blocks.moe_dispatch(cfg, pg["router"],
                             x.to(cuda).reshape(n_groups, tg, -1), cap)
    for name in ("sel", "se", "pos_c", "keep", "tok_sorted"):
        assert torch.equal(dg[name].cpu(), dc[name]), name
    assert bool((~dc["keep"]).any()) == (cf != 8.0)


def test_float_wrappers_reject_what_the_kernels_do_not_take(cuda):
    fa, ss = _kernel("flash_attention"), _kernel("ssd_scan")
    ls = _kernel("lru_scan")
    q = torch.zeros((1, 4, 2, 16), device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="kernel takes"):
        fa.attend(q, q, q, causal=True)
    for d in (48, 512):
        q = torch.zeros((1, 4, 2, d), device=cuda)
        with pytest.raises(ValueError, match="head dims"):
            fa.attend(q, q, q, causal=True)
    q = torch.zeros((1, 4, 2, 256), device=cuda)
    with pytest.raises(ValueError, match="window"):
        fa.attend(q, q, q, causal=True, window=-1)
    a = torch.zeros((1, 8, 16), device=cuda)
    with pytest.raises(TypeError, match="float64"):
        ls.lru_scan_chunked(a.double(), a.double())
    with pytest.raises(TypeError, match="one dtype"):
        ls.lru_scan_chunked(a, a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ls.lru_scan_chunked(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        ls.lru_scan_chunked(a, a.cpu())
    x = torch.zeros((1, 2, 8, 16), device=cuda)
    dt = torch.zeros((1, 2, 8), device=cuda)
    A = torch.zeros((2,), device=cuda)
    Bm = torch.zeros((1, 8, 16), device=cuda)
    with pytest.raises(TypeError, match="float64"):
        ss.ssd_scan_chunked(x.double(), dt, A, Bm, Bm)
    with pytest.raises(ValueError, match="built for"):
        ss.ssd_scan_chunked(x, dt, A, Bm[..., :8], Bm[..., :8])


# Kernel 5b (the backward) and the forward's lse: (b, sq, sk, hq, hkv, d,
# mask keywords), each in fp32 and bf16.  Head dims 16, 64, 80 (hubert's),
# 128 and 256; causal, non-causal, the prefix-LM mask, windows, sk_valid and
# q_offset; GQA groups 1, 6, 7 and 8; one query row, and shapes whose plan
# splits the keys (the merge writes lse).  The last three meet the bf16
# kernels' 64-key and 64-row tiles: ragged tiles at hubert's heads, a
# position's group of 6 across two row tiles (258 rows), and a prefix at
# qwen2's heads.  The four after them meet bf16's head-dim-256 passes:
# recurrentgemma's 10 heads over one KV head under a window of 100 (300
# ragged rows, the dK/dV pass's rows in 11 slices), sk_valid and q_offset
# (3 slices), non-causal (2 slices), and a shape too small to slice.
_BWD = [
    (2, 1, 1, 2, 2, 16, dict(causal=True)),
    (2, 37, 37, 6, 1, 16, dict(causal=True)),
    (1, 70, 70, 7, 1, 64, dict(causal=False)),
    (2, 130, 130, 16, 16, 80, dict(causal=False)),
    (2, 300, 300, 8, 1, 80, dict(causal=True)),
    (1, 300, 300, 12, 2, 128, dict(causal=True)),
    (2, 300, 300, 8, 1, 256, dict(causal=True, prefix=256)),
    (1, 90, 90, 4, 2, 256, dict(causal=True, window=16)),
    (2, 70, 90, 4, 2, 16, dict(causal=True, prefix=37, window=16,
                               sk_valid=85, q_offset=20)),
    (1, 1, 1062, 12, 2, 128, dict(causal=True, sk_valid=1000, q_offset=999)),
    (1, 200, 1062, 2, 1, 80, dict(causal=True, q_offset=862)),
    (1, 1023, 1023, 16, 16, 80, dict(causal=False)),
    (1, 43, 43, 6, 1, 128, dict(causal=True)),
    (1, 200, 200, 12, 2, 128, dict(causal=True, prefix=37)),
    (1, 300, 300, 10, 1, 256, dict(causal=True, window=100)),
    (2, 100, 300, 8, 1, 256, dict(causal=True, sk_valid=260, q_offset=170)),
    (1, 150, 200, 4, 1, 256, dict(causal=False)),
    (1, 40, 40, 2, 1, 256, dict(causal=True)),
]


def _bwd_close(got, want, rtol, atol):
    """|got - want| <= rtol |want| + atol max(1, max |want|): both sum in
    fp32 in other orders (bf16 rounds once more, one ulp)."""
    scale = max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", _BWD, ids=str)
def test_flash_attention_backward_kernel_matches_plain(cuda, case, dtype):
    """Kernel 5 with lse and kernel 5b against their plain versions; two
    runs of kernel 5b give the same bits (no atomics)."""
    b, sq, sk, hq, hkv, d, kw = case
    fa = _kernel("flash_attention")
    g = torch.Generator(device=cuda).manual_seed(sq * sk + d)
    q, k, v, do = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                   for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                                 (b, sk, hkv, d), (b, sq, hq, d)))
    out, lse = fa.attend_with_lse(q, k, v, **kw)
    out_p, lse_p = fa.attend_plain_with_lse(q, k, v, **kw)
    live = torch.isfinite(lse_p)
    assert torch.equal(torch.isfinite(lse), live)
    torch.testing.assert_close(lse[live], lse_p[live], rtol=1e-5, atol=1e-5)
    before = fa.BWD_LAUNCHES
    got = fa.attend_backward(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    assert fa.BWD_LAUNCHES == before + 1
    want = fa.attend_backward_plain(q, k, v, out, do, **kw)
    rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (2**-7, 1e-4)
    for a, w in zip(got, want):
        _bwd_close(a, w, rtol, atol)
    again = fa.attend_backward(q, k, v, out, do, lse, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


def test_bwd256_tiles_are_the_wrappers(cuda):
    """The built kernel's head-dim-256 tiles are the wrapper's constants,
    which its slice plan and the CPU rounding model take."""
    from repro_torch.kernels import _build
    fa = _kernel("flash_attention")
    lib = _build.library()
    got = [lib.repro_flash_attention_bwd256_tile(i) for i in range(5)]
    assert got == [fa.BWD256_BK, fa.BWD256_SUB, fa.BWD256_QBK, 128, -1]
    fa._check_bwd256_tiles.cache_clear()
    fa._check_bwd256_tiles()


def test_attend_under_autograd_launches_kernels_5_and_5b(cuda):
    """``attend`` on inputs that require grad: kernel 5 (with lse) forward,
    kernel 5b backward, a strided output gradient made contiguous; the
    gradients equal ``attend_backward``'s."""
    fa = _kernel("flash_attention")
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((2, 64, 4, 80), generator=g, device=cuda)
               .bfloat16().requires_grad_(True) for _ in range(3))
    f0, b0 = fa.LAUNCHES, fa.BWD_LAUNCHES
    out = fa.attend(q, k, v, causal=False)
    wide = torch.randn((2, 64, 4, 160), generator=g, device=cuda).bfloat16()
    dout = wide[..., :80]                  # strided, as autograd may give it
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    assert (fa.LAUNCHES - f0, fa.BWD_LAUNCHES - b0) == (1, 1)
    with torch.no_grad():
        o2, lse = fa.attend_with_lse(q, k, v, causal=False)
        want = fa.attend_backward(q, k, v, o2, dout, lse, causal=False)
    for a, w in zip((dq, dk, dv), want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "paligemma-3b",
                                  "kimi-k2-1t-a32b", "mamba2-130m",
                                  "recurrentgemma-2b"])
def test_smoke_training_on_the_card_matches_the_cpu(cuda, arch, monkeypatch):
    """Three train steps of a smoke config (fp32, TF32 off) on the card and
    on the CPU from the same weights and batches: the losses within 1e-4
    relative, and the card's run through the backward kernels of its layers
    (5b a layer with attention, 6b an ssm layer, 7b a rec layer), once a
    layer and microbatch."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import Model
    from repro_torch.models.model import init_params, layer_kinds
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    from repro_torch.tree import map_tree

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    mods = {"attn": _kernel("flash_attention"), "moe": _kernel("flash_attention"),
            "ssm": _kernel("ssd_scan"), "rec": _kernel("lru_scan")}
    cfg = get_config(arch).smoke()
    kinds = layer_kinds(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(1))
    tcfg = TrainConfig(warmup_steps=1, total_steps=10, microbatches=2)
    dcfg = DataConfig(seq_len=48, global_batch=4, vocab=cfg.vocab,
                      frontend=cfg.frontend,
                      n_frontend_tokens=cfg.n_frontend_tokens,
                      d_model=cfg.d_model)
    losses = []
    for dev in (cuda, torch.device("cpu")):
        model = Model(cfg, device=dev,
                      params=map_tree(lambda t: t.clone(), params))
        state = init_train_state(model.params(), tcfg)
        step = make_train_step(model, tcfg)
        before = {m: m.BWD_LAUNCHES for m in set(mods.values())}
        got = []
        for i in range(3):
            batch = {k: t.to(dev) for k, t in synthetic_batch(dcfg, i).items()}
            state, m = step(state, batch)
            got.append(float(m["loss"]))
        if dev.type == "cuda":
            for mod in set(mods.values()):
                layers = sum(mods[k] is mod for k in kinds)
                assert mod.BWD_LAUNCHES - before[mod] == 3 * 2 * layers
        losses.append(got)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)


# Kernel 7b against lru_backward_plain: one step, shorter than its chunk of
# 32, ragged, a width that is no multiple of its 128-channel blocks, and
# recurrentgemma's training microbatch.  Within 1e-5 (1 + |plain|): the same
# recurrence, its carries composed in another order.
@pytest.mark.parametrize("final", [False, True], ids=["no-dh_fin", "dh_fin"])
@pytest.mark.parametrize("b, s, d", [(1, 1, 1), (2, 31, 64), (2, 37, 100),
                                     (1, 300, 2560), (2, 3072, 2560)])
def test_lru_backward_kernel_matches_plain(cuda, b, s, d, final):
    ls = _kernel("lru_scan")
    g = torch.Generator(device=cuda).manual_seed(s * d + final)
    a = 0.5 + 0.499 * torch.rand((b, s, d), generator=g, device=cuda)
    x, dh = (torch.randn((b, s, d), generator=g, device=cuda)
             for _ in range(2))
    dh_fin = torch.randn((b, d), generator=g, device=cuda) if final else None
    h, _ = ls.lru_scan_chunked(a, x)
    before = ls.BWD_LAUNCHES
    da, db = ls.lru_scan_backward(a, h, dh, dh_fin)
    torch.cuda.synchronize()
    assert ls.BWD_LAUNCHES == before + 1
    da_p, db_p = ls.lru_backward_plain(a, h, dh, dh_fin)
    torch.testing.assert_close(da, da_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(db, db_p, rtol=1e-5, atol=1e-5)
    again = ls.lru_scan_backward(a, h, dh, dh_fin)
    assert torch.equal(again[0], da) and torch.equal(again[1], db)
    # Strided operands: a column slice of a wider tensor, every second step.
    wide = torch.zeros((b, s, 2 * d), device=cuda)
    wide[..., d:] = a
    long = torch.zeros((b, 2 * s, d), device=cuda)
    long[:, ::2] = dh
    dv = ls.lru_scan_backward(wide[..., d:], h, long[:, ::2], dh_fin)
    assert torch.equal(dv[0], da) and torch.equal(dv[1], db)


def _ssd_operands(cuda, b, h, s, p, n, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x, dy = (torch.randn((b, h, s, p), generator=g, device=cuda)
             for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn((b, h, s), generator=g,
                                                  device=cuda))
    A = -torch.exp(0.5 * torch.randn((h,), generator=g, device=cuda))
    Bm, Cm = (torch.randn((b, s, n), generator=g, device=cuda) / n ** 0.5
              for _ in range(2))
    dS = torch.randn((b, h, n, p), generator=g, device=cuda)
    return x, dt, A, Bm, Cm, dy, dS


def _ssd_bwd_close(got, want):
    """|kernel - plain| <= 1e-4 |plain| + 1e-4 max(1, max |plain|) for each
    gradient: 3xTF32 products and fp32 sums in other orders, over K up to
    the sequence for dA, dB and dC."""
    for a, w in zip(got, want):
        scale = max(1.0, float(w.abs().max())) if w.numel() else 1.0
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4 * scale)


# Kernel 6b against ssd_backward_plain at its chunk of 64: one step, shorter
# than a chunk, one chunk, ragged, every built (N, P), and mamba2-130m's
# training microbatch.
@pytest.mark.parametrize("final", [False, True], ids=["no-dS", "dS"])
@pytest.mark.parametrize("b, h, s, p, n", [(1, 1, 1, 16, 16),
                                           (2, 3, 37, 16, 16),
                                           (1, 2, 64, 32, 32),
                                           (2, 2, 100, 64, 64),
                                           (1, 2, 129, 64, 128),
                                           (16, 24, 2048, 64, 128)])
def test_ssd_backward_kernel_matches_plain(cuda, b, h, s, p, n, final):
    ss = _kernel("ssd_scan")
    x, dt, A, Bm, Cm, dy, dS = _ssd_operands(cuda, b, h, s, p, n, s * n)
    dS = dS if final else None
    _, _, states = ss._forward(x, dt, A, Bm, Cm, 128)
    before = ss.BWD_LAUNCHES
    got = ss.ssd_scan_backward(x, dt, A, Bm, Cm, dy, dS, states=states)
    torch.cuda.synchronize()
    assert ss.BWD_LAUNCHES == before + 1
    want = ss.ssd_backward_plain(x, dt, A, Bm, Cm, dy, dS,
                                 chunk=ss.KERNEL_CHUNK)
    _ssd_bwd_close(got, want)
    again = ss.ssd_scan_backward(x, dt, A, Bm, Cm, dy, dS, states=states)
    assert all(torch.equal(u, v) for u, v in zip(got, again))


def test_ssd_backward_kernel_reads_the_models_strided_views(cuda):
    """x, B and C as column slices of one projection (rows 3 floats past a
    multiple of 4: 4-byte copies), dt a transposed view, dy a transposed
    view as autograd hands it in."""
    ss = _kernel("ssd_scan")
    b, h, s, p, n = 2, 3, 70, 64, 128
    g = torch.Generator(device=cuda).manual_seed(6)
    proj = torch.randn((b, s, h * p + 2 * n + 3), generator=g, device=cuda)
    x = proj[..., 1:1 + h * p].reshape(b, s, h, p).transpose(1, 2)
    Bm = proj[..., 1 + h * p:1 + h * p + n] / n ** 0.5
    Cm = proj[..., 1 + h * p + n:1 + h * p + 2 * n] / n ** 0.5
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g,
                                                  device=cuda)).transpose(1, 2)
    A = -torch.exp(0.5 * torch.randn((h,), generator=g, device=cuda))
    dy = torch.randn((b, s, h, p), generator=g, device=cuda).transpose(1, 2)
    _, _, states = ss._forward(x, dt, A, Bm, Cm, 128)
    got = ss.ssd_scan_backward(x, dt, A, Bm, Cm, dy, states=states)
    want = ss.ssd_backward_plain(x, dt, A, Bm, Cm, dy, chunk=ss.KERNEL_CHUNK)
    _ssd_bwd_close(got, want)
    dense = ss.ssd_scan_backward(*(t.contiguous() for t in (x, dt, A, Bm, Cm,
                                                           dy)),
                                 states=states)
    assert all(torch.equal(u, v) for u, v in zip(got, dense))


def test_scans_under_autograd_launch_their_backward_kernels(cuda):
    """``ssd_scan_chunked`` and ``lru_scan_chunked`` on operands that require
    grad: kernels 6 and 6b, 7 and 7b, one launch each; the gradients equal
    the backward wrappers' on the same operands."""
    ss, ls = _kernel("ssd_scan"), _kernel("lru_scan")
    x, dt, A, Bm, Cm, dy, _ = _ssd_operands(cuda, 2, 3, 100, 64, 128, 8)
    ops = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    f0, b0 = ss.LAUNCHES, ss.BWD_LAUNCHES
    y, _ = ss.ssd_scan_chunked(*ops)
    got = torch.autograd.grad(y, ops, dy)
    assert (ss.LAUNCHES - f0, ss.BWD_LAUNCHES - b0) == (1, 1)
    with torch.no_grad():
        _, _, states = ss._forward(x, dt, A, Bm, Cm, 128)
        want = ss.ssd_scan_backward(x, dt, A, Bm, Cm, dy, states=states)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    g = torch.Generator(device=cuda).manual_seed(9)
    a = (0.5 + 0.499 * torch.rand((2, 77, 256), generator=g, device=cuda))
    xb, dh = (torch.randn((2, 77, 256), generator=g, device=cuda)
              for _ in range(2))
    a, xb = a.requires_grad_(True), xb.requires_grad_(True)
    f0, b0 = ls.LAUNCHES, ls.BWD_LAUNCHES
    h, _ = ls.lru_scan_chunked(a, xb)
    got = torch.autograd.grad(h, (a, xb), dh)
    assert (ls.LAUNCHES - f0, ls.BWD_LAUNCHES - b0) == (1, 1)
    want = ls.lru_scan_backward(a.detach(), h.detach(), dh)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


def test_backward_wrappers_reject_what_the_kernels_do_not_take(cuda):
    ss, ls = _kernel("ssd_scan"), _kernel("lru_scan")
    x, dt, A, Bm, Cm, dy, _ = _ssd_operands(cuda, 1, 2, 70, 64, 128, 3)
    with pytest.raises(ValueError, match="states"):
        ss.ssd_scan_backward(x, dt, A, Bm, Cm, dy)
    _, _, states = ss._forward(x, dt, A, Bm, Cm, 128)
    with pytest.raises(ValueError, match="float32 CUDA"):
        ss.ssd_scan_backward(x, dt, A, Bm, Cm, dy.double(), states=states)
    a = torch.rand((1, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="float32 CUDA"):
        ls.lru_scan_backward(a, a, a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ls.lru_scan_backward(a.transpose(1, 2), a.transpose(1, 2),
                             a.transpose(1, 2))


def test_bf16_backward_rejects_misaligned_tensors(cuda):
    fa = _kernel("flash_attention")
    x = torch.zeros((1, 8, 2, 16 + 1), device=cuda, dtype=torch.bfloat16)
    q = x[..., 1:]                           # starts 2 bytes past 16
    ok = torch.zeros((1, 8, 2, 16), device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8), device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        fa.attend_backward(q, ok, ok, ok, ok, lse, causal=True)
    with pytest.raises(ValueError, match="lse"):
        fa.attend_backward(ok, ok, ok, ok, ok, lse[..., :4], causal=True)


def _bitwise(got, want):
    return all(torch.equal(u, v) and u.stride() == v.stride()
               for u, v in zip(got, want))


@pytest.mark.parametrize("sq, sk, dtype, d", [
    (256, 256, torch.bfloat16, 128),     # prefill, causal tiles
    (1, 4096, torch.bfloat16, 128),      # decode: the keys split
    (96, 96, torch.float32, 64),         # the FMA kernels
    (64, 64, torch.bfloat16, 256)])      # kernel 5b's head-dim-256 passes
def test_flash_custom_ops_equal_the_direct_launch(cuda, sq, sk, dtype, d):
    """The ops ``repro_torch::flash_attention``, ``..._lse`` and
    ``..._bwd`` give what their implementations launched directly (the
    launch before the ops wrapped them) give, bit for bit, and twice the
    same; each call launches once."""
    fa = _kernel("flash_attention")
    g = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    b, hq, hkv = 2, 4, 2
    q = torch.randn((b, sq, hq, d), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((b, sk, hkv, d), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    kw = fa._options(q, k, v, causal=True, sk_valid=None,
                     q_offset=sk - sq, scale=None, window=0, prefix=0)
    ops = torch.ops.repro_torch
    n0 = fa.LAUNCHES
    want = fa._launch(q, k, v, **kw, with_lse=True)
    runs = [ops.flash_attention_lse(q, k, v, **kw) for _ in range(2)]
    assert all(_bitwise(r, want) for r in runs)
    plain = ops.flash_attention(q, k, v, **kw)
    assert torch.equal(plain, fa._launch(q, k, v, **kw, with_lse=False)[0])
    assert fa.LAUNCHES - n0 == 5
    out, lse = want
    dout = torch.randn(out.shape, generator=g, device=cuda).to(dtype)
    n0 = fa.BWD_LAUNCHES
    want = fa._launch_bwd(q, k, v, out, dout, lse, **kw)
    runs = [ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
            for _ in range(2)]
    assert all(_bitwise(r, want) for r in runs)
    assert fa.BWD_LAUNCHES - n0 == 3


@pytest.mark.parametrize("b, h, s, p, n", [(2, 3, 200, 64, 128),
                                           (1, 2, 64, 16, 16)])
def test_scan_custom_ops_equal_the_direct_launch(cuda, b, h, s, p, n):
    """``repro_torch::ssd_scan``/``ssd_scan_bwd`` and ``lru_scan``/
    ``lru_scan_bwd`` against their implementations launched directly, bit
    for bit (strides too: ``y`` and ``dx`` are ``[B, H, S, P]`` views of
    ``[B, S, H, P]``), and twice the same."""
    ss, ls = _kernel("ssd_scan"), _kernel("lru_scan")
    ops = torch.ops.repro_torch
    x, dt, A, Bm, Cm, dy, dS = _ssd_operands(cuda, b, h, s, p, n, 5)
    want = ss._launch(x, dt, A, Bm, Cm)
    runs = [ops.ssd_scan(x, dt, A, Bm, Cm) for _ in range(2)]
    # the states before chunk 0 are left unwritten (kernel 6b never reads
    # them): compare the chunks after it
    cut = lambda r: (r[0], r[1], r[2][:, :, 1:])
    assert all(_bitwise(cut(r), cut(want)) for r in runs)
    states = want[2]
    for fin in (None, dS):
        want = ss._launch_bwd(x, dt, A, Bm, Cm, dy, fin, states)
        runs = [ops.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, fin, states)
                for _ in range(2)]
        assert all(_bitwise(r, want) for r in runs)
    g = torch.Generator(device=cuda).manual_seed(s)
    for width in (p, 16384):     # chunked, and one pass a channel
        a = 0.5 + 0.499 * torch.rand((b, s, width), generator=g, device=cuda)
        xb, dh = (torch.randn((b, s, width), generator=g, device=cuda)
                  for _ in range(2))
        want = ls._launch(a, xb)
        runs = [ops.lru_scan(a, xb) for _ in range(2)]
        assert all(_bitwise(r, want) for r in runs)
        fin = torch.randn((b, width), generator=g, device=cuda)
        want = ls._launch_bwd(a, want[0], dh, fin)
        runs = [ops.lru_scan_bwd(a, runs[0][0], dh, fin) for _ in range(2)]
        assert all(_bitwise(r, want) for r in runs)


# --------------------------------------------------------------------------- #
# Float16 on kernels 5 and 5b, and kernels 2 and 4 on 1- and 2-byte payloads. #
# fp16 attention within 2^-13 + 2^-10 |plain| (one fp16 ulp: both sum in    #
# fp32 and round once), its gradients within 2^-10 |plain| + 2^-12 max(max  #
# |plain|, max |dout|) + 2^-24 (fp16's subnormal spacing), the model of     #
# both in tests/test_torch_flash_attention.py; the delivery exact.           #
# --------------------------------------------------------------------------- #

F16_RTOL, F16_ATOL = 2**-10, 2**-13
F16_BWD_TOL = (2**-10, 2**-12, 2**-24)

# The bf16 cases of the three flash tables, in fp16.
_F16_ATTN = [(*c[:-1], torch.float16) for c in _ATTN
             if c[-1] == torch.bfloat16]
_F16_WINDOWED = [(*c[:-1], torch.float16) for c in _WINDOWED
                 if c[-1] == torch.bfloat16]
_F16_PREFIXED = [(*c[:-1], torch.float16) for c in _PREFIXED
                 if c[-1] == torch.bfloat16]


@pytest.mark.parametrize("case", [(*c[:9], 0, 0) for c in _F16_ATTN]
                         + [(*c[:10], 0) for c in _F16_WINDOWED]
                         + [(*c[:6], True, *c[6:10]) for c in _F16_PREFIXED],
                         ids=str)
def test_fp16_flash_attention_kernel_matches_plain(cuda, case):
    """Kernel 5 in fp16 (the tensor-core kernel's fp16 build) at the bf16
    tables' shapes and masks, on the cache's strided view too."""
    b, sq, sk, hq, hkv, d, causal, sk_valid, q_offset, window, prefix = case
    fa = _kernel("flash_attention")
    g = torch.Generator(device=cuda).manual_seed(sq * sk + d)
    q = torch.randn((b, sq, hq, d), generator=g, device=cuda).half()
    cache = torch.randn((b, sk + 24, 2, hkv, d), generator=g,
                        device=cuda).half()
    kw = dict(causal=causal, sk_valid=sk_valid, q_offset=q_offset,
              window=window, prefix=prefix)
    for k, v in ((cache[:, :sk, 0].contiguous(),
                  cache[:, :sk, 1].contiguous()),
                 (cache[:, :sk, 0], cache[:, :sk, 1])):
        before = fa.LAUNCHES
        got = fa.attend(q, k, v, **kw)
        torch.cuda.synchronize()
        assert fa.LAUNCHES == before + 1 and got.dtype == torch.float16
        torch.testing.assert_close(got.float(),
                                   fa.attend_plain(q, k, v, **kw).float(),
                                   rtol=F16_RTOL, atol=F16_ATOL)


@pytest.mark.parametrize("dout_scale", [1.0, 2**-16])
@pytest.mark.parametrize("case", _BWD, ids=str)
def test_fp16_flash_attention_backward_kernel_matches_plain(cuda, case,
                                                            dout_scale):
    """Kernel 5 with lse and kernel 5b in fp16 against their plain versions,
    also for an output gradient of 2^-16 (dS below fp16's normal range,
    scaled a row by the kernel); two runs of kernel 5b give the same
    bits."""
    b, sq, sk, hq, hkv, d, kw = case
    fa = _kernel("flash_attention")
    g = torch.Generator(device=cuda).manual_seed(sq * sk + d)
    q, k, v, do = (torch.randn(shape, generator=g, device=cuda)
                   for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                                 (b, sk, hkv, d), (b, sq, hq, d)))
    q, k, v, do = (t.half() for t in (q, k, v, do * dout_scale))
    out, lse = fa.attend_with_lse(q, k, v, **kw)
    _, lse_p = fa.attend_plain_with_lse(q, k, v, **kw)
    live = torch.isfinite(lse_p)
    assert torch.equal(torch.isfinite(lse), live) and out.dtype == q.dtype
    torch.testing.assert_close(lse[live], lse_p[live], rtol=1e-5, atol=1e-5)
    before = fa.BWD_LAUNCHES
    got = fa.attend_backward(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    assert fa.BWD_LAUNCHES == before + 1
    want = fa.attend_backward_plain(q, k, v, out, do, **kw)
    rtol, atol, floor = F16_BWD_TOL
    for a, w in zip(got, want):
        assert a.dtype == torch.float16
        w = w.float()
        scale = max(float(w.abs().max()), float(do.abs().max()))
        bound = rtol * w.abs() + atol * scale + floor
        assert bool(((a.float() - w).abs() <= bound).all())
    again = fa.attend_backward(q, k, v, out, do, lse, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


_NARROW = [torch.bool, torch.int8, torch.uint8, torch.int16, torch.uint16,
           torch.float16, torch.bfloat16]


def _payload(shape, dtype, dev, seed):
    """Random bits of ``dtype`` (bool: 0 or 1) on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=g, device=dev).bool()
    view = {1: torch.int8, 2: torch.int16}[dtype.itemsize]
    bits = torch.randint(-2**(8 * dtype.itemsize - 1),
                         2**(8 * dtype.itemsize - 1), shape, generator=g,
                         device=dev, dtype=torch.int32)
    return bits.to(view).view(dtype)


def _fills(dtype):
    if dtype == torch.bool:
        return [None, True]
    if dtype.is_floating_point:
        fi = torch.finfo(dtype)
        return [None, -1.5, fi.min, fi.max, float("nan")]
    ii = torch.iinfo(dtype)
    return [None, 5, ii.min, ii.max]


def _bits(x):
    return x.view({1: torch.int8, 2: torch.int16,
                   4: torch.int32}[x.element_size()])


@pytest.mark.parametrize("omega", [1, 2, 3, 4, 130, 257, 1030])
@pytest.mark.parametrize("dtype", _NARROW, ids=str)
def test_narrow_delivery_kernels_match_plain(cuda, dtype, omega):
    """Kernels 2 and 4 (``deliver_tiles``, ``assemble_proc_tiles``) on 1-
    and 2-byte payloads and counts payloads: whole-word messages (kernel
    2's packed kernel) and ragged ones (its element kernel), counts of 0,
    of ω, past ω and negative, fills of None, a value and the type's
    extremes; exact against the CPU's plain versions, one launch a call."""
    dv = _kernel("alltoallv_deliver")
    for shape, fn, launches in (((4, 4), dv.deliver_tiles, "LAUNCHES"),
                                ((3, 2, 2), dv.assemble_proc_tiles,
                                 "ASSEMBLE_LAUNCHES")):
        msgs = _payload((*shape, omega), dtype, cuda, omega)
        cnt = torch.randint(-2, omega + 3, shape, device=cuda,
                            dtype=torch.int32)
        cnt.view(-1)[:4] = torch.tensor([0, omega, omega + 5, -3],
                                        device=cuda)
        for i, fill in enumerate(_fills(dtype)):
            cp = (None, _payload(shape, dtype, cuda, i),
                  _payload(shape, torch.int8 if dtype.itemsize == 2 else
                           torch.int16, cuda, i))[i % 3]
            before = getattr(dv, launches)
            got = fn(msgs, cnt, cp, fill=fill)
            torch.cuda.synchronize()
            assert getattr(dv, launches) == before + 1
            want = fn(msgs.cpu(), cnt.cpu(), None if cp is None else cp.cpu(),
                      fill=fill)
            assert got[0].dtype == dtype
            assert torch.equal(_bits(got[0]).cpu(), _bits(want[0]))
            if cp is not None:
                assert got[1].dtype == cp.dtype
                assert torch.equal(_bits(got[1]).cpu(), _bits(want[1]))


def test_narrow_deliver_words_keep_the_int32_contract(cuda):
    """The word entries the collectives call take int32 words only."""
    dv = _kernel("alltoallv_deliver")
    x = torch.zeros((2, 8), dtype=torch.int16, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        dv.deliver_words(x, 0, x.clone(), 0, 2, 4)
    with pytest.raises(TypeError, match="float64"):
        dv.deliver_tiles(torch.zeros((2, 2, 3), dtype=torch.float64,
                                     device=cuda))
