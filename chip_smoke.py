#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

What it does, in order; any failure raises and the exit code is non-zero:

1. Requires CUDA (exits 1 at once without it) and prints the card's
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together) and prints the build seconds.
3. Holds each kernel against its plain PyTorch version on the card at edge
   shapes (ragged widths, empty and full counts, extreme and duplicate keys,
   tiles up to and past one shared-memory segment).  Equality is exact.
4. Drives the main path once through ``psrs_sort``: 2^27 int32 keys, v = 16,
   k = 4, the async driver, every kernel on; the output must equal
   ``torch.sort``, and every kernel's launch count (reset just before) must
   be above zero.
5. Runs the same plan stage by stage (``psrs_plan``) a few times under
   each driver (explicit, sliced, async) with CUDA-event stage times,
   checks ``rcount``/``oflow``, and times each driver's swap cost alone (a
   superstep whose function changes nothing).  Times one ``torch.sort`` of
   the same keys as a yardstick, and then times each kernel, its plain
   version and, where one exists, the one PyTorch call computing the same
   function, on the inputs the async run gave it (the local sort on a fresh
   store's strided rows, as a round hands them over).
6. Runs a smaller matrix at 2^20 keys: all drivers, direct and indirect,
   random and duplicate-heavy keys, the dense routes, and a CPU-vs-GPU
   bit-for-bit comparison.
7. Prints the stage and kernel times, peak device memory, one ``kernels``
   JSON line, and last ``{"ok": true, "device": {...}}``.

A kernel's bound is the larger of two times: the bytes the function must
move (each input read once, each output written once) over the H100 SXM's
3.35 TB/s of HBM bandwidth, and the operations it must do over the card's
int32 rate, 16.7 T/s (132 SMs x 64 int32 lanes x 1.98 GHz; the data sheet
gives no int32 figure).  For a sort the operations are the comparisons any
comparison sort needs, log2(n!) per row of n; the bitonic network's own
min/max count describes the algorithm, not the function, and is printed
beside it for information.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
INT_MIN, INT_MAX = -2**31, 2**31 - 1
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.7e12


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rand_int32(shape, gen, kind="random"):
    dev = gen.device
    if kind == "random":
        x = torch.randint(INT_MIN, INT_MAX + 1, shape, generator=gen,
                          device=dev, dtype=torch.int64)
    elif kind == "dups":
        x = torch.randint(0, 4, shape, generator=gen, device=dev,
                          dtype=torch.int64)
    else:                                   # extremes
        pool = torch.tensor([INT_MIN, INT_MIN + 1, -1, 0, 1, INT_MAX - 1,
                             INT_MAX], device=dev)
        x = pool[torch.randint(0, len(pool), shape, generator=gen,
                               device=dev)]
    return x.to(torch.int32)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls (after one warm-up
    call), between CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def same(a, b, what: str) -> int:
    """Exact equality of two int32 tensors; returns the max |a - b| (0).
    Only the differing elements are widened, so an 8 GiB operand costs one
    byte per element of scratch."""
    torch.cuda.synchronize()
    check(a.shape == b.shape, f"{what}: shapes {a.shape} vs {b.shape}")
    ne = a != b
    err = 0
    if bool(ne.any()):
        err = int((a[ne].to(torch.int64) - b[ne].to(torch.int64)).abs().max())
    check(err == 0, f"{what}: max |kernel - plain| = {err}")
    return err


def network_ops(rows: int, n: int) -> int:
    """min + max operations of the bitonic network over [rows, n]."""
    L = n.bit_length() - 1
    return 2 * rows * (n // 2) * L * (L + 1) // 2


def sort_ops(rows: int, n: int) -> float:
    """Comparisons any comparison sort needs for [rows, n]: log2(n!) a row."""
    return rows * math.lgamma(n + 1) / math.log(2)


def bound(nbytes: int, ops: float = 0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def edge_checks(gen, kern) -> None:
    bs, km, dv = kern["bitonic"], kern["kway"], kern["deliver"]
    from repro_torch.kernels.bitonic_sort import bitonic_sort
    from repro_torch.kernels.kway_merge import kway_merge, kway_merge_ref
    for rows, n in [(1, 1), (1, 2), (3, 8), (2, 1024), (2, 8192),
                    (2, 16384), (3, 1 << 17)]:
        for kind in ("random", "dups", "extremes"):
            x = rand_int32((rows, n), gen, kind)
            y = bs.bitonic_sort_rows(x)
            same(y, bs.bitonic_network(x), f"bitonic {rows}x{n}")
            same(y, torch.sort(x, dim=-1).values, f"bitonic ref {rows}x{n}")
    wide = rand_int32((3, 3000), gen)                   # strided rows
    same(bs.bitonic_sort_rows(wide[:, 100:2148]),
         bs.bitonic_network(wide[:, 100:2148]), "bitonic strided")
    x = rand_int32((2, 1000), gen, "extremes")          # padded to 1024
    same(bitonic_sort(x), torch.sort(x, dim=-1).values, "ops.sort n=1000")
    for tile in (2, 8, 256, 8192, 16384):
        t = rand_int32((max(1, (1 << 16) // tile), tile), gen, "extremes")
        same(km.merge_tile_grid(t), km.sort_tile_rows(t), f"tile {tile}")
    for v, cap, rcap, tile in [(4, 16, 20, 8), (4, 16, 64, 2),
                               (4, 16, 100, 8), (16, 300, 600, 256)]:
        b = torch.sort(rand_int32((3, v, cap), gen, "dups"), dim=-1).values
        c = torch.randint(0, cap + 1, (3, v), generator=gen,
                          device=gen.device, dtype=torch.int32)
        m, _, _ = kway_merge(b, c, rcap=rcap, tile=tile, fill=INT_MAX)
        same(m, kway_merge_ref(b, c, rcap=rcap, fill=INT_MAX),
             f"kway_merge v={v} cap={cap} rcap={rcap} tile={tile}")
    for v, ww in [(1, 1), (3, 100), (4, 129), (16, 1000)]:
        src = rand_int32((v, v * ww + 7), gen)
        cnt = torch.randint(-2, ww + 3, (v, v + 2), generator=gen,
                            device=gen.device, dtype=torch.int32)
        cnt[0, 0], cnt[-1, 1 % v] = 0, ww
        for fill in (None, INT_MAX, -5):
            for payload in (False, True):
                outs = []
                for fn in (dv.deliver_words, dv.deliver_words_plain):
                    dst = torch.zeros((v, v * ww + 11), dtype=torch.int32,
                                      device=gen.device)
                    ct = torch.zeros((v, v + 3), dtype=torch.int32,
                                     device=gen.device)
                    fn(src, 7, dst, 11 - 11 % 2, v, ww,
                       None if fill is None else cnt, 2, fill,
                       cnt if payload else None, 1, ct if payload else None,
                       3)
                    outs += [dst, ct]
                what = f"deliver v={v} ww={ww} fill={fill} ct={payload}"
                same(outs[0], outs[2], what)
                same(outs[1], outs[3], what + " counts")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n", type=int, default=27,
                    help="log2 of the main run's key count (default 27)")
    ap.add_argument("--v", type=int, default=16)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed calls per kernel")
    ap.add_argument("--stage-reps", type=int, default=3,
                    help="staged PSRS runs timed stage by stage")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"card: {card}")

    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {so.name}")
    rows = run(torch.device("cuda"), args)
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(dev: torch.device, args) -> list:
    """Every phase after the build, on ``dev``; returns the ``kernels``
    rows."""
    from repro_torch.kernels.kway_merge.ops import gather_tiles
    from repro_torch.pems_apps import psrs_plan, psrs_sort
    # The kernel modules by name: each package re-exports a function of the
    # module's own name, which an attribute import would pick instead.
    bs, km, dv = (importlib.import_module(f"repro_torch.kernels.{m}.{m}")
                  for m in ("bitonic_sort", "kway_merge", "alltoallv_deliver"))
    kern = {"bitonic": bs, "kway": km, "deliver": dv}
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    t0 = time.perf_counter()
    edge_checks(gen, kern)
    print(f"edge checks: passed in {time.perf_counter() - t0:.2f} s")

    # ---- main path: psrs_sort at full scale, counts reset just before ----
    n, v, k = 1 << args.log_n, args.v, args.k
    n_v, tile = n // v, 256
    keys = rand_int32((n,), gen)
    ref = torch.sort(keys).values
    for mod in kern.values():
        mod.LAUNCHES = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = psrs_sort(keys, v=v, k=k, driver="async", use_kernel=True,
                    merge_kernel=True, device=dev)
    torch.cuda.synchronize()
    sort_s = time.perf_counter() - t0
    launches = {name: mod.LAUNCHES for name, mod in kern.items()}
    peak = torch.cuda.max_memory_allocated()
    check(torch.equal(out, ref), "psrs_sort output == torch.sort")
    check(all(c > 0 for c in launches.values()),
          f"every kernel launched on the main path: {launches}")
    del out
    print(f"psrs_sort n=2^{args.log_n} v={v} k={k} async: {sort_s:.3f} s "
          f"host clock (first call), launches {launches}, peak "
          f"{peak / 2**30:.2f} GiB")

    # ---- the same plan, stage by stage, under each driver ---------------
    # Async runs last: its finished store feeds the kernel timings below.
    # Each driver's swap cost is also timed alone, as a superstep whose
    # function changes nothing (explicit: none; sliced: a zeroed view of
    # each round; async: each round copied into a buffer and written back).
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    stage_ms, swap_ms = {}, {}
    for driver in ("explicit", "sliced", "async"):
        store = result = rcount = oflow = None   # free the last plan's store
        pems, load, steps, extract = psrs_plan(v, n_v, k=k, driver=driver,
                                               device=dev)
        ms = {name: [] for name in ["load"] + [nm for nm, _ in steps]}
        for _ in range(args.stage_reps):
            store = None                          # free the last run's store
            start.record()
            store = load(keys.reshape(v, n_v))
            end.record()
            end.synchronize()
            ms["load"].append(start.elapsed_time(end))
            for name, fn in steps:
                start.record()
                store = fn(store)
                end.record()
                end.synchronize()
                ms[name].append(start.elapsed_time(end))
        result, rcount, oflow = extract(store)
        check(int(rcount.sum()) == n,
              f"{driver}: rcount sums to n ({int(rcount.sum())})")
        check(int(oflow.sum()) == 0, f"{driver}: no overflow")
        counts = rcount[:, 0].tolist()
        check(torch.equal(torch.cat([result[i, :counts[i]]
                                     for i in range(v)]), ref),
              f"{driver}: staged plan output == torch.sort")
        swap_ms[driver] = cuda_ms(
            lambda: pems.superstep(store, lambda rhos, ctx: ctx, reads=[],
                                   writes=[]), args.reps)
        stage_ms[driver] = ms
    for driver, ms in stage_ms.items():
        totals = [sum(t) for t in zip(*ms.values())]
        for name, ts in list(ms.items()) + [("total", totals)]:
            print(f"stage {driver} {name}: median "
                  f"{statistics.median(ts):.3f} ms (min {min(ts):.3f}, "
                  f"max {max(ts):.3f}, {len(ts)} runs)")
        print(f"swap {driver}: {swap_ms[driver]:.3f} ms per superstep "
              f"({args.reps} no-op supersteps)")
    # Yardstick for the whole path: one library sort of the same keys.
    print(f"torch.sort of the same {n} keys: "
          f"{cuda_ms(lambda: torch.sort(keys), args.reps):.3f} ms")

    # ---- each kernel on the inputs the main path gave it --------------
    rows = []
    reps = args.reps

    lo = pems.layout
    tiles, _, _ = gather_tiles(store.field("brecv")[:k],
                               store.field("brcnt")[:k], rcap=2 * n_v,
                               tile=tile, fill=INT_MAX)
    err = same(km.merge_tile_grid(tiles), km.sort_tile_rows(tiles),
               "kway tiles main path")
    b_ms, b_by = bound(8 * tiles.numel(), sort_ops(*tiles.shape))
    rows.append(dict(
        name="kway_merge_tiles", route="cuda",
        source="src/repro_torch/csrc/bitonic_sort.cu",
        replaces="src/repro/kernels/kway_merge/kway_merge.py:65",
        launches=launches["kway"], max_abs_err=err,
        ms=cuda_ms(lambda: km.merge_tile_grid(tiles), reps),
        plain_ms=cuda_ms(lambda: km.sort_tile_rows(tiles), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.sort(tiles, dim=-1), reps),
        shape=f"[{tiles.shape[0]}, {tile}] int32",
        network=network_ops(*tiles.shape)))
    del tiles

    data = store.data
    ww = n_v                                  # cap words per message
    off_s, off_r = lo.offset("bsend"), lo.offset("brecv")
    off_c, off_rc = lo.offset("bscnt"), lo.offset("brcnt")

    def deliver(fn):
        return lambda: fn(data, off_s, data, off_r, v, ww, data, off_c,
                          INT_MAX, data, off_c, data, off_rc)

    deliver(dv.deliver_words)()
    got = store.field_words_view("brecv").clone()
    got_ct = store.field_words_view("brcnt").clone()
    deliver(dv.deliver_words_plain)()
    err = max(same(got, store.field_words_view("brecv"), "deliver main"),
              same(got_ct, store.field_words_view("brcnt"), "deliver ct"))
    del got, got_ct
    valid = int(store.field("bscnt").sum())
    b_ms, b_by = bound(4 * (valid + v * v * ww + 3 * v * v))
    rows.append(dict(
        name="alltoallv_deliver", route="cuda",
        source="src/repro_torch/csrc/alltoallv_deliver.cu",
        replaces="src/repro/kernels/alltoallv_deliver/"
                 "alltoallv_deliver.py:79",
        launches=launches["deliver"], max_abs_err=err,
        ms=cuda_ms(deliver(dv.deliver_words), reps),
        plain_ms=cuda_ms(deliver(dv.deliver_words_plain), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"v={v}, ww={ww} int32 words, {valid} valid"))
    store = data = result = rcount = oflow = None

    # The local sort's input as round 0 of sort_sample sees it: the "data"
    # field of the first k contexts of a freshly loaded store, rows one
    # context (the store's row stride) apart.
    store = load(keys.reshape(v, n_v))
    x = store.field("data")[:k]
    check(x.stride(0) == lo.words, f"strided rows ({x.stride()})")
    err = same(bs.bitonic_sort_rows(x), bs.bitonic_network(x),
               "bitonic main path")
    b_ms, b_by = bound(8 * x.numel(), sort_ops(k, n_v))
    rows.insert(0, dict(
        name="bitonic_sort", route="cuda",
        source="src/repro_torch/csrc/bitonic_sort.cu",
        replaces="src/repro/kernels/bitonic_sort/bitonic_sort.py:44",
        launches=launches["bitonic"], max_abs_err=err,
        ms=cuda_ms(lambda: bs.bitonic_sort_rows(x), reps),
        plain_ms=cuda_ms(lambda: bs.bitonic_network(x), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.sort(x, dim=-1), reps),
        shape=f"[{k}, {n_v}] int32, row stride {x.stride(0)}",
        network=network_ops(k, n_v)))
    del store, x, pems, load, steps, extract
    torch.cuda.empty_cache()

    # ---- smaller matrix ------------------------------------------------
    t0 = time.perf_counter()
    m = 1 << min(20, args.log_n)
    for kind in ("random", "dups"):
        mk = rand_int32((m,), gen, kind)
        mref = torch.sort(mk).values
        for driver in ("explicit", "sliced", "async"):
            for mode in ("direct", "indirect"):
                got = psrs_sort(mk, v=v, k=k, driver=driver, mode=mode,
                                device=dev)
                check(torch.equal(got, mref),
                      f"psrs 2^20 {kind} {driver} {mode}")
        for uk, mkn in ((False, True), (True, False)):
            got = psrs_sort(mk, v=v, k=k, use_kernel=uk, merge_kernel=mkn,
                            device=dev)
            check(torch.equal(got, mref),
                  f"psrs 2^20 {kind} use_kernel={uk} merge_kernel={mkn}")
    small = rand_int32((1 << 14,), gen, "extremes")
    check(torch.equal(psrs_sort(small, v=8, k=2, device=dev).cpu(),
                      psrs_sort(small.cpu(), v=8, k=2, device="cpu")),
          "psrs 2^14 GPU == CPU plain versions")
    print(f"matrix at 2^20: passed in {time.perf_counter() - t0:.2f} s")

    # ---- report ----------------------------------------------------------
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
        print(f"kernel {r['name']} {r['shape']}: {r['ms']:.3f} ms, "
              f"launches {r['launches']}, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"library {lib} ms")
        if "network" in r:
            print(f"  bitonic network: {r['network']:.4g} min/max, "
                  f"{r['network'] / INT32_OPS_PER_S * 1e3:.4f} ms at the "
                  "int32 rate (the algorithm's work, not the function's)")
    print(f"peak device memory (main path): {peak / 2**30:.2f} GiB; "
          f"whole script: {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          "GiB")
    return [{key: r[key] for key in r if key not in ("shape", "network")}
            for r in rows]


if __name__ == "__main__":
    sys.exit(main())
