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
   shapes (ragged widths, empty and full counts, extreme, duplicate and
   all-equal keys, rows and tiles up to and past one shared-memory segment,
   where the local sort turns from the bitonic pass to the radix kernel, and
   radix rows of several tiles, strided; for the k-way merge's splitters
   and segment merge, ``KWAY_EDGES``: v of 1 to 64, windows cut inside
   runs of equal keys, counts of 0 and of cap, fill-only segments, total
   past rcap, rcap past v·cap, tiles of 1 to 1024, many segments, and the
   tile sort up to and past the warp-register sort's 1024 keys; for the
   mesh staging, kernel 4, P of 1, 2 and 4, counts of 0, of ω, past ω and
   negative, fills None, -7 and INT_MAX with and without the counts payload,
   α-chunk offsets, and a float32 payload).  Equality is exact.
4. Drives the main path once through ``psrs_sort``: 2^27 int32 keys, v = 16,
   k = 4, the async driver, every kernel on; the output must equal
   ``torch.sort``, and the launch count (reset just before) of every kernel
   of the path must be above zero: the local sort, the delivery, and the
   merge's splitters and segment merge (the gathered-tile sort,
   ``merge_tile_grid``, is off the main path and reports its count).
5. Runs the same plan stage by stage (``psrs_plan``) a few times under
   each driver (explicit, sliced, async) with CUDA-event stage times,
   checks ``rcount``/``oflow``, and times each driver's swap cost alone (a
   superstep whose function changes nothing).  Times one ``torch.sort`` of
   the same keys as a yardstick, and then times each kernel, its plain
   version and, where one exists, the one PyTorch call computing the same
   function, on the inputs the async run gave it (the local sort on a fresh
   store's strided rows, as a round hands them over; the merge on round 0's
   received buckets where the store holds them).  Takes the merge stage's
   round 0 apart before and after the fused merge
   (``scripts/merge_stage_split.py``: each phase between CUDA events, and
   each route's device time by kernel from ``torch.profiler``).
5b. The ``P > 1`` path: ``psrs_sort`` on the same keys over ``MESH_P`` (4)
   real processors of a one-card mesh, k = ``MESH_K`` (2), unchunked under
   the async driver and α-chunked (α = 1) under the explicit driver.  Each
   run resets every kernel count just before it; its output must equal
   ``torch.sort`` and the ``P == 1`` run, the local sort, merge and mesh
   staging (kernel 4) counts must be above zero, and kernel 4's launches
   and ``pems.ledger.network_rounds`` must equal the closed form of
   ``repro_torch.core.analysis``.  Times both plans stage by stage, prints
   their ``alltoallv`` stage beside the ``P == 1`` ones, and times kernel 4
   and its plain version on the α = 1 run's first chunk.
6. Runs a smaller matrix at 2^20 keys: all drivers, direct and indirect,
   random and duplicate-heavy keys, the dense routes, P of 2 and 4 over
   every driver, mode and α in {None, 1}, and CPU-vs-GPU bit-for-bit
   comparisons at 2^14 keys (P = 1, and P = 4 with equal ledgers).
7. The LM serving path.  Holds flash attention, the SSD scan and the LRU
   scan against their plain versions at the CPU tests' edge shapes, at
   qwen2's head dim 128 and at recurrentgemma's sliding window and head dim
   256 (float32, atol 1e-5; SSD within 1e-4 (1 + |plain|), LRU within
   1e-5 (1 + |plain|)), then the same flash calls in bf16, on the
   tensor-core kernel, within 2^-10 + 2^-7 |plain| (``sk_valid`` 0, 1 and
   sk/2 + 1, decode ``q_offset``, windows 1, 16 and 100).  Runs the
   smoke-width qwen2-1.5b, mamba2-130m and recurrentgemma-2b in float32
   with TF32 off on the card and on the CPU from the same parameters
   (40-token prompts, past recurrentgemma's smoke window of 16): prefill
   logits within 1e-4, greedy tokens equal.
8. Serves qwen2-1.5b, mamba2-130m and recurrentgemma-2b at full width
   (bf16, random weights from ``--seed``): ``REQUESTS`` (8) prompts of
   ``PROMPT_LEN`` (1024) tokens, or ``HYBRID_PROMPT_LEN`` (3072, so that
   its 2048-token window masks keys) for recurrentgemma, ``GEN_LEN`` (64)
   greedy tokens, every kernel's count reset just before each run and the
   model's own kernels (recurrentgemma: the LRU scan and flash attention)
   required above zero after it.  Prints prefill ms, decode ms per step
   (median), generated tokens/s and peak memory, checks the tokens and that
   the prefill logits keep a cosine of 0.99 with the same model on the
   kernels' plain versions, and times the prefill and one decode step on
   the device alone, layer by layer queued behind a sleep kernel, to give
   the device's busy share.
9. Holds each float kernel against its plain version at the serve shapes
   (flash: qwen2's causal prefill over the cache and a decode call whose
   ``sk_valid`` is no tile multiple, and recurrentgemma's windowed ones,
   bf16 within 2^-10 + 2^-7 |plain|: both sum in fp32 and round once, the
   kernel's P entering P·V as bf16 hi + lo, so they differ by one bf16 ulp
   at most; SSD: the prompt length and a ragged
   one; LRU: the prompt length and a ragged one) and times it beside its
   plain version and ``scaled_dot_product_attention`` (never called by the
   port); the short decode calls, and their library calls, on the device
   alone.
10. Prints the stage and kernel times, peak device memory, one ``kernels``
   JSON line, and last ``{"ok": true, "device": {...}}``.

A kernel's bound is the larger of two times: the bytes the function must
move (each input read once, each output written once) over the H100 SXM's
3.35 TB/s of HBM bandwidth, and the operations it must do over the card's
rate for their type: int32 16.7 T/s (132 SMs x 64 int32 lanes x 1.98 GHz;
the data sheet gives no int32 figure), bf16 989 TFLOP/s on the tensor
cores, fp32 67 TFLOP/s outside them, and fp32 to fp32 accuracy on the
tensor cores as 3xTF32 (three TF32 products a product, the SSD kernel's
way) at a third of dense TF32's 494.7 TFLOP/s.  For a sort the operations
are the comparisons any comparison sort needs, log2(n!) per row of n; the
k-way merge tiles' bitonic network's own min/max count describes the
algorithm, not the function, and is printed beside it for information.
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
BF16_FLOPS_PER_S = 989e12   # dense bf16 on the tensor cores
FP32_FLOPS_PER_S = 67e12    # fp32 outside the tensor cores
TF32_FLOPS_PER_S = 494.7e12  # dense TF32 on the tensor cores
# fp32 work done as 3xTF32: three TF32 products for each one
TF32X3_FLOPS_PER_S = TF32_FLOPS_PER_S / 3


# Kernel 4 (the P > 1 mesh staging) edge shapes, as assemble_words takes
# them: (m, P, nq, s0, s, c0, d, ww) — P of 1, 2 and 4, ragged ω and ω past
# one block's 1024-word chunk, α-chunk offsets s0, c0 != 0.
ASSEMBLE_EDGES = [(1, 1, 1, 0, 1, 0, 1, 1), (4, 2, 2, 0, 4, 0, 4, 127),
                  (4, 4, 4, 2, 2, 1, 1, 300), (4, 4, 3, 1, 3, 2, 2, 1030),
                  (2, 4, 4, 0, 2, 0, 2, 1)]
# The P > 1 path: real processors on the one card, and contexts resident
# per real processor.
MESH_P, MESH_K = 4, 2
# The fused k-way merge's edges, (k, v, cap, keys, counts, rcap, tile,
# segment tiles), as tests/test_torch_gpu.py has them: v of 1, 16, 33 and 64
# (one and two warps of buckets, odd merge levels), windows cut inside runs
# of equal keys, all-equal buckets, one bucket a segment, counts of 0 and of
# cap, fill-only segments, total past rcap, rcap past v·cap and ragged,
# tiles of 1 to 1024, many segments, the built size (32 tiles of 256) and
# twice it.
KWAY_EDGES = [(2, 1, 300, "dups", "random", 600, 256, 1),
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
# Each kernel's launch counter on the PSRS paths: (module, attribute).
COUNTERS = {"radix_sort": ("bitonic", "LAUNCHES"),
            "alltoallv_deliver": ("deliver", "LAUNCHES"),
            "kway_splitters": ("kway", "SPLIT_LAUNCHES"),
            "kway_merge_segments": ("kway", "SEGMENT_LAUNCHES"),
            "kway_merge_tiles": ("kway", "LAUNCHES"),
            "assemble_proc_tiles": ("deliver", "ASSEMBLE_LAUNCHES")}


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
    elif kind == "equal":                   # one bin holds the whole row
        x = torch.full(shape, -3, device=dev, dtype=torch.int64)
    else:                                   # extremes
        pool = torch.tensor([INT_MIN, INT_MIN + 1, -1, 0, 1, INT_MAX - 1,
                             INT_MAX], device=dev)
        x = pool[torch.randint(0, len(pool), shape, generator=gen,
                               device=dev)]
    return x.to(torch.int32)


def kway_inputs(gen, k, v, cap, kind, cnt_kind):
    """Sorted buckets ``[k, v, cap]`` whose lanes past the counts hold random
    words, as strided views of wider rows, and their counts (a view too)."""
    dev = gen.device
    if kind == "presorted":                   # bucket j below bucket j + 1
        b = torch.arange(k * v * cap, device=dev, dtype=torch.int32)
        b = b.reshape(k, v, cap)
    else:
        b = torch.sort(rand_int32((k, v, cap), gen, kind), dim=-1).values
    c = {"random": torch.randint(0, cap + 1, (k, v), generator=gen,
                                 device=dev, dtype=torch.int32),
         "full": torch.full((k, v), cap, device=dev, dtype=torch.int32),
         "zero": torch.zeros((k, v), device=dev, dtype=torch.int32)}[cnt_kind]
    if cnt_kind == "random":
        c[0, 0], c[-1, -1] = 0, cap
    lane = torch.arange(cap, device=dev)
    b = torch.where(lane < c[..., None], b, rand_int32((k, v, cap), gen))
    rows = torch.zeros((k, v * cap + v + 40), dtype=torch.int32, device=dev)
    rows[:, 24:24 + v * cap] = b.reshape(k, -1)
    rows[:, 24 + v * cap:24 + v * cap + v] = c
    return (rows[:, 24:24 + v * cap].view(k, v, cap),
            rows[:, 24 + v * cap:24 + v * cap + v])


def set_counts(kern, value: int = 0) -> None:
    for mod, attr in COUNTERS.values():
        setattr(kern[mod], attr, value)


def read_counts(kern, names) -> dict:
    return {n: getattr(kern[COUNTERS[n][0]], COUNTERS[n][1]) for n in names}


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


def bound(nbytes: int, ops: float = 0, rate: float = INT32_OPS_PER_S):
    """(ms, what bounds it): the larger of the bytes over the HBM rate and
    the operations over ``rate``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def edge_checks(gen, kern) -> None:
    bs, km, dv = kern["bitonic"], kern["kway"], kern["deliver"]
    from repro_torch.kernels.bitonic_sort import bitonic_sort
    from repro_torch.kernels.kway_merge import kway_merge, kway_merge_ref
    # The local sort: one shared-memory bitonic pass up to 2^13 keys a row,
    # the radix kernel past it (2^14), over several tiles (2^16, 2^17).
    for rows, n in [(1, 1), (1, 2), (3, 8), (2, 1024), (2, 8192),
                    (2, 16384), (3, 1 << 16), (3, 1 << 17)]:
        for kind in ("random", "dups", "extremes", "equal"):
            x = rand_int32((rows, n), gen, kind)
            y = bs.bitonic_sort_rows(x)
            same(y, bs.radix_sort_plain(x), f"local sort {rows}x{n} {kind}")
            same(y, torch.sort(x, dim=-1).values,
                 f"local sort ref {rows}x{n} {kind}")
    for n in (2048, 1 << 16):                           # strided rows
        wide = rand_int32((3, n + 300), gen)[:, 100:100 + n]
        same(bs.bitonic_sort_rows(wide), bs.radix_sort_plain(wide),
             f"local sort strided n={n}")
        same(bs.bitonic_sort_rows(wide), torch.sort(wide, dim=-1).values,
             f"local sort strided ref n={n}")
    x = rand_int32((2, 1000), gen, "extremes")          # padded to 1024
    same(bitonic_sort(x), torch.sort(x, dim=-1).values, "ops.sort n=1000")
    # The tile sort: warp registers up to 1024 keys, the bitonic passes past.
    for tile in (1, 2, 8, 256, 1024, 2048, 8192, 16384):
        t = rand_int32((max(1, (1 << 16) // tile), tile), gen, "extremes")
        same(km.merge_tile_grid(t), km.sort_tile_rows(t), f"tile {tile}")
    for v, cap, rcap, tile in [(4, 16, 20, 8), (4, 16, 64, 2),
                               (4, 16, 100, 8), (16, 300, 600, 256),
                               (16, 300, 600, 2048)]:
        b = torch.sort(rand_int32((3, v, cap), gen, "dups"), dim=-1).values
        c = torch.randint(0, cap + 1, (3, v), generator=gen,
                          device=gen.device, dtype=torch.int32)
        m, _, _ = kway_merge(b, c, rcap=rcap, tile=tile, fill=INT_MAX)
        same(m, kway_merge_ref(b, c, rcap=rcap, fill=INT_MAX),
             f"kway_merge v={v} cap={cap} rcap={rcap} tile={tile}")
    # The fused merge's two kernels against their plain versions, on
    # buckets laid out as the merge stage finds them (strided views).
    for k, v, cap, kind, cnts, rcap, tile, S in KWAY_EDGES:
        b, c = kway_inputs(gen, k, v, cap, kind, cnts)
        ranks = km.coarse_ranks(rcap, tile, S, v * cap, gen.device)
        what = f"kway k={k} v={v} cap={cap} {kind} {cnts} rcap={rcap} " \
               f"tile={tile} S={S}"
        starts = km.exact_splitters(b, c, ranks)
        same(starts, km.exact_splitters_plain(b, c, ranks), what + " starts")
        got = km.merge_segments(b, c, starts, rcap=rcap, tile=tile,
                                seg_tiles=S)
        same(got, km.merge_segments_plain(b, c, starts, rcap=rcap, tile=tile,
                                          seg_tiles=S), what)
        same(got, kway_merge_ref(b, c, rcap=rcap, fill=INT_MAX),
             what + " == kway_merge_ref")
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
    for m, P, nq, s0, s, c0, d, ww in ASSEMBLE_EDGES:
        v = m * P
        src = rand_int32((v, 9 + v * ww), gen)
        cnt = torch.randint(-2, ww + 3, (v, v + 4), generator=gen,
                            device=gen.device, dtype=torch.int32)
        # Counts of 0, of ω, past ω and negative.
        cnt[0, 4:8] = torch.tensor([0, ww, ww + 5, -3],
                                   device=gen.device)[:v]
        for fill in (None, -7, INT_MAX):
            for payload in (False, True):
                outs = []
                for fn in (dv.assemble_words, dv.assemble_words_plain):
                    out = torch.zeros(nq * P * d * s * ww, dtype=torch.int32,
                                      device=gen.device)
                    ct = torch.zeros(nq * P * d * s, dtype=torch.int32,
                                     device=gen.device)
                    fn(src, 9, m, P, nq, s0, s, c0, d, ww, out,
                       None if fill is None else cnt, 4, fill,
                       cnt if payload else None, 4, ct if payload else None)
                    outs += [out, ct]
                what = (f"assemble m={m} P={P} nq={nq} s0={s0} s={s} "
                        f"c0={c0} d={d} ww={ww} fill={fill} ct={payload}")
                same(outs[0], outs[2], what)
                same(outs[1], outs[3], what + " counts")
    # The array form, float32 payload and counts payload, a float fill.
    from repro_torch.kernels.alltoallv_deliver.ref import assemble_proc_ref
    msgs = torch.randn((2, 4, 3, 300), generator=gen, device=gen.device)
    cnt = torch.randint(-2, 303, (2, 4, 3), generator=gen, device=gen.device,
                        dtype=torch.int32)
    got = dv.assemble_proc_tiles(msgs, cnt, cnt.float(), fill=-1.5)
    want = assemble_proc_ref(msgs, cnt, cnt.float(), fill=-1.5)
    for g, w in zip(got, want):
        same(g.view(torch.int32), w.view(torch.int32), "assemble float32")


def merge_rows(km, recv, cnt, rcap: int, tile: int, launches, reps) -> list:
    """Kernel 3's fused merge on the main path's received buckets (round 0,
    ``recv [k, v, cap]`` and ``cnt [k, v]`` as the store holds them): the
    splitters and the segment merge, each held exactly against its plain
    version and timed beside it, with its bound.  The segments' library
    call is one ``torch.sort`` of the count-masked ``[k, v·cap]`` rows, as
    ``kway_merge_ref`` does (the mask made outside the timed call)."""
    from repro_torch.kernels.kway_merge import kway_merge
    k, v, cap = recv.shape
    S = km.segment_tiles(v, tile)
    ranks = km.coarse_ranks(rcap, tile, S, v * cap, recv.device)
    R = ranks.numel()
    starts = km.exact_splitters(recv, cnt, ranks)
    err = same(starts, km.exact_splitters_plain(recv, cnt, ranks),
               "splitters main path")
    # A search reads about log2(cap + 1) keys of a bucket for each rank and
    # writes the starts.
    probes = k * R * v * math.ceil(math.log2(cap + 1))
    b_ms, b_by = bound(4 * (probes + k * v + k * R * v) + 8 * R, probes)
    rows = [dict(
        name="kway_splitters", route="cuda",
        source="src/repro_torch/csrc/kway_merge.cu",
        replaces="src/repro/kernels/kway_merge/kway_merge.py:65",
        launches=launches["kway_splitters"], max_abs_err=err,
        ms=cuda_ms(lambda: km.exact_splitters(recv, cnt, ranks), reps),
        plain_ms=cuda_ms(lambda: km.exact_splitters_plain(recv, cnt, ranks),
                         2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"[{k}, {v}, {cap}] int32 buckets, strides {recv.stride()}, "
              f"{R} coarse ranks (S {S})")]

    def segments():
        return km.merge_segments(recv, cnt, starts, rcap=rcap, tile=tile,
                                 seg_tiles=S)

    got = segments()
    err = same(got, km.merge_segments_plain(recv, cnt, starts, rcap=rcap,
                                            tile=tile, seg_tiles=S),
               "segments main path")
    masked = km.mask_buckets(recv, cnt).reshape(k, v * cap)
    same(got, torch.sort(masked, dim=-1).values[:, :rcap],
         "fused merge main path == torch.sort of the masked rows")
    # Reads the valid keys of rank below rcap, writes k·rcap keys;
    # n·log2(v) comparisons merge them.
    valid = int(torch.clamp(cnt.to(torch.int64), 0, cap).sum(dim=1)
                .clamp(max=rcap).sum())
    b_ms, b_by = bound(4 * (valid + k * rcap + starts.numel() + k * v),
                       valid * math.log2(max(v, 2)))
    rows.append(dict(
        name="kway_merge_segments", route="cuda",
        source="src/repro_torch/csrc/kway_merge.cu",
        replaces="src/repro/kernels/kway_merge/kway_merge.py:65",
        launches=launches["kway_merge_segments"], max_abs_err=err,
        ms=cuda_ms(segments, reps),
        plain_ms=cuda_ms(lambda: km.merge_segments_plain(
            recv, cnt, starts, rcap=rcap, tile=tile, seg_tiles=S), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.sort(masked, dim=-1), reps),
        shape=f"[{k}, {v}, {cap}] int32 buckets, {valid} valid keys below "
              f"rcap, merged [{k}, {rcap}], tile {tile}, S {S}"))
    del masked, got
    whole = cuda_ms(lambda: kway_merge(recv, cnt, rcap=rcap, tile=tile,
                                       fill=INT_MAX), reps)
    print(f"kway_merge of round 0 (both launches and the totals): "
          f"{whole:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
    return rows


def merge_split(recv, cnt, rcap: int, result) -> None:
    """The merge stage's round 0 taken apart on the card, before and after
    the fused merge (``scripts/merge_stage_split.py``): the gather route's
    phases (mask, splitter search, gather, tile sort, result copy) and the
    fused route's, each between CUDA events, and each route's device time
    by kernel (``torch.profiler``)."""
    import merge_stage_split as mss
    km = importlib.import_module("repro_torch.kernels.kway_merge.kway_merge")
    ops = importlib.import_module("repro_torch.kernels.kway_merge.ops")
    k = recv.shape[0]

    def gather_round():
        tiles, _, _ = ops.gather_tiles(recv, cnt, rcap=rcap, tile=mss.TILE,
                                       fill=INT_MAX)
        result.copy_(km.merge_tile_grid(tiles).reshape(k, -1)[:, :rcap])

    def fused_round():
        m, _, _ = ops.kway_merge(recv, cnt, rcap=rcap, tile=mss.TILE,
                                 fill=INT_MAX)
        result.copy_(m)

    for route, split, whole in (
            ("gather (before)", mss.gather_route_split, gather_round),
            ("fused (after)", mss.fused_route_split, fused_round)):
        ms = split(recv, cnt, rcap, result)
        print(f"merge round 0, {route} route: " + ", ".join(
            f"{name} {t:.3f} ms" for name, t in ms.items())
            + f"; sum {sum(ms.values()):.3f} ms")
        print(f"merge round 0, {route} route, device ms by kernel "
              "(torch.profiler; ms, launches, kernel):")
        for name, t, n in mss.by_kernel(whole):
            print(f"  {t:9.3f} {n:5d}  {name[:100]}")


def staged(load, steps, extract, keys, v, reps, ref, what):
    """Run a ``psrs_plan`` ``reps`` times stage by stage with CUDA-event
    times; check its output against ``ref``.  Returns ``({stage: [ms]},
    the last run's store)``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n_v = keys.numel() // v
    ms = {name: [] for name in ["load"] + [nm for nm, _ in steps]}
    store = None
    for _ in range(reps):
        store = None                              # free the last run's store
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
    check(int(rcount.sum()) == keys.numel(),
          f"{what}: rcount sums to n ({int(rcount.sum())})")
    check(int(oflow.sum()) == 0, f"{what}: no overflow")
    counts = rcount[:, 0].tolist()
    check(torch.equal(torch.cat([result[i, :counts[i]] for i in range(v)]),
                      ref), f"{what}: staged plan output == torch.sort")
    return ms, store


def print_stages(what, ms):
    totals = [sum(t) for t in zip(*ms.values())]
    for name, ts in list(ms.items()) + [("total", totals)]:
        print(f"stage {what} {name}: median "
              f"{statistics.median(ts):.3f} ms (min {min(ts):.3f}, "
              f"max {max(ts):.3f}, {len(ts)} runs)")


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
    sys.path.insert(0, str(ROOT / "scripts"))
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {so.name}")
    dev = torch.device("cuda")
    rows = run(dev, args)
    rows += run_lm(dev, args)
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(dev: torch.device, args) -> list:
    """Every phase after the build, on ``dev``; returns the ``kernels``
    rows."""
    from repro_torch.core import make_mesh
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
    set_counts(kern)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = psrs_sort(keys, v=v, k=k, driver="async", use_kernel=True,
                    merge_kernel=True, device=dev)
    torch.cuda.synchronize()
    sort_s = time.perf_counter() - t0
    launches = read_counts(kern, COUNTERS)
    peak = torch.cuda.max_memory_allocated()
    check(torch.equal(out, ref), "psrs_sort output == torch.sort")
    # The merge stage runs the fused merge (splitters and segments); the
    # gathered-tile sort runs only for tiles past 1024 keys.
    path = ("radix_sort", "alltoallv_deliver", "kway_splitters",
            "kway_merge_segments")
    check(all(launches[name] > 0 for name in path),
          f"every kernel of the main path launched: {launches}")
    out_p1 = out
    del out
    print(f"psrs_sort n=2^{args.log_n} v={v} k={k} async: {sort_s:.3f} s "
          f"host clock (first call), launches {launches}, peak "
          f"{peak / 2**30:.2f} GiB")

    # ---- the same plan, stage by stage, under each driver ---------------
    # Async runs last: its finished store feeds the kernel timings below.
    # Each driver's swap cost is also timed alone, as a superstep whose
    # function changes nothing (explicit: none; sliced: a zeroed view of
    # each round; async: each round copied into a buffer and written back).
    stage_ms, swap_ms = {}, {}
    for driver in ("explicit", "sliced", "async"):
        store = None                              # free the last plan's store
        pems, load, steps, extract = psrs_plan(v, n_v, k=k, driver=driver,
                                               device=dev)
        ms, store = staged(load, steps, extract, keys, v, args.stage_reps,
                           ref, driver)
        swap_ms[driver] = cuda_ms(
            lambda: pems.superstep(store, lambda rhos, ctx: ctx, reads=[],
                                   writes=[]), args.reps)
        stage_ms[driver] = ms
    for driver, ms in stage_ms.items():
        print_stages(driver, ms)
        print(f"swap {driver}: {swap_ms[driver]:.3f} ms per superstep "
              f"({args.reps} no-op supersteps)")
    # Yardstick for the whole path: one library sort of the same keys.
    print(f"torch.sort of the same {n} keys: "
          f"{cuda_ms(lambda: torch.sort(keys), args.reps):.3f} ms")

    # ---- each kernel on the inputs the main path gave it --------------
    rows = []
    reps = args.reps

    lo = pems.layout
    rcap = 2 * n_v
    recv, rcnt = store.field("brecv")[:k], store.field("brcnt")[:k]
    rows += merge_rows(km, recv, rcnt, rcap, tile, launches, reps)
    merge_split(recv, rcnt, rcap, store.field("result")[:k])
    tiles, _, _ = gather_tiles(recv, rcnt, rcap=rcap, tile=tile, fill=INT_MAX)
    err = same(km.merge_tile_grid(tiles), km.sort_tile_rows(tiles),
               "kway tiles main path")
    b_ms, b_by = bound(8 * tiles.numel(), sort_ops(*tiles.shape))
    rows.append(dict(
        name="kway_merge_tiles", route="cuda",
        source="src/repro_torch/csrc/kway_merge.cu",
        replaces="src/repro/kernels/kway_merge/kway_merge.py:65",
        launches=launches["kway_merge_tiles"], max_abs_err=err,
        ms=cuda_ms(lambda: km.merge_tile_grid(tiles), reps),
        plain_ms=cuda_ms(lambda: km.sort_tile_rows(tiles), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.sort(tiles, dim=-1), reps),
        shape=f"[{tiles.shape[0]}, {tile}] int32, the gather route's tiles "
              "(off the main path since the fused merge)",
        network=network_ops(*tiles.shape)))
    del tiles, recv, rcnt

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
        launches=launches["alltoallv_deliver"], max_abs_err=err,
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
    got = bs.bitonic_sort_rows(x)
    err = max(same(got, bs.radix_sort_plain(x), "radix main path"),
              same(got, torch.sort(x, dim=-1).values,
                   "radix main path == torch.sort"))
    del got
    b_ms, b_by = bound(8 * x.numel(), sort_ops(k, n_v))
    rows.insert(0, dict(
        name="radix_sort", route="cuda",
        source="src/repro_torch/csrc/radix_sort.cu",
        replaces="src/repro/kernels/bitonic_sort/bitonic_sort.py:44",
        launches=launches["radix_sort"], max_abs_err=err,
        ms=cuda_ms(lambda: bs.bitonic_sort_rows(x), reps),
        plain_ms=cuda_ms(lambda: bs.radix_sort_plain(x), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.sort(x, dim=-1), reps),
        shape=f"[{k}, {n_v}] int32, row stride {x.stride(0)}"))
    del store, x, pems, load, steps, extract
    torch.cuda.empty_cache()

    # run_mesh resets the peak for its own runs: keep the larger one.
    script_peak = torch.cuda.max_memory_allocated()
    rows.append(run_mesh(dev, args, keys, ref, out_p1, kern, stage_ms))
    del out_p1
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
        # P > 1 on the one card: P real processors of v/P contexts each.
        for P in (2, MESH_P):
            mesh = make_mesh(P, device=dev)
            for driver in ("explicit", "sliced", "async"):
                for mode in ("direct", "indirect"):
                    for alpha in (None, 1):
                        got = psrs_sort(mk, v=v, k=MESH_K, P=P, mesh=mesh,
                                        alpha=alpha, driver=driver,
                                        mode=mode, device=dev)
                        check(torch.equal(got, mref),
                              f"psrs 2^20 {kind} P={P} {driver} {mode} "
                              f"alpha={alpha}")
            got = psrs_sort(mk, v=v, k=MESH_K, P=P, mesh=mesh, alpha=1,
                            use_kernel=False, device=dev)
            check(torch.equal(got, mref),
                  f"psrs 2^20 {kind} P={P} use_kernel=False")
    small = rand_int32((1 << 14,), gen, "extremes")
    check(torch.equal(psrs_sort(small, v=8, k=2, device=dev).cpu(),
                      psrs_sort(small.cpu(), v=8, k=2, device="cpu")),
          "psrs 2^14 GPU == CPU plain versions")
    kw = dict(v=v, k=MESH_K, P=MESH_P, alpha=1, return_pems=True)
    got, gp = psrs_sort(small, mesh=make_mesh(MESH_P, device=dev),
                        device=dev, **kw)
    want, cp = psrs_sort(small.cpu(), mesh=make_mesh(MESH_P, device="cpu"),
                         device="cpu", **kw)
    check(torch.equal(got.cpu(), want)
          and gp.ledger.snapshot() == cp.ledger.snapshot(),
          f"psrs 2^14 P={MESH_P} GPU == CPU plain versions, equal ledgers")
    print(f"matrix at 2^20: passed in {time.perf_counter() - t0:.2f} s")

    # ---- report ----------------------------------------------------------
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
        print(f"kernel {r['name']} {r['shape']}: {r['ms']:.3f} ms, "
              f"launches {r['launches']}, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"library {lib} ms")
        if "network" in r:
            print(f"  tile bitonic network: {r['network']:.4g} min/max, "
                  f"{r['network'] / INT32_OPS_PER_S * 1e3:.4f} ms at the "
                  "int32 rate (the algorithm's work, not the function's)")
    script_peak = max(script_peak, torch.cuda.max_memory_allocated())
    print(f"peak device memory (main path): {peak / 2**30:.2f} GiB; "
          f"whole script: {script_peak / 2**30:.2f} GiB")
    return [{key: r[key] for key in r if key not in ("shape", "network")}
            for r in rows]


def run_mesh(dev, args, keys, ref, out_p1, kern, stage_ms_p1) -> dict:
    """The ``P > 1`` path on the one card: ``psrs_sort`` over ``MESH_P``
    real processors (row blocks of one store, a one-device mesh) on the main
    path's keys, unchunked under the async driver and α-chunked (α = 1)
    under the explicit driver, each with every kernel count reset just
    before it; then the same plans stage by stage, and kernel 4 timed on the
    α = 1 run's first chunk.  Returns kernel 4's ``kernels`` row."""
    from repro_torch.core import analysis, make_mesh
    from repro_torch.pems_apps import psrs_plan, psrs_sort
    dv = kern["deliver"]
    n, v, P, k = keys.numel(), args.v, MESH_P, MESH_K
    n_v, m = n // v, v // MESH_P
    mesh = make_mesh(P, device=dev)
    runs = (("async", None), ("explicit", 1))
    launches = {}
    for driver, alpha in runs:
        set_counts(kern)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, pems = psrs_sort(keys, v=v, k=k, P=P, mesh=mesh, alpha=alpha,
                              driver=driver, device=dev, return_pems=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = read_counts(kern, ("radix_sort", "kway_splitters",
                                 "kway_merge_segments",
                                 "assemble_proc_tiles"))
        what = f"P={P} {driver} alpha={alpha}"
        check(torch.equal(out, ref), f"psrs_sort {what} == torch.sort")
        check(torch.equal(out, out_p1), f"psrs_sort {what} == the P=1 run")
        check(all(c > 0 for c in got.values()),
              f"every kernel of the P > 1 path launched ({what}): {got}")
        rounds = analysis.pems2_alltoallv_par_network_rounds(v, P, k, alpha)
        check(pems.ledger.network_rounds == rounds
              == got["assemble_proc_tiles"],
              f"{what}: network_rounds {pems.ledger.network_rounds}, "
              f"closed form {rounds}, kernel 4 launches "
              f"{got['assemble_proc_tiles']}")
        launches[(driver, alpha)] = got
        print(f"psrs_sort n=2^{args.log_n} v={v} k={k} {what}: {secs:.3f} s "
              f"host clock (first call), launches {got}, network_rounds "
              f"{rounds}, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del out, pems

    stage_ms = {}
    for driver, alpha in runs:
        store = None                              # free the last plan's store
        pems, load, steps, extract = psrs_plan(v, n_v, k=k, P=P, mesh=mesh,
                                               alpha=alpha, driver=driver,
                                               device=dev)
        what = f"P={P} {driver} alpha={alpha}"
        stage_ms[what], store = staged(load, steps, extract, keys, v,
                                       args.stage_reps, ref, what)
    for what, ms in stage_ms.items():
        print_stages(what, ms)
    med = {what: statistics.median(ms["alltoallv"])
           for what, ms in list(stage_ms_p1.items()) + list(stage_ms.items())}
    print("alltoallv stage, median ms: " + ", ".join(
        f"{'P=1 ' + w if 'P=' not in w else w} {t:.3f}"
        for w, t in med.items()) + " (the P > 1 exchange is a copy within "
        "the card's HBM, no network)")

    # Kernel 4 on the α = 1 run's first chunk: source round 0 (s = k rows of
    # every sender), destination chunk 0 (d = 1 context of every process).
    lo, data = pems.layout, store.data
    off_s, off_c = lo.offset("bsend"), lo.offset("bscnt")
    s, d = k, 1
    nmsg = P * P * d * s
    bufs = [torch.empty(nmsg * n_v, dtype=torch.int32, device=dev)
            for _ in range(2)]
    cts = [torch.empty(nmsg, dtype=torch.int32, device=dev)
           for _ in range(2)]

    def stage(fn, i):
        return lambda: fn(data, off_s, m, P, P, 0, s, 0, d, n_v, bufs[i],
                          data, off_c, INT_MAX, data, off_c, cts[i])

    stage(dv.assemble_words, 0)()
    stage(dv.assemble_words_plain, 1)()
    err = max(same(bufs[0], bufs[1], "assemble main path"),
              same(cts[0], cts[1], "assemble main path counts"))
    # The chunk's valid words: counts of rows q·m + j (j < s) for the
    # destinations p·m (d = 1), clamped to [0, ω].
    cnt = store.field("bscnt").reshape(P, m, P, m)[:, :s, :, :d]
    valid = int(cnt.clamp(0, n_v).sum())
    b_ms, b_by = bound(4 * (valid + nmsg * n_v + 3 * nmsg))
    row = dict(
        name="assemble_proc_tiles", route="cuda",
        source="src/repro_torch/csrc/alltoallv_deliver.cu",
        replaces="src/repro/kernels/alltoallv_deliver/"
                 "alltoallv_deliver.py:163",
        launches=launches[("explicit", 1)]["assemble_proc_tiles"],
        max_abs_err=err,
        ms=cuda_ms(stage(dv.assemble_words, 0), args.reps),
        plain_ms=cuda_ms(stage(dv.assemble_words_plain, 1), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"P={P} senders x [s={s}, P={P}, d={d}, ww={n_v}] int32 "
              f"words, {valid} valid")
    print("kernel 4 launches per run: " + ", ".join(
        f"P={P} {dr} alpha={a}: {c['assemble_proc_tiles']}"
        for (dr, a), c in launches.items()))
    # Where the alltoallv stage's time goes: the exchange (a strided copy of
    # the chunk into the recv rows) beside kernel 4, on the same chunk, and
    # kernel 4 on the unchunked run's one chunk (s = d = m, 8 GiB at 2^27).
    off_r = lo.offset("brecv")
    recv = data[:, off_r:off_r + v * n_v].view(P, m, P, m, n_v)
    dst = recv[:, :d, :, :s].permute(0, 2, 1, 3, 4)
    out = bufs[0].view(P, P, d, s, n_v)
    print(f"alltoallv P={P} alpha=1 first chunk: kernel 4 {row['ms']:.3f} "
          f"ms, exchange (Mesh.all_to_all) "
          f"{cuda_ms(lambda: mesh.all_to_all(out, dst), args.reps):.3f} ms "
          f"for {out.numel() * 4 / 2**30:.2f} GiB")
    del bufs, out, dst
    whole = torch.empty(P * P * m * m * n_v, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: dv.assemble_words(data, off_s, m, P, P, 0, m, 0, m,
                                           n_v, whole, data, off_c, INT_MAX),
                 args.reps)
    print(f"kernel 4 on the unchunked chunk [P={P}, P={P}, {m}, {m}, {n_v}] "
          f"({whole.numel() * 4 / 2**30:.2f} GiB written): {ms:.3f} ms")
    return row


# --------------------------------------------------------------------------- #
# The LM serving path: flash attention (qwen2) and the SSD scan (mamba2).     #
# --------------------------------------------------------------------------- #

# The serve path's shapes: requests, prompt tokens and generated tokens;
# recurrentgemma's prompt is longer than its 2048-token window.
REQUESTS, PROMPT_LEN, GEN_LEN = 8, 1024, 64
HYBRID_PROMPT_LEN = 3072
# Flash attention edge shapes of tests/test_torch_flash_attention.py, in
# [B, S, H, d] terms: (b, hq, hkv, sq, sk, d); the last two are at qwen2's
# heads, a prefill and a decode call split over the keys.  Each is checked in
# fp32 and in bf16.
FLASH_EDGES = [(2, 2, 2, 16, 16, 16), (1, 4, 2, 13, 29, 16),
               (2, 6, 1, 1, 37, 32), (1, 12, 2, 24, 24, 16),
               (2, 2, 1, 5, 70, 16), (2, 6, 2, 16, 32, 16),
               (2, 12, 2, 70, 150, 128), (2, 12, 2, 1, 1062, 128)]
# Windowed flash edge shapes, (b, hq, hkv, sq, sk, d): recurrentgemma's heads
# (10 of 256 over one KV head) in a prefill and a decode call, and smaller
# ones; each is called with windows of 1, 16 and 100 (fp32 and bf16).
FLASH_WINDOW_EDGES = [(2, 4, 1, 70, 90, 256), (1, 10, 1, 1, 300, 256),
                      (1, 10, 1, 4, 110, 256), (2, 6, 2, 33, 80, 64),
                      (1, 2, 2, 40, 40, 16)]
# LRU edge shapes of tests/test_torch_lru_scan.py and the model's width:
# (b, s, d).
LRU_EDGES = [(1, 1, 1), (2, 1, 64), (2, 37, 64), (1, 300, 100),
             (2, 37, 256), (3, 17, 2560)]
# SSD edge shapes of tests/test_torch_ssd_scan.py: (b, h, s, p, n).
# and mamba2's (N 128, P 64) at one kernel chunk (64 steps; 128 is built
# too) and one step past it.
SSD_EDGES = [(1, 1, 1, 16, 16), (2, 3, 37, 16, 16), (1, 2, 64, 32, 32),
             (2, 2, 50, 32, 32), (1, 2, 40, 64, 64), (1, 2, 45, 64, 128),
             (1, 2, 64, 64, 128), (1, 2, 65, 64, 128), (1, 2, 128, 64, 128),
             (1, 2, 129, 64, 128)]
# Both sides sum in fp32 and round once to bf16 (the kernel's P enters P·V as
# bf16 hi + lo, exact to about 2^-16 p): one bf16 ulp of |plain| (at most
# 2^-7 |plain|) apart, plus the fp32 sums' order near zero.
BF16_RTOL, BF16_ATOL = 2**-7, 2**-10
FP32_ATOL = 1e-5     # only the order of the float sums differs
SSD_TOL = 1e-4       # |kernel - plain| <= 1e-4 (1 + |plain|), fp32
LRU_TOL = 1e-5       # |kernel - plain| <= 1e-5 (1 + |plain|), fp32


def close(got, want, rtol, atol, what: str) -> float:
    """max |got - want| over float tensors; fails unless every element is
    within ``atol + rtol * |want|``."""
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{what}: shapes {got.shape} vs "
                                   f"{want.shape}")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    check(ok and math.isfinite(err), f"{what}: max |kernel - plain| = {err}")
    return err


def flash_inputs(gen, b, sq, sk, hq, hkv, d, dtype):
    dev = gen.device
    return (torch.randn((b, sq, hq, d), generator=gen, device=dev).to(dtype),
            torch.randn((b, sk, hkv, d), generator=gen, device=dev).to(dtype),
            torch.randn((b, sk, hkv, d), generator=gen, device=dev).to(dtype))


def ssd_inputs(gen, b, h, s, p, n):
    dev = gen.device
    x = torch.randn((b, h, s, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, h, s), generator=gen, device=dev))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=dev))
    B, C = (torch.randn((b, s, n), generator=gen, device=dev) / n ** 0.5
            for _ in range(2))
    return x, dt, A, B, C


def lru_inputs(gen, b, s, d):
    """The model's operands: gates in (0.5, 0.999), inputs of unit scale."""
    dev = gen.device
    return (0.5 + 0.499 * torch.rand((b, s, d), generator=gen, device=dev),
            torch.randn((b, s, d), generator=gen, device=dev))


def flash_edge_checks(gen, fa, dtype, rtol: float, atol: float) -> int:
    """Flash attention against its plain version at ``FLASH_EDGES`` and
    ``FLASH_WINDOW_EDGES`` in ``dtype`` (float32 takes the FMA kernel,
    bfloat16 the tensor-core kernel): causal and not, ``sk_valid`` 0, 1 and
    sk/2 + 1, decode calls at ``q_offset``, windows of 1, 16 and 100.
    Returns the number of calls checked."""
    n = 0
    for b, hq, hkv, sq, sk, d in FLASH_EDGES:
        q, k, v = flash_inputs(gen, b, sq, sk, hq, hkv, d, dtype)
        calls = [dict(causal=c) for c in (True, False)]
        calls += [dict(causal=c, sk_valid=kv) for c in (True, False)
                  for kv in (0, 1, sk // 2 + 1)]
        calls += [dict(causal=True, sk_valid=pos + 1, q_offset=pos)
                  for pos in (0, sk // 3, sk - 1) if sq == 1]
        for kw in calls:
            close(fa.attend(q, k, v, **kw), fa.attend_plain(q, k, v, **kw),
                  rtol, atol, f"flash {dtype} {b, hq, hkv, sq, sk, d} {kw}")
            n += 1
    for b, hq, hkv, sq, sk, d in FLASH_WINDOW_EDGES:
        q, k, v = flash_inputs(gen, b, sq, sk, hq, hkv, d, dtype)
        for w in (1, 16, 100):
            calls = [dict(causal=False, sk_valid=sk - 3, q_offset=sk - sq)]
            calls += ([dict(causal=True, sk_valid=pos + 1, q_offset=pos)
                       for pos in (sk // 3, sk - 1)] if sq == 1 else
                      [dict(causal=True), dict(causal=True, q_offset=sk - sq)])
            for kw in calls:
                kw["window"] = w
                close(fa.attend(q, k, v, **kw), fa.attend_plain(q, k, v, **kw),
                      rtol, atol,
                      f"flash {dtype} {b, hq, hkv, sq, sk, d} {kw}")
                n += 1
    return n


def lm_edge_checks(gen, fa, ss, ls) -> None:
    flash_edge_checks(gen, fa, torch.float32, 0, FP32_ATOL)
    for shape in SSD_EDGES:
        args = ssd_inputs(gen, *shape)
        y, s_fin = ss.ssd_scan_chunked(*args)
        y_p, s_p = ss.ssd_chunked_plain(*args, 128)
        close(y, y_p, SSD_TOL, SSD_TOL, f"ssd y {shape}")
        close(s_fin, s_p, SSD_TOL, SSD_TOL, f"ssd S_fin {shape}")
    # x, B and C as column slices of one projection whose rows are not
    # 16-byte aligned (the kernel's 4-byte copies), as the model slices them.
    b, h, s, p, n = 2, 3, 70, 64, 128
    x, dt, A, B, C = ssd_inputs(gen, b, h, s, p, n)
    proj = torch.zeros((b, s, h * p + 2 * n + 3), device=gen.device)
    proj[..., 1:1 + h * p] = x.transpose(1, 2).reshape(b, s, h * p)
    proj[..., 1 + h * p:1 + h * p + n] = B
    proj[..., 1 + h * p + n:1 + h * p + 2 * n] = C
    views = (proj[..., 1:1 + h * p].reshape(b, s, h, p).transpose(1, 2), dt,
             A, proj[..., 1 + h * p:1 + h * p + n],
             proj[..., 1 + h * p + n:1 + h * p + 2 * n])
    y, s_fin = ss.ssd_scan_chunked(*views)
    y_p, s_p = ss.ssd_chunked_plain(x, dt, A, B, C, 128)
    close(y, y_p, SSD_TOL, SSD_TOL, "ssd y, unaligned views")
    close(s_fin, s_p, SSD_TOL, SSD_TOL, "ssd S_fin, unaligned views")
    for b, s, d in LRU_EDGES:
        a, x = lru_inputs(gen, b, s, d)
        wide = torch.zeros((b, s, 2 * d), device=gen.device)   # strided a
        wide[..., d:] = a
        for args in ((a, x), (wide[..., d:], x)):
            h, h_fin = ls.lru_scan_chunked(*args)
            h_p, fin_p = ls.lru_chunked_plain(*args, 256)
            close(h, h_p, LRU_TOL, LRU_TOL, f"lru h {b, s, d}")
            close(h_fin, fin_p, LRU_TOL, LRU_TOL, f"lru h_fin {b, s, d}")


def glue_check(dev, seed: int) -> None:
    """The models' glue around the kernels on the card, in float32 with TF32
    off: smoke-width prefill logits and greedy tokens equal the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("glue: float32, torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    for arch in ("qwen2-1.5b", "mamba2-130m", "recurrentgemma-2b"):
        cfg = get_config(arch).smoke()
        params = init_params(cfg, torch.Generator().manual_seed(seed))
        gpu = Model(cfg, device=dev, params=params)
        cpu = Model(cfg, device="cpu", params=params)
        prompts = torch.randint(0, cfg.vocab, (4, 40),
                                generator=torch.Generator().manual_seed(seed))
        lg, _ = gpu.prefill({"tokens": prompts.to(dev)},
                            gpu.init_cache(4, 64))
        lc, _ = cpu.prefill({"tokens": prompts}, cpu.init_cache(4, 64))
        err = close(lg.cpu(), lc, 1e-4, 1e-4, f"glue {cfg.name} prefill")
        tg = ServeEngine(gpu, max_seq=64).generate(prompts, steps=16)
        tc = ServeEngine(cpu, max_seq=64).generate(prompts, steps=16)
        check(torch.equal(tg.cpu(), tc), f"glue {cfg.name}: greedy tokens "
                                         "on the card == CPU")
        print(f"glue {cfg.name}: prefill logits max |gpu - cpu| = {err:.3g}, "
              "16 greedy tokens x 4 equal")


def serve_full(dev, arch: str, kernels: tuple, mods: dict, args,
               prompt_len: int = PROMPT_LEN) -> dict:
    """Serve ``arch`` at full width (bf16, weights from the seed): a short
    warm-up, then the main run with every kernel's count (``mods``) set to 0
    just before it; each of ``mods[kernels]`` must have launched.  Checks
    the tokens and, on two prompts, the prefill logits with the kernels
    against the same model with their plain versions."""
    import repro_torch.models.blocks as blocks
    import repro_torch.models.layers as layers
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import attend_plain
    from repro_torch.kernels.lru_scan import lru_chunked_plain
    from repro_torch.kernels.ssd_scan import ssd_chunked_plain
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine

    cfg = get_config(arch)
    b, s, g = REQUESTS, prompt_len, GEN_LEN
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev, seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    eng = ServeEngine(model, max_seq=s + g + 8)
    prompts = torch.randint(0, cfg.vocab, (b, s),
                            generator=torch.Generator().manual_seed(args.seed))
    eng.generate(prompts[:2, :64], steps=2)                      # warm-up
    torch.cuda.synchronize()
    for mod in mods.values():
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    out = eng.generate(prompts, steps=g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: mod.LAUNCHES for name, mod in mods.items()}
    launches = {name: counts[name] for name in kernels}
    peak = torch.cuda.max_memory_allocated()
    check(all(n > 0 for n in launches.values()),
          f"{arch}: {', '.join(kernels)} launched on the serve path "
          f"({counts})")
    check(out.shape == (b, g) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab, f"{arch}: {g} tokens per request")
    t = eng.timing

    # The same prefill with the kernels and with their plain versions.
    two = prompts[:2].to(dev)
    lk, _ = model.prefill({"tokens": two}, model.init_cache(2, s))
    saved = layers.attend, blocks.ssd_scan_chunked, blocks.lru_scan_chunked
    layers.attend = attend_plain
    blocks.ssd_scan_chunked = (lambda *a, chunk: ssd_chunked_plain(*a, chunk))
    blocks.lru_scan_chunked = (lambda *a, chunk: lru_chunked_plain(*a, chunk))
    try:
        lp, _ = model.prefill({"tokens": two}, model.init_cache(2, s))
    finally:
        (layers.attend, blocks.ssd_scan_chunked,
         blocks.lru_scan_chunked) = saved
    check(bool(torch.isfinite(lk).all()) and lk.shape == (2, 1, cfg.vocab),
          f"{arch}: finite prefill logits")
    cos = torch.nn.functional.cosine_similarity(lk[:, 0], lp[:, 0], dim=-1)
    same_top = int((lk[:, 0].argmax(-1) == lp[:, 0].argmax(-1)).sum())
    check(bool((cos >= 0.99).all()), f"{arch}: prefill logits with the "
                                     f"kernels vs plain, cosine {cos.tolist()}")
    res = dict(arch=arch, params=n_params, launches=launches,
               prefill_ms=t["prefill_ms"],
               decode_ms=statistics.median(t["decode_ms"]),
               tok_s=b * g / ((t["prefill_ms"] + sum(t["decode_ms"])) / 1e3),
               wall_s=wall, peak_gib=peak / 2**30)
    print(f"serve {arch} ({n_params / 1e9:.3f} B params, bf16) requests={b} "
          f"prompt={s} generated={g}: prefill {res['prefill_ms']:.3f} ms, "
          f"decode {res['decode_ms']:.3f} ms/step (median of {g}), "
          f"{res['tok_s']:.1f} generated tok/s, {wall:.3f} s host clock, "
          f"peak {res['peak_gib']:.2f} GiB, launches {counts}; prefill "
          f"logits vs plain: cosine {min(cos.tolist()):.6f}, "
          f"{same_top}/2 same top token")

    # The device's own time for the prefill and one decode step, against
    # the times above, which the host paces: the rest is the device idle.
    cache = model.init_cache(b, s + g + 8)
    pre_dev = stack_device_ms(model, model._embed(prompts.to(dev)), cache, 0)
    dec_dev = stack_device_ms(model, model._embed(out[:, :1].to(dev)), cache,
                              s)
    for name, dev_ms, paced in (("prefill", pre_dev, res["prefill_ms"]),
                                ("decode step", dec_dev, res["decode_ms"])):
        busy = ("not measured (the host did not finish queueing first)"
                if dev_ms is None else
                f"{dev_ms[0]:.3f} ms on the device, busy "
                f"{dev_ms[0] / paced:.1%} of the {paced:.3f} ms the host "
                "paced; by layer kind " + ", ".join(
                    f"{k} {t:.3f} ms" for k, t in dev_ms[1].items()))
        print(f"serve {arch} {name}: {busy}")
    del model, eng
    torch.cuda.empty_cache()
    return res


def device_ms(fn, reps: int = 1):
    """Milliseconds the device spends on one ``fn()``'s work alone: ``reps``
    calls are queued behind a sleep kernel (about 35 ms) that outlasts the
    host's queueing, so the events around them see no host gap.  ``None``
    when the host had not finished queueing before the sleep ended (a full
    launch queue, or a slow host)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1 << 26)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued_first = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / reps if queued_first else None


def stack_device_ms(model, x, cache, pos: int):
    """Device milliseconds of one pass of ``x`` through ``model``'s layers
    and its unembedding, timed layer by layer with :func:`device_ms` (a
    whole step's ~1,700 launches overflow the launch queue): ``(total,
    {kind: ms})`` summed by layer kind (a hybrid model's rec and windowed
    attn layers are one flat list, as are their caches), or ``None``."""
    from repro_torch.models.model import layer_kinds
    times = [("unembed", device_ms(lambda: model._unembed(x[:, -1:])))]
    for kind, lp, c in zip(layer_kinds(model.cfg), model.layers,
                           cache["layers"]):
        times.append((kind, device_ms(lambda: model._layer(lp, x, c, pos))))
    if any(t is None for _, t in times):
        return None
    by_kind = {}
    for kind, t in times:
        by_kind[kind] = by_kind.get(kind, 0.0) + t
    return sum(by_kind.values()), by_kind


def sdpa_fn(q, k, v, causal: bool):
    """One scaled_dot_product_attention call on [B, H, S, d] copies of the
    same inputs (the yardstick; the port never calls it)."""
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, is_causal=causal, enable_gqa=True)


def sdpa_window_fn(q, k, v, window: int):
    """One scaled_dot_product_attention call over [B, H, S, d] copies of the
    same inputs, the KV head expanded to the query heads, with the causal
    window as a boolean mask (the yardstick; the port never calls it)."""
    hq, hkv = q.shape[2], k.shape[2]
    qh = q.transpose(1, 2).contiguous()
    kh, vh = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
              .contiguous() for t in (k, v))
    i = torch.arange(q.shape[1], device=q.device)[:, None]
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = (j <= i) & (j > i - window)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask)


def flash_decode_row(fa, row, q1, k, v, dec, live, reps):
    """Add a decode call's error, times, bound and library time to ``row``:
    ``q1`` at ``dec["q_offset"]`` over the cache, whose ``live`` keys end at
    ``sk_valid``.  A decode call is short enough for the host to pace
    back-to-back calls, so it is timed on the device alone (kernel and
    library alike); the back-to-back time is kept beside it."""
    b, _, hq, d = q1.shape
    hkv, end = k.shape[2], dec["sk_valid"]
    row["decode_max_abs_err"] = close(
        fa.attend(q1, k, v, **dec), fa.attend_plain(q1, k, v, **dec),
        BF16_RTOL, BF16_ATOL, "flash decode")
    row["decode_ms"] = device_ms(lambda: fa.attend(q1, k, v, **dec), 20)
    row["decode_paced_ms"] = cuda_ms(lambda: fa.attend(q1, k, v, **dec),
                                     reps * 20)
    row["decode_plain_ms"] = cuda_ms(lambda: fa.attend_plain(q1, k, v, **dec),
                                     reps)
    row["decode_bound_ms"], row["decode_bound_by"] = bound(
        2 * (2 * q1.numel() + 2 * b * live * hkv * d),
        4 * b * hq * d * live, BF16_FLOPS_PER_S)
    row["decode_library_ms"] = device_ms(
        sdpa_fn(q1, k[:, end - live:end], v[:, end - live:end], False), 20)


def lm_kernel_rows(gen, fa, ss, ls, launches, args) -> list:
    """Each float kernel at the serve path's shapes: held against its plain
    version and timed beside it, its bound and its library call."""
    from repro_torch.configs import get_config
    reps = args.reps
    b, s, g = REQUESTS, PROMPT_LEN, GEN_LEN
    cache = s + g + 8
    qwen, mamba = get_config("qwen2-1.5b"), get_config("mamba2-130m")
    hq, hkv, d = qwen.n_heads, qwen.n_kv_heads, qwen.head_dim
    # Prefill: q over the whole cache, causal, sk_valid = s.
    q, k, v = flash_inputs(gen, b, s, cache, hq, hkv, d, torch.bfloat16)
    pre = dict(causal=True, sk_valid=s)
    err = close(fa.attend(q, k, v, **pre), fa.attend_plain(q, k, v, **pre),
                BF16_RTOL, BF16_ATOL, "flash prefill")
    pairs = s * (s + 1) // 2
    b_ms, b_by = bound(2 * (2 * q.numel() + 2 * b * s * hkv * d),
                       4 * b * hq * d * pairs, BF16_FLOPS_PER_S)
    kv = k[:, :s], v[:, :s]
    row = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:78",
        launches=launches["flash"], max_abs_err=err,
        ms=cuda_ms(lambda: fa.attend(q, k, v, **pre), reps),
        plain_ms=cuda_ms(lambda: fa.attend_plain(q, k, v, **pre), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(sdpa_fn(q, *kv, True), reps),
        shape=f"prefill q [{b}, {s}, {hq}, {d}] bf16 over a [{b}, {cache}, "
              f"{hkv}, {d}] cache, causal, sk_valid {s}")
    # Decode: one query row at pos, sk_valid = pos + 1 (not a tile multiple).
    pos = s + g // 2 + 5
    q1 = q[:, :1].contiguous()
    flash_decode_row(fa, row, q1, k, v, dict(causal=True, sk_valid=pos + 1,
                                             q_offset=pos), pos + 1, reps)
    row["decode_shape"] = (f"q [{b}, 1, {hq}, {d}] bf16 at pos {pos} over the "
                           f"[{b}, {cache}, {hkv}, {d}] cache, sk_valid "
                           f"{pos + 1}")
    rows = [row]
    del q, k, v, q1, kv

    h, p, n = mamba.ssm_heads, mamba.ssm_headdim, mamba.ssm_state
    for length in (s, s - 24):                           # and a ragged one
        args_ = ssd_inputs(gen, b, h, length, p, n)
        y, s_fin = ss.ssd_scan_chunked(*args_)
        y_p, s_p = ss.ssd_chunked_plain(*args_, 128)
        err = max(close(y, y_p, SSD_TOL, SSD_TOL, f"ssd y S={length}"),
                  close(s_fin, s_p, SSD_TOL, SSD_TOL, f"ssd S_fin S={length}"))
        if length == s:
            main, main_err = args_, err
    x, dt, A, B, C = main
    nbytes = 4 * (2 * x.numel() + dt.numel() + A.numel() + B.numel()
                  + C.numel() + b * h * n * p)
    # The recurrence's 4 N P operations a step and head, in fp32 accuracy on
    # the tensor cores: 3xTF32 does them at a third of TF32's rate.
    b_ms, b_by = bound(nbytes, 4 * n * p * b * h * s, TF32X3_FLOPS_PER_S)
    rows.append(dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:78",
        launches=launches["ssd"], max_abs_err=main_err,
        ms=cuda_ms(lambda: ss.ssd_scan_chunked(*main), reps),
        plain_ms=cuda_ms(lambda: ss.ssd_chunked_plain(*main, 128), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"x [{b}, {h}, {s}, {p}], B/C [{b}, {s}, {n}] fp32, "
              f"S_fin [{b}, {h}, {n}, {p}]"))
    del main, args_, x, dt, A, B, C

    # recurrentgemma: the windowed prefill over its cache and a decode call
    # past the window.
    rg = get_config("recurrentgemma-2b")
    s, w = HYBRID_PROMPT_LEN, rg.local_window
    cache = s + g + 8
    hq, hkv, d = rg.n_heads, rg.n_kv_heads, rg.head_dim
    q, k, v = flash_inputs(gen, b, s, cache, hq, hkv, d, torch.bfloat16)
    pre = dict(causal=True, sk_valid=s, window=w)
    err = close(fa.attend(q, k, v, **pre), fa.attend_plain(q, k, v, **pre),
                BF16_RTOL, BF16_ATOL, "flash windowed prefill")
    seen = sum(min(p + 1, w) for p in range(s))     # keys the queries see
    b_ms, b_by = bound(2 * (2 * q.numel() + 2 * b * s * hkv * d),
                       4 * b * hq * d * seen, BF16_FLOPS_PER_S)
    row = dict(
        name="flash_attention_window_d256", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:78",
        launches=launches["flash_window"], max_abs_err=err,
        ms=cuda_ms(lambda: fa.attend(q, k, v, **pre), reps),
        plain_ms=cuda_ms(lambda: fa.attend_plain(q, k, v, **pre), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(sdpa_window_fn(q, k[:, :s], v[:, :s], w), reps),
        shape=f"prefill q [{b}, {s}, {hq}, {d}] bf16 over a [{b}, {cache}, "
              f"{hkv}, {d}] cache, causal, window {w}, sk_valid {s}")
    pos = s + g // 2 + 5
    q1 = q[:, :1].contiguous()
    flash_decode_row(fa, row, q1, k, v, dict(causal=True, sk_valid=pos + 1,
                                             q_offset=pos, window=w),
                     min(pos + 1, w), reps)
    row["decode_shape"] = (f"q [{b}, 1, {hq}, {d}] bf16 at pos {pos} over the "
                           f"[{b}, {cache}, {hkv}, {d}] cache, window {w}, "
                           f"sk_valid {pos + 1}")
    rows.append(row)
    del q, k, v, q1

    width = rg.lru_width
    for length in (s - 24, s):             # a ragged length, then the prompt's
        a, x = lru_inputs(gen, b, length, width)
        h, h_fin = ls.lru_scan_chunked(a, x)
        h_p, fin_p = ls.lru_chunked_plain(a, x, 256)
        err = max(close(h, h_p, LRU_TOL, LRU_TOL, f"lru h S={length}"),
                  close(h_fin, fin_p, LRU_TOL, LRU_TOL,
                        f"lru h_fin S={length}"))
        del h, h_fin, h_p, fin_p
    b_ms, b_by = bound(4 * (3 * a.numel() + b * width), 2 * a.numel(),
                       FP32_FLOPS_PER_S)
    rows.append(dict(
        name="lru_scan", route="cuda", source="src/repro_torch/csrc/lru_scan.cu",
        replaces="src/repro/kernels/lru_scan/lru_scan.py:57",
        launches=launches["lru"], max_abs_err=err,
        ms=cuda_ms(lambda: ls.lru_scan_chunked(a, x), reps),
        plain_ms=cuda_ms(lambda: ls.lru_chunked_plain(a, x, 256), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"a, b [{b}, {s}, {width}] fp32, h_fin [{b}, {width}]"))
    return rows


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def run_lm(dev: torch.device, args) -> list:
    """The serving phases after PSRS; returns their ``kernels`` rows."""
    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}.{m}")
            for m in ("bitonic_sort", "kway_merge", "alltoallv_deliver",
                      "flash_attention", "ssd_scan", "lru_scan")}
    fa, ss, ls = mods["flash_attention"], mods["ssd_scan"], mods["lru_scan"]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    lm_edge_checks(gen, fa, ss, ls)
    print(f"flash/ssd/lru edge checks: passed in "
          f"{time.perf_counter() - t0:.2f} s")
    # The same flash calls in bf16, on the tensor-core kernel.
    t0 = time.perf_counter()
    n = flash_edge_checks(gen, fa, torch.bfloat16, BF16_RTOL, BF16_ATOL)
    print(f"flash bf16 edge checks: {n} calls within 2^-10 + 2^-7 |plain|, "
          f"passed in {time.perf_counter() - t0:.2f} s")
    glue_check(dev, args.seed)
    qwen = serve_full(dev, "qwen2-1.5b", ("flash_attention",), mods, args)
    mamba = serve_full(dev, "mamba2-130m", ("ssd_scan",), mods, args)
    rg = serve_full(dev, "recurrentgemma-2b", ("lru_scan", "flash_attention"),
                    mods, args, prompt_len=HYBRID_PROMPT_LEN)
    launches = {"flash": qwen["launches"]["flash_attention"],
                "ssd": mamba["launches"]["ssd_scan"],
                "flash_window": rg["launches"]["flash_attention"],
                "lru": rg["launches"]["lru_scan"]}
    rows = lm_kernel_rows(gen, fa, ss, ls, launches, args)
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernel {r['name']} {r['shape']}: {r['ms']:.4f} ms, launches "
              f"{r['launches']}, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib} ms, "
              f"max |kernel - plain| {r['max_abs_err']:.3g}")
        if "decode_ms" in r:
            print(f"kernel {r['name']} decode {r['decode_shape']}: "
                  f"{fmt_ms(r['decode_ms'])} on the device ("
                  f"{r['decode_paced_ms']:.4f} ms a call back to back), plain "
                  f"{r['decode_plain_ms']:.4f} ms, bound "
                  f"{r['decode_bound_ms']:.4f} ms ({r['decode_bound_by']}), "
                  f"library {fmt_ms(r['decode_library_ms'])} on the device, "
                  f"max |kernel - plain| {r['decode_max_abs_err']:.3g}")
    return [{key: r[key] for key in r if not key.endswith("shape")}
            for r in rows]


if __name__ == "__main__":
    sys.exit(main())
