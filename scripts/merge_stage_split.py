#!/usr/bin/env python3
"""Where one round of the PSRS merge stage spends its time on the card.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 scripts/merge_stage_split.py [--log-n 27] [--v 16] [--k 4]

Runs ``psrs_plan`` (explicit driver) on ``2^log_n`` random int32 keys up to
its ``alltoallv`` stage, so that the store holds the received buckets
``brecv [v, v, cap]`` and their counts ``brcnt`` as the merge stage finds
them, and then takes round 0 (the first ``k`` contexts) apart:

* the gather route (``kway_merge``'s ``use_kernel=False`` pipeline with the
  tile sort on the card, the route the port took before the fused merge):
  the count mask, the exact-splitter search at every tile boundary, the
  compact gather's index tensors and gather, the tile sort
  (``merge_tile_grid``) and the copy of the first ``rcap`` keys into the
  round's ``result`` field, each phase timed alone between CUDA events;
* the fused route (the port's default since the fused merge): the exact
  splitters at the segment boundaries, the segment merge and the result
  copy, each timed alone, and again at each ``--seg-tiles`` segment size;
* the whole merge stage (all rounds, ``Pems.superstep``) between CUDA
  events, and the device time of one round by kernel (``torch.profiler``).

Every output is held equal to the merge's plain oracle
(``kway_merge_ref``).
"""

from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
INT_MAX = 2**31 - 1
TILE = 256


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls after one
    warm-up call, between CUDA events."""
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


def check(got, want, what: str) -> None:
    if not torch.equal(got, want):
        raise RuntimeError(f"{what}: the merged keys differ from "
                           "kway_merge_ref's")


def by_kernel(fn, top: int = 12) -> list:
    """``(kernel, device ms)`` of one ``fn()`` from a ``torch.profiler``
    trace, largest first."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1])[:top]


def merge_inputs(dev, log_n: int, v: int, k: int, seed: int):
    """A full-scale store as the merge stage finds it: ``(pems, store,
    merge step, rcap)``."""
    from repro_torch.pems_apps import psrs_plan
    n = 1 << log_n
    n_v = n // v
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randint(-2**31, 2**31, (n,), generator=g, device=dev,
                         dtype=torch.int64).to(torch.int32)
    pems, load, steps, _ = psrs_plan(v, n_v, k=k, driver="explicit",
                                     device=dev)
    store = load(keys.reshape(v, n_v))
    for name, fn in steps:
        if name == "merge":
            return pems, store, fn, 2 * n_v
        store = fn(store)
    raise ValueError("psrs_plan has no merge stage")


def gather_route_split(recv, cnt, rcap: int, result) -> dict:
    """The gather route's phases on one round, each timed alone: ``{phase:
    ms}``.  ``result`` is the round's ``[k, rcap]`` result field."""
    from repro_torch.kernels.kway_merge import kway_merge_ref
    km = importlib.import_module("repro_torch.kernels.kway_merge.kway_merge")
    k, v, cap = recv.shape
    G = -(-rcap // TILE)
    ranks = torch.clamp(torch.arange(G + 1, device=recv.device) * TILE,
                        max=v * cap)
    st = {}

    def mask():
        st["masked"] = km.mask_buckets(recv, cnt)

    def search():
        st["starts"] = km.split_search(st["masked"], ranks)

    def gather():
        st["tiles"] = km.compact_gather(st["masked"], st["starts"], TILE)

    def tile_sort():
        st["merged"] = km.merge_tile_grid(st["tiles"])

    def copy():
        result.copy_(st["merged"].reshape(k, -1)[:, :rcap])

    phases = [("mask", mask), ("splitter search", search),
              ("gather index tensors + gather", gather),
              ("tile sort (merge_tile_grid)", tile_sort),
              ("result copy", copy)]
    ms = {name: cuda_ms(fn) for name, fn in phases}
    check(result, kway_merge_ref(recv, cnt, rcap=rcap, fill=INT_MAX),
          "gather route")
    return ms


def fused_route_split(recv, cnt, rcap: int, result, seg_tiles=None) -> dict:
    """The fused route's launches on one round, each timed alone: ``{phase:
    ms}`` (``seg_tiles`` defaults to the wrapper's choice)."""
    from repro_torch.kernels.kway_merge import kway_merge_ref
    km = importlib.import_module("repro_torch.kernels.kway_merge.kway_merge")
    k, v, cap = recv.shape
    S = seg_tiles or km.segment_tiles(v, TILE)
    ranks = km.coarse_ranks(rcap, TILE, S, v * cap, recv.device)
    st = {}

    def splitters():
        st["starts"] = km.exact_splitters(recv, cnt, ranks)

    def segments():
        st["merged"] = km.merge_segments(recv, cnt, st["starts"], rcap=rcap,
                                         tile=TILE, seg_tiles=S)

    def copy():
        result.copy_(st["merged"])

    phases = [(f"exact splitters ({ranks.numel()} ranks)", splitters),
              (f"merge segments (S {S})", segments), ("result copy", copy)]
    ms = {name: cuda_ms(fn) for name, fn in phases}
    check(result, kway_merge_ref(recv, cnt, rcap=rcap, fill=INT_MAX),
          "fused route")
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n", type=int, default=27)
    ap.add_argument("--v", type=int, default=16)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seg-tiles", type=int, nargs="*", default=[],
                    help="segment sizes (tiles) to time the fused route at")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("merge_stage_split: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    pems, store, merge, rcap = merge_inputs(dev, args.log_n, args.v, args.k,
                                            args.seed)
    k = args.k
    recv = store.field("brecv")[:k]
    cnt = store.field("brcnt")[:k]
    result = store.field("result")[:k]
    print(f"round 0: brecv {tuple(recv.shape)} int32, strides "
          f"{recv.stride()}, {int(cnt.sum())} valid keys, rcap {rcap}")
    for route, fn in (("gather", gather_route_split),
                      ("fused", fused_route_split)):
        split = fn(recv, cnt, rcap, result)
        for name, ms in split.items():
            print(f"{route} route, {name}: {ms:.3f} ms")
        print(f"{route} route, sum of phases: {sum(split.values()):.3f} ms "
              "a round")
    for S in args.seg_tiles:
        split = fused_route_split(recv, cnt, rcap, result, S)
        print(f"fused route at S {S}: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in split.items()))
    stage = cuda_ms(lambda: merge(store), 2)
    print(f"merge stage ({args.v // k} rounds, explicit driver): "
          f"{stage:.3f} ms")

    from repro_torch.kernels.kway_merge import kway_merge

    def one_round():
        m, _, _ = kway_merge(recv, cnt, rcap=rcap, fill=INT_MAX)
        result.copy_(m)

    print("one round of the port's kway_merge + result copy, device ms by "
          "kernel (torch.profiler; ms, launches):")
    for name, ms, n in by_kernel(one_round):
        print(f"  {ms:9.3f} {n:5d}  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
