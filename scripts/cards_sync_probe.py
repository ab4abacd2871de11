#!/usr/bin/env python3
"""Where the host waits for a card inside PSRS's stages.

Over a mesh of cards one host thread queues every card's rounds; a stage
whose code waits for the device (a value read back to the host) keeps the
next card's rounds from being queued until the current card's finish, so
the cards take turns instead of computing at once.  This script runs the
PSRS plan stage by stage under ``torch.profiler`` (host activity, with
Python stacks) and prints, for each stage, the host calls that wait for a
card or read a value back (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, ``cudaMemcpy`` to the
host, ``aten::item``, ``aten::_local_scalar_dense``, ``aten::nonzero``),
with their counts and the Python lines they come from; and before that,
each stage's time to be queued by the host beside its time until every
card is drained.

Run from the root of a checkout on a machine with an H100:

    python3 scripts/cards_sync_probe.py            # 2^24 keys, P 4, k 2
    python3 scripts/cards_sync_probe.py --log-n 27

With four cards visible the plan runs over ``Mesh(["cuda:0", ...,
"cuda:3"])``, else over four blocks of one card (the mesh-of-cards route
forced, as ``chip_smoke.py``'s phase 5d has it).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "aten::item",
         "aten::_local_scalar_dense", "aten::nonzero")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n", type=int, default=24)
    ap.add_argument("--v", type=int, default=16)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--alpha", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cards_sync_probe: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Mesh
    from repro_torch.pems_apps import psrs_plan

    P = 4
    if torch.cuda.device_count() >= P:
        mesh = Mesh([f"cuda:{i}" for i in range(P)])
    else:
        class OneCardAsCards(Mesh):
            spans_devices = True
        mesh = OneCardAsCards([torch.device("cuda", 0)] * P)
    n, v = 1 << args.log_n, args.v
    g = torch.Generator(device="cuda").manual_seed(0)
    keys = torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                         device="cuda", dtype=torch.int64).to(torch.int32)
    print(f"{mesh}, n=2^{args.log_n}, v={v}, k={args.k}, "
          f"alpha={args.alpha}; {torch.cuda.get_device_name(0)}")
    for turn in ("warm-up", "timed", "profiled"):
        pems, load, steps, _ = psrs_plan(v, n // v, k=args.k, P=P,
                                         mesh=mesh, alpha=args.alpha)
        store = load(keys.reshape(v, -1))
        for name, step in steps:
            pems.synchronize()
            if turn == "warm-up":
                store = step(store)
                continue
            if turn == "timed":
                # The host's time to queue the stage beside the stage's time
                # to the last card drained: where they are close, the host
                # paces the cards.
                t0 = time.perf_counter()
                store = step(store)
                t1 = time.perf_counter()
                pems.synchronize()
                t2 = time.perf_counter()
                print(f"stage {name}: queued in {(t1 - t0) * 1e3:.3f} ms, "
                      f"done in {(t2 - t0) * 1e3:.3f} ms (host clock)")
                continue
            with profile(activities=[ProfilerActivity.CPU],
                         with_stack=True) as prof:
                store = step(store)
                pems.synchronize()
            found = {}
            for e in prof.key_averages(group_by_stack_n=6):
                if any(e.key.startswith(s) for s in SYNCS):
                    where = [f for f in e.stack if "repro_torch" in f]
                    found.setdefault(e.key, []).append(
                        (e.count, where[:3]))
            # The stage's own synchronize() at its end is one wait a card.
            print(f"stage {name}:")
            for key, rows in sorted(found.items()):
                total = sum(c for c, _ in rows)
                print(f"  {key}: {total}")
                for c, where in rows:
                    if where:
                        print(f"    {c} from " + " <- ".join(where))
        del store, pems
    return 0


if __name__ == "__main__":
    sys.exit(main())
