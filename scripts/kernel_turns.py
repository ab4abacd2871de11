#!/usr/bin/env python3
"""Kernel rows of ``chip_smoke.py`` on two source trees in turns: what a
change to the kernels' sources costs the rows it means to leave alone.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit, with another tree unpacked beside it (``git archive``):

    python3 scripts/kernel_turns.py --other OTHER/src [--turns 2] [--reps 5]

The rows, at ``chip_smoke.py``'s shapes, each timed as it times a row (the
mean ms of ``--reps`` calls between CUDA events after a warm-up call) on
inputs made from one seed:

- kernel 5 in bf16: rows 5 (qwen2's prefill), 5w (recurrentgemma's
  windowed prefill at head dim 256), 5k (kimi-k2's, GQA 8) and 5p
  (paligemma's prefix-LM mask at head dim 256), and row 5h's fp16 call
  where the tree takes fp16;
- kernel 5b in bf16: rows 5b (hubert-xlarge's training call) and 5bq
  (qwen2's);
- kernels 2 and 4 on int32 words: row 2r's shape (``deliver_words``, v 16,
  ω 2^21, the counts transposed, no fill) and row 4's bytes
  (``assemble_words``, four senders × ``[s 2, P 4, d 1, ω 2^23]`` with a
  fill, about a sixteenth valid, into the buffer).

Each tree's ``repro_torch`` runs in a process of its own: first both
builds, side by side, then the trees in the order other, this, this, other
(``--turns`` such pairs).  It prints each row's times by tree and the ratio
of their medians (this / other).
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
INT_MAX = 2**31 - 1


def cuda_ms(fn, reps: int) -> float:
    """As ``chip_smoke.cuda_ms``: mean ms of ``reps`` calls after one."""
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


def rows(reps: int) -> dict:
    """Every row's ms on this process's tree."""
    fa, dv = (importlib.import_module(f"repro_torch.kernels.{m}.{m}")
              for m in ("flash_attention", "alltoallv_deliver"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    fwd = {"5": (8, 1024, 12, 2, 128, {}), "5w": (8, 3072, 10, 1, 256,
                                                  {"window": 2048}),
           "5k": (8, 1024, 64, 8, 128, {}),
           "5p": (8, 1024, 8, 1, 256, {"prefix": 256})}
    dtypes = [torch.bfloat16] + (
        [torch.float16] if torch.float16 in fa._DTYPES else [])
    for name, (b, s, hq, hkv, d, kw) in fwd.items():
        for dtype in dtypes if name == "5" else dtypes[:1]:
            q = randn(b, s, hq, d, dtype=dtype)
            k, v = (randn(b, s + 72, hkv, d, dtype=dtype) for _ in range(2))
            call = dict(causal=True, sk_valid=s, **kw)
            tag = name if dtype == torch.bfloat16 else "5h"
            out[tag] = cuda_ms(lambda: fa.attend(q, k, v, **call), reps)
            del q, k, v
    for name, (b, s, hq, hkv, d, causal) in {
            "5b": (8, 1024, 16, 16, 80, False),
            "5bq": (8, 1024, 12, 2, 128, True)}.items():
        q, do = randn(b, s, hq, d), randn(b, s, hq, d)
        k, v = randn(b, s, hkv, d), randn(b, s, hkv, d)
        o, lse = fa.attend_with_lse(q, k, v, causal=causal)
        out[name] = cuda_ms(lambda: fa.attend_backward(
            q, k, v, o, do, lse, causal=causal), reps)
        del q, k, v, o, do, lse
    v, ww = 16, 1 << 21
    src = torch.randint(-INT_MAX, INT_MAX, (v, v * ww), generator=g,
                        device=dev, dtype=torch.int32)
    dst = torch.empty_like(src)
    cnt = torch.randint(0, ww, (v, v), generator=g, device=dev,
                        dtype=torch.int32)
    ct = torch.empty_like(cnt)
    out["2r"] = cuda_ms(lambda: dv.deliver_words(
        src, 0, dst, 0, v, ww, None, 0, None, cnt, 0, ct, 0), reps)
    del src, dst
    m, P, s, ww = 4, 4, 2, 1 << 23
    src = torch.randint(-INT_MAX, INT_MAX, (m * P, P * m * ww), generator=g,
                        device=dev, dtype=torch.int32)
    cnt = torch.randint(ww // 16 - 4096, ww // 16 + 4096, (m * P, P * m),
                        generator=g, device=dev, dtype=torch.int32)
    buf = torch.empty(P * P * s * ww, dtype=torch.int32, device=dev)
    ct = torch.empty(P * P * s, dtype=torch.int32, device=dev)
    out["4"] = cuda_ms(lambda: dv.assemble_words(
        src, 0, m, P, P, 0, s, 0, 1, ww, buf, cnt, 0, INT_MAX, cnt, 0, ct),
        reps)
    return out


def child(src: str, reps: int, build_only: bool) -> int:
    sys.path.insert(0, src)
    from repro_torch.kernels import _build
    _build.library()
    if not build_only:
        print(json.dumps(rows(reps)))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="the other tree's src directory")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.reps, args.build_only)
    if not torch.cuda.is_available():
        print("kernel_turns: CUDA is not available", file=sys.stderr)
        return 1
    trees = {"other": str(Path(args.other).resolve()),
             "this": str(ROOT / "src")}

    def cmd(src, *extra):
        return [sys.executable, __file__, "--other", args.other, "--child",
                src, "--reps", str(args.reps), *extra]

    builds = [subprocess.Popen(cmd(src, "--build-only"))
              for src in trees.values()]
    if any(p.wait() for p in builds):
        return 1
    times = {tree: [] for tree in trees}
    for _ in range(args.turns):
        for tree in ("other", "this", "this", "other"):
            res = subprocess.run(cmd(trees[tree]), capture_output=True,
                                 text=True, check=True)
            times[tree].append(json.loads(res.stdout.strip().splitlines()[-1]))
    print(torch.cuda.get_device_name(0))
    for row in times["this"][0]:
        mine = [t[row] for t in times["this"]]
        theirs = [t[row] for t in times["other"] if row in t]
        ratio = (f"{statistics.median(mine) / statistics.median(theirs):.4f}"
                 if theirs else "n/a")
        print(f"row {row}: other {[round(x, 4) for x in theirs]} ms, this "
              f"{[round(x, 4) for x in mine]} ms, this / other {ratio}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
