#!/usr/bin/env python3
"""What the kernels' PyTorch ops cost a call on the card: each wrapper's
path through its op (``torch.ops.repro_torch.*``) against the direct launch
it wraps (the path before the ops), at the shapes of ``chip_smoke.py``'s
kernel rows 5, 5w, 5p, 5bp, 6 and 7, timed in turns (direct, op, op,
direct) as ``chip_smoke.py`` times a row (CUDA events around ``reps``
back-to-back calls after a warm-up call), and each call's host time alone
(the mean over many calls, the card synchronised once at the end).

Run from the root of a checkout on a machine with a CUDA card:

    python3 scripts/op_overhead.py [--reps 5] [--turns 4]
"""

from __future__ import annotations

import argparse
import importlib
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


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


def host_us(fn, calls: int = 200) -> float:
    """Mean host µs a call over ``calls`` calls queued back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def cases(dev):
    fa, ss, ls = (importlib.import_module(f"repro_torch.kernels.{m}.{m}")
                  for m in ("flash_attention", "ssd_scan", "lru_scan"))
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    out = {}
    for name, (b, s, cache, hq, hkv, d, window, prefix) in {
            "5": (8, 1024, 1096, 12, 2, 128, 0, 0),
            "5w": (8, 3072, 3144, 10, 1, 256, 2048, 0),
            "5p": (8, 1024, 1096, 8, 1, 256, 0, 256)}.items():
        q = randn(b, s, hq, d, dtype=torch.bfloat16)
        k, v = (randn(b, cache, hkv, d, dtype=torch.bfloat16)
                for _ in range(2))
        pre = dict(causal=True, sk_valid=s, window=window, prefix=prefix)
        kw = fa._options(q, k, v, scale=None, q_offset=0, **pre)
        out[name] = (
            lambda q=q, k=k, v=v, kw=kw: fa._launch(q, k, v, **kw,
                                                    with_lse=False)[0],
            lambda q=q, k=k, v=v, pre=pre: fa.attend(q, k, v, **pre))
    q = randn(4, 48, 4, 16)
    k, v = randn(4, 48, 1, 16), randn(4, 48, 1, 16)
    kw = fa._options(q, k, v, causal=True, sk_valid=None, q_offset=0,
                     scale=None, window=0, prefix=8)
    o, lse = fa.attend_with_lse(q, k, v, **kw)
    do = randn(4, 48, 4, 16)
    out["5bp"] = (lambda: fa._launch_bwd(q, k, v, o, do, lse, **kw),
                  lambda: fa.attend_backward(q, k, v, o, do, lse, **kw))
    x = randn(8, 24, 1024, 64)
    dt = torch.nn.functional.softplus(randn(8, 24, 1024))
    A = -torch.exp(randn(24))
    Bm, Cm = randn(8, 1024, 128), randn(8, 1024, 128)
    out["6"] = (lambda: ss._launch(x, dt, A, Bm, Cm),
                lambda: ss._forward(x, dt, A, Bm, Cm, 128))
    a = 0.5 + 0.49 * torch.rand((8, 3072, 2560), generator=g, device=dev)
    bb = randn(8, 3072, 2560)
    out["7"] = (lambda: ls._launch(a, bb), lambda: ls._forward(a, bb, 256))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5,
                    help="calls a timing, as chip_smoke.py's --reps")
    ap.add_argument("--turns", type=int, default=4,
                    help="(direct, op, op, direct) rounds a row")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("op_overhead: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")
    for name, (direct, op) in cases(torch.device("cuda")).items():
        ms = {"direct": [], "op": []}
        for _ in range(args.turns):
            for which in ("direct", "op", "op", "direct"):
                fn = direct if which == "direct" else op
                ms[which].append(cuda_ms(fn, args.reps))
        med = {w: statistics.median(v) for w, v in ms.items()}
        host = {w: host_us(fn) for w, fn in (("direct", direct),
                                             ("op", op))}
        print(f"row {name}: ms a call (median of {2 * args.turns}, "
              f"{args.reps} back to back) direct {med['direct']:.4f} "
              f"[{min(ms['direct']):.4f}-{max(ms['direct']):.4f}], op "
              f"{med['op']:.4f} [{min(ms['op']):.4f}-{max(ms['op']):.4f}]; "
              f"op/direct {med['op'] / med['direct']:.4f}; host µs a call "
              f"direct {host['direct']:.1f}, op {host['op']:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
