#!/usr/bin/env python3
"""The bf16 flash kernel's decode split: how many key tiles a block takes.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 scripts/flash_decode_splits.py

A decode call (one query row over the cache) has too few (batch, KV head)
pairs to fill the card, so the wrapper cuts the live keys into ranges of
``per`` 64-key tiles, one block each, and a second launch merges the
ranges' partial results (``_plan`` in
``src/repro_torch/kernels/flash_attention/flash_attention.py``).  For
qwen2-1.5b's decode (q [8, 1, 12, 128] at position 1061 over a
[8, 1096, 2, 128] cache) and recurrentgemma-2b's (q [8, 1, 10, 256] at
position 3109 over a [8, 3144, 1, 256] cache, window 2048), this prints, for
each ``per``, the call's time on the device alone (20 calls queued behind a
sleep kernel) and the profiler's time of each of its two kernels, and marks
the plan's own choice.
"""

from __future__ import annotations

import importlib
import re
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
CASES = {
    "qwen2-1.5b": ((8, 1096, 12, 2, 128),
                   dict(causal=True, sk_valid=1062, q_offset=1061)),
    "recurrentgemma-2b": ((8, 3144, 10, 1, 256),
                          dict(causal=True, sk_valid=3110, q_offset=3109,
                               window=2048)),
}


def device_ms(fn, reps: int = 20):
    """Milliseconds of one ``fn()`` on the device alone: ``reps`` calls
    queued behind a sleep kernel; ``None`` if the host was slower."""
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


def kernel_us(fn) -> str:
    """The profiler's device microseconds per call of each kernel."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    out = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0)
        name = re.search(r"\w+_kernel<[^>]*>", ev.key)
        if t and name:
            out.append(f"{name.group(0)} {t / ev.count:.2f} us")
    return ", ".join(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_decode_splits: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    plan = fa._plan
    for arch, ((b, sk, hq, hkv, d), kw) in CASES.items():
        q = torch.randn((b, 1, hq, d), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((b, sk, hkv, d), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        bq, bk, splits, split_len = plan(
            fa._sms(dev), torch.bfloat16, b, hq // hkv, hkv, d, sk=sk,
            sk_valid=kw["sk_valid"], q_offset=kw["q_offset"],
            window=kw.get("window", 0))
        base = fa._key_base(kw["q_offset"], kw.get("window", 0), bk)
        tiles = -(-(kw["sk_valid"] - base) // bk)
        chosen = split_len // bk if splits > 1 else tiles
        print(f"{arch}: {tiles} key tiles of {bk} over {b * hkv} (batch, KV "
              f"head) blocks; the plan takes {chosen} a split ({splits} "
              f"splits)")
        fn = lambda: fa.attend(q, k, v, **kw)
        try:
            for per in sorted({1, 2, 3, 4, 6, 9, chosen, tiles}):
                n = -(-tiles // per)
                fa._plan = (lambda *a, per=per, n=n, **k2:
                            (bq, bk, n, per * bk) if n > 1 else (bq, bk, 1, 0))
                t = device_ms(fn)
                print(f"  {per} tiles a split ({n} splits, {n * b * hkv} "
                      f"blocks){' (the plan)' if per == chosen else ''}: "
                      f"{'not measured' if t is None else f'{t:.4f} ms'} on "
                      f"the device; {kernel_us(fn)}")
        finally:
            fa._plan = plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
