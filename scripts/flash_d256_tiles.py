#!/usr/bin/env python3
"""The bf16 flash kernel's key tile at head dim 256: 32 keys or 64.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 scripts/flash_d256_tiles.py

Compiles ``src/repro_torch/csrc/flash_attention.cu`` as the port builds it
and prints what ``ptxas -v`` reports (registers, spill stores and loads) for
every instantiation: the tensor-core kernel ``flash_mma_kernel<D, BK,
decode>`` (bf16) and the FMA kernel ``flash_kernel<float, D, RT>``.  Then
times recurrentgemma-2b's windowed prefill (q [8, 3072, 10, 256] bf16 over a
[8, 3144, 1, 256] cache, causal, window 2048) with 32-key and 64-key tiles
(the kernel is built for both; the wrapper's ``D256_PREFILL_BK`` picks one)
in one process, in turns (32, 64, 64, 32), and holds each tile's output to
the plain version within 2^-10 + 2^-7 |plain|.  The object goes to
``build/`` in the checkout.
"""

from __future__ import annotations

import importlib
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def ptxas_lines(build, obj: Path) -> list:
    """``ptxas -v``'s registers and spills for each flash kernel."""
    out = subprocess.run([build._nvcc(), *build.FLAGS, "-Xptxas", "-v", "-c",
                          str(build.CSRC / "flash_attention.cu"), "-o",
                          str(obj)], capture_output=True, text=True,
                         check=True)
    lines, name = [], None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        if not name or ("registers" not in line and "spill" not in line):
            continue
        mma = re.search(r"flash_mma_kernelILi(\d+)ELi(\d+)ELb([01])E", name)
        fma = re.search(r"flash_kernelIfLi(\d+)ELi(\d)E", name)
        if mma:
            what = (f"bf16 D {mma.group(1)}, BK {mma.group(2)}, "
                    f"{'decode' if mma.group(3) == '1' else 'prefill'}")
        elif fma:
            what = f"fp32 D {fma.group(1)}, {16 * int(fma.group(2))} rows"
        else:
            continue
        lines.append(f"{what}: {line.split(':', 1)[-1].strip()}")
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_d256_tiles: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build as build
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    work = ROOT / "build" / "d256_tiles"
    work.mkdir(parents=True, exist_ok=True)
    print("ptxas -v:")
    for line in ptxas_lines(build, work / "flash_attention.o"):
        print("  " + line)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s, cache, hq, hkv, d, w = 8, 3072, 3144, 10, 1, 256, 2048
    q = torch.randn((b, s, hq, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, cache, hkv, d), generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    kw = dict(causal=True, sk_valid=s, window=w)
    want = fa.attend_plain(q, k, v, **kw).float()
    built = fa.D256_PREFILL_BK
    ms, ok = {32: [], 64: []}, True
    try:
        for bk in (32, 64, 64, 32):
            fa.D256_PREFILL_BK = bk
            got = fa.attend(q, k, v, **kw).float()
            err = (got - want).abs()
            ok &= bool((err <= 2**-10 + 2**-7 * want.abs()).all())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                fa.attend(q, k, v, **kw)
            end.record()
            end.synchronize()
            ms[bk].append(start.elapsed_time(end) / 5)
    finally:
        fa.D256_PREFILL_BK = built
    for bk in (32, 64):
        print(f"{bk}-key tiles: {', '.join(f'{t:.4f}' for t in ms[bk])} ms a "
              f"call (5 calls each turn){' (built)' if bk == built else ''}")
    print(f"both within 2^-10 + 2^-7 |plain|: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
