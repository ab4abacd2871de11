#!/usr/bin/env python3
"""The flash kernel's prefill tile at head dim 256: 32 query rows or 64.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 scripts/flash_d256_tiles.py

Compiles ``src/repro_torch/csrc/flash_attention.cu`` as the port builds it
(32-row prefill tiles, RT 2, at head dim 256) and a copy whose head-dim-256
prefill tile has 64 rows (RT 4, the tile of the smaller head dims), prints
what ``ptxas -v`` reports for each head-dim-256 kernel (registers, spill
stores and loads), then times both at recurrentgemma-2b's windowed prefill
(q [8, 3072, 10, 256] bf16 over a [8, 3144, 1, 256] cache, causal, window
2048) in one process, in turns (32, 64, 64, 32), and checks that they give
the same output.  Builds go to ``build/`` in the checkout.
"""

from __future__ import annotations

import importlib
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
BUILT = "RT == (D == 256 ? 2 : 4)"   # the tile choice in flash_attention.cu


def rows64_sources(dst: Path, build) -> Path:
    """A copy of the kernel sources whose head-dim-256 prefill tile has 64
    rows."""
    dst.mkdir(parents=True, exist_ok=True)
    for name in build.SOURCES:
        shutil.copy(build.CSRC / name, dst / name)
    src = (dst / "flash_attention.cu").read_text()
    if BUILT not in src:
        raise RuntimeError(f"{BUILT!r} is no longer in flash_attention.cu: "
                           "update this script to the kernel's tile choice")
    (dst / "flash_attention.cu").write_text(src.replace(BUILT, "RT == 4"))
    return dst


def ptxas_lines(build, source: Path, obj: Path) -> list:
    """``ptxas -v``'s registers and spills for each head-dim-256 kernel."""
    out = subprocess.run([build._nvcc(), *build.FLAGS, "-Xptxas", "-v", "-c",
                          str(source), "-o", str(obj)], capture_output=True,
                         text=True, check=True)
    lines, name = [], None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"flash_kernelI(13__nv_bfloat16|f)Li256ELi(\d)E", name or "")
        if m and ("registers" in line or "spill" in line):
            dtype = "bf16" if m.group(1) != "f" else "fp32"
            lines.append(f"{dtype} {16 * int(m.group(2))}-row tile: "
                         f"{line.split(':', 1)[-1].strip()}")
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
    csrc64 = rows64_sources(work / "csrc64", build)
    for tag, src in (("built", build.CSRC), ("64-row copy", csrc64)):
        print(f"ptxas -v, {tag}:")
        for line in ptxas_lines(build, src / "flash_attention.cu",
                                work / f"{tag.split()[0]}.o"):
            print("  " + line)

    libs = {32: build.library()}
    build.CSRC, build._lib = csrc64, None
    libs[64] = build.library()
    plan = fa._plan

    def use(rows: int) -> None:
        build._lib = libs[rows]
        fa._plan = lambda *a: (
            (rows, *plan(*a)[1:]) if plan(*a)[0] == 32 else plan(*a))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s, cache, hq, hkv, d, w = 8, 3072, 3144, 10, 1, 256, 2048
    q = torch.randn((b, s, hq, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, cache, hkv, d), generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    kw = dict(causal=True, sk_valid=s, window=w)
    outs, ms = {}, {32: [], 64: []}
    for rows in (32, 64, 64, 32):
        use(rows)
        outs[rows] = fa.attend(q, k, v, **kw)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            fa.attend(q, k, v, **kw)
        end.record()
        end.synchronize()
        ms[rows].append(start.elapsed_time(end) / 5)
    same = torch.equal(outs[32], outs[64])
    for rows in (32, 64):
        print(f"{rows}-row tiles: {', '.join(f'{t:.3f}' for t in ms[rows])} "
              f"ms a call (5 calls each turn)")
    print(f"outputs equal: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
