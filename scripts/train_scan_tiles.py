#!/usr/bin/env python3
"""Registers and device time by pass of the training path's scan backwards
(kernels 6b and 7b).

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 scripts/train_scan_tiles.py

Compiles ``src/repro_torch/csrc/ssd_scan_bwd.cu`` and ``lru_scan_bwd.cu``
as the port builds them and prints what ``ptxas -v`` reports (registers,
spill stores and loads) for every kernel they instantiate.  Then each
backward's device ms a call by launch (``torch.profiler``), at the shapes of
a training step's calls:

* kernel 6b at mamba2-130m's microbatch (x, dy ``[16, 24, 2048, 64]``, B
  and C ``[16, 2048, 128]``);
* kernel 7b at recurrentgemma-2b's (a, h, dh ``[2, 3072, 2560]``).

Kernel 5b, recurrentgemma-2b's local attention among its shapes, is
``scripts/flash_bwd_tiles.py``'s.  ``chip_smoke.py`` holds each of them
against its plain version at these shapes and times the whole call (rows
``ssd_scan_bwd`` and ``lru_scan_bwd``).  The objects go to
``build/train_scan_tiles`` in the checkout.
"""

from __future__ import annotations

import importlib
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
from radix_ssd_tiles import breakdown, ptxas_lines  # noqa: E402

KERNELS = ("ssd_bwd_states", "ssd_bwd_chunk", "ssd_bwd_dA", "lru_bwd_local",
           "lru_bwd_carry", "lru_bwd_fix")


def passes(what: str, fn) -> None:
    print(f"{what}: device ms a call by kernel (torch.profiler):")
    for name, ms in breakdown(fn):
        short = re.search(r"(" + "|".join(KERNELS) + r")(<[^(]*>)?", name)
        print(f"    {ms:.4f}  {short.group(0) if short else name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("train_scan_tiles: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build as build
    ss, ls = (importlib.import_module(f"repro_torch.kernels.{m}.{m}")
              for m in ("ssd_scan", "lru_scan"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    work = ROOT / "build" / "train_scan_tiles"
    work.mkdir(parents=True, exist_ok=True)
    print("ptxas -v:")
    for source in ("ssd_scan_bwd.cu", "lru_scan_bwd.cu"):
        for line in ptxas_lines(build, source, work / f"{source}.o", KERNELS):
            print("  " + line)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    b, h, s, p, n = 16, 24, 2048, 64, 128
    x, dy = (torch.randn((b, h, s, p), generator=gen, device=dev)
             for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn((b, h, s), generator=gen,
                                                  device=dev))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=dev))
    B, C = (torch.randn((b, s, n), generator=gen, device=dev) / n ** 0.5
            for _ in range(2))
    ops = (x, dt, A, B, C)
    _, _, states = ss._forward(*ops, 128)
    passes(f"6b x, dy [{b}, {h}, {s}, {p}], N {n}",
           lambda: ss.ssd_scan_backward(*ops, dy, states=states))
    del x, dy, dt, A, B, C, ops, states

    b, s, d = 2, 3072, 2560
    a = 0.5 + 0.499 * torch.rand((b, s, d), generator=gen, device=dev)
    xb, dh = (torch.randn((b, s, d), generator=gen, device=dev)
              for _ in range(2))
    hs, _ = ls.lru_scan_chunked(a, xb)
    passes(f"7b a, h, dh [{b}, {s}, {d}]",
           lambda: ls.lru_scan_backward(a, hs, dh))
    return 0


if __name__ == "__main__":
    sys.exit(main())
