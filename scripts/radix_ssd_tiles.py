#!/usr/bin/env python3
"""Registers and tile sizes of the radix sort (kernel 1) and the SSD scan
(kernel 6).

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 scripts/radix_ssd_tiles.py

Compiles ``src/repro_torch/csrc/radix_sort.cu`` and ``ssd_scan.cu`` as the
port builds them and prints what ``ptxas -v`` reports (registers, shared
memory, spill stores and loads) for every kernel they instantiate.  Then, in
one process and in turns (the built setting first, the others, then back):

* the radix sort of the PSRS local sort's input, ``[4, 2^23]`` int32 rows
  one context (``2^23 + 1024`` words) apart, in tiles of 256 threads x 32
  keys (built), 256 x 16 and 512 x 8 (the wrapper's
  ``RADIX_KEYS_PER_THREAD`` and ``RADIX_THREADS``), each held equal to
  ``torch.sort``, beside one ``torch.sort`` of the same rows;
* the SSD scan at mamba2-130m's prefill (x ``[8, 24, 1024, 64]``, B and C
  ``[8, 1024, 128]``) with chunks of 64 (built) and 128 steps
  (``KERNEL_CHUNK``), each within 1e-4 (1 + |plain|) of the plain version.

Last, each kernel's device time by launch (``torch.profiler``), one call of
each at the built setting.

The objects go to ``build/radix_ssd_tiles`` in the checkout.
"""

from __future__ import annotations

import importlib
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
KERNELS = ("row_histograms", "upsweep", "scan_tiles", "downsweep",
           "ssd_gram", "ssd_states", "ssd_pass", "ssd_output")


def ptxas_lines(build, source: str, obj: Path,
                kernels: tuple = KERNELS) -> list:
    """``ptxas -v``'s resource lines for each kernel of ``source`` whose
    name is one of ``kernels``, with its template arguments."""
    out = subprocess.run([build._nvcc(), *build.FLAGS, "-Xptxas", "-v", "-c",
                          str(build.CSRC / source), "-o", str(obj)],
                         capture_output=True, text=True, check=True)
    lines, name = [], None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(" + "|".join(kernels) + r")(I(?:Li\d+E)+E)?",
                          m.group(1))
            name = None if k is None else k.group(1) + (
                "<" + ", ".join(re.findall(r"Li(\d+)E", k.group(2))) + ">"
                if k.group(2) else "")
            continue
        if name and ("registers" in line or "spill" in line):
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return lines


def cuda_ms(fn, reps: int = 10) -> float:
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


def breakdown(fn, reps: int = 5) -> list:
    """``(kernel, device ms a call)`` of every kernel ``fn`` launches, from a
    ``torch.profiler`` trace of ``reps`` calls, largest first."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            rows.append((e.key, us / 1e3 / reps))
    return sorted(rows, key=lambda r: -r[1])


def print_breakdown(what: str, rows: list) -> None:
    print(f"{what}, device ms a call by kernel (torch.profiler):")
    for name, ms in rows:
        short = re.search(r"(" + "|".join(KERNELS) + r")(<[^(]*>)?", name)
        print(f"  {ms:.4f}  {short.group(0) if short else name[:90]}")


def in_turns(values, apply, fn, check) -> dict:
    """Time ``fn`` under each of ``values`` (the built one first), set by
    ``apply(value)``, in turns (first to last, then last to first), checking
    each output; ends on the built value."""
    ms = {v: [] for v in values}
    try:
        for v in list(values) + list(values)[::-1]:
            apply(v)
            check(fn(), f"{v}")
            ms[v].append(cuda_ms(fn))
    finally:
        apply(values[0])
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("radix_ssd_tiles: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build as build
    bs, ss = (importlib.import_module(f"repro_torch.kernels.{m}.{m}")
              for m in ("bitonic_sort", "ssd_scan"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    work = ROOT / "build" / "radix_ssd_tiles"
    work.mkdir(parents=True, exist_ok=True)
    print("ptxas -v:")
    for source in ("radix_sort.cu", "ssd_scan.cu"):
        for line in ptxas_lines(build, source, work / f"{source}.o"):
            print("  " + line)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True

    def check(good, what):
        nonlocal ok
        ok &= bool(good)
        if not good:
            print(f"FAILED: {what}")

    rows, n = 4, 1 << 23
    store = torch.randint(-2**31, 2**31, (rows, n + 1024), generator=gen,
                          device=dev, dtype=torch.int64).to(torch.int32)
    x = store[:, :n]
    want = torch.sort(x, dim=-1).values
    def tile(shape):
        bs.RADIX_KEYS_PER_THREAD, bs.RADIX_THREADS = shape

    built = (bs.RADIX_KEYS_PER_THREAD, bs.RADIX_THREADS)
    ms = in_turns([built] + [t for t in ((16, 256), (8, 512)) if t != built],
                  tile, lambda: bs.bitonic_sort_rows(x),
                  lambda got, what: check(torch.equal(got, want),
                                          f"radix {what}"))
    lib = cuda_ms(lambda: torch.sort(x, dim=-1))
    for (kpt, threads), ts in ms.items():
        print(f"radix [{rows}, {n}] int32, row stride {x.stride(0)}, {threads} "
              f"threads x {kpt} keys ({threads * kpt}-key tiles): "
              f"{', '.join(f'{t:.4f}' for t in ts)} ms"
              f"{' (built)' if (kpt, threads) == built else ''}")
    print(f"torch.sort of the same rows: {lib:.4f} ms")
    print_breakdown("radix", breakdown(lambda: bs.bitonic_sort_rows(x)))
    del store, x, want

    b, h, s, p, nn = 8, 24, 1024, 64, 128
    xs = torch.randn((b, h, s, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, h, s), generator=gen, device=dev))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=dev))
    B, C = (torch.randn((b, s, nn), generator=gen, device=dev) / nn ** 0.5
            for _ in range(2))
    y_p, s_p = ss.ssd_chunked_plain(xs, dt, A, B, C, 128)

    def ssd_ok(got, what):
        for name, t, w in (("y", got[0], y_p), ("S_fin", got[1], s_p)):
            err = (t - w).abs()
            check(bool((err <= 1e-4 * (1 + w.abs())).all()),
                  f"ssd {what} {name}: max |kernel - plain| "
                  f"{float(err.max()):.3g}")

    def chunk(q):
        ss.KERNEL_CHUNK = q

    q0 = ss.KERNEL_CHUNK
    ms = in_turns([q0] + [q for q in (64, 128) if q != q0], chunk,
                  lambda: ss.ssd_scan_chunked(xs, dt, A, B, C), ssd_ok)
    for q, ts in ms.items():
        print(f"ssd x [{b}, {h}, {s}, {p}], N {nn}, chunks of {q}: "
              f"{', '.join(f'{t:.4f}' for t in ts)} ms"
              f"{' (built)' if q == q0 else ''}")
    print_breakdown("ssd", breakdown(
        lambda: ss.ssd_scan_chunked(xs, dt, A, B, C)))
    print(f"every output checked: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
