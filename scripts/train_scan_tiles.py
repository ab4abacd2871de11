#!/usr/bin/env python3
"""Registers, design alternatives and device time by pass of the scans on
the training path: kernels 6b (the SSD scan's backward), 7 (the RG-LRU
scan) and 7b (its backward).

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 scripts/train_scan_tiles.py

Compiles ``src/repro_torch/csrc/ssd_scan_bwd.cu``, ``lru_scan.cu`` and
``lru_scan_bwd.cu`` as the port builds them and prints what ``ptxas -v``
reports (registers, spill stores and loads) for every kernel they
instantiate.  Then, at the shapes of a training step's calls and of the
serving prefill, each setting timed in turns (the built one first, the
others, then back) and held against the plain version:

* kernel 6b at mamba2-130m's microbatch (x, dy ``[16, 24, 2048, 64]``, B
  and C ``[16, 2048, 128]``): built (the chunk pass on 8 warps, 4 row
  blocks x 2 column slices; the state pass in two 4-warp blocks of 64 state
  rows a (batch, head)), the chunk pass on 16 warps (4 x 4) and the state
  pass in one 8-warp block a (batch, head); within 1e-4 of the plain
  version's scale;
* kernel 7 at recurrentgemma-2b's training microbatch ``[2, 3072, 2560]``
  (row 7t), at batch 4 and at its serving prefill ``[8, 3072, 2560]`` (row
  7): the chunked scan against the one-pass kernel (the wrapper's
  ``ONE_PASS_CHANNELS`` set to take one or the other), then the chunked
  scan at chunks of 16, 32 (built) and 64 steps, within 1e-5 (1 + |plain|).

A setting other than the built one is a copy of ``csrc`` with one constant
changed (``kWC`` and ``kRB`` of ``ssd_scan_bwd.cu``, ``kChunk`` of
``lru_scan.cu``), built into its own library under ``build/train_scan_tiles``
and loaded beside the built one.  Two more copies take parts out of 6b's
chunk pass, its products or its head loop's copies, and are timed only (their
output is not the function's): what is left is what the parts cost.  The
rate of ``mma.sync`` m16n8k8 TF32, which every product of kernels 6 and 6b
runs on, is measured on its own with every SM full of independent products.
Last, each kernel's device ms a call by launch (``torch.profiler``) at the
built setting, kernel 7b's too.
``chip_smoke.py`` holds the built kernels against their plain versions at
these shapes and times the whole calls (rows ``ssd_scan_bwd``, ``lru_scan``,
``lru_scan_train`` and ``lru_scan_bwd``).
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
sys.path.insert(0, str(ROOT / "scripts"))
from radix_ssd_tiles import (breakdown, cuda_ms, in_turns,  # noqa: E402
                             ptxas_lines)

KERNELS = ("ssd_bwd_states", "ssd_bwd_chunk", "ssd_bwd_dA", "lru_kernel",
           "lru_local", "lru_carry", "lru_fix", "lru_bwd_local",
           "lru_bwd_carry", "lru_bwd_fix")
WORK = ROOT / "build" / "train_scan_tiles"
# The built lines that the settings tried change, and their replacements.
WC_LINE = "static constexpr int kWC = P / 32 < 1 ? 1 : P / 32;"
WC_ALT = "static constexpr int kWC = P / 16 < 4 ? P / 16 : 4;"
RB_LINE = "static constexpr int kRB = N < 64 ? N : 64;  "
RB_ALT = "static constexpr int kRB = N;  "
NO_PRODUCTS = ("    if (s < s_lo || s >= s_hi) continue;", "    continue;")
NO_COPIES = (("      if (m + 2 < pieces) load_piece(m + 2);", ""),
             ("        if (h + 1 < heads) load_xy(h + 1);", ""))
# One mma.sync m16n8k8 TF32 stream: 8 independent accumulators a warp.
MMA_RATE_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_rate(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.f + 1e-3f * threadIdx.x + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + i);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate_launch(void* out, int blocks, int iters, void* stream) {
  mma_rate<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def mma_rate(build) -> None:
    """The card's rate of mma.sync m16n8k8 TF32 (the products of kernels 6
    and 6b) with every SM full of independent products."""
    import ctypes
    src = WORK / "mma_rate.cu"
    src.write_text(MMA_RATE_CU)
    so = WORK / "mma_rate.so"
    subprocess.run([build._nvcc(), *build.FLAGS, "-shared", "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.mma_rate_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 4 * sms, 4096
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        if lib.mma_rate_launch(out.data_ptr(), blocks, iters, stream):
            raise RuntimeError("mma_rate launch failed")

    ms = cuda_ms(run)
    n = blocks * 8 * iters * 8  # warps x iterations x products
    print(f"mma.sync m16n8k8 TF32, {blocks} blocks of 8 warps, 8 independent "
          f"products a warp: {ms:.4f} ms, {n / ms / 1e3 / sms:.1f} products "
          f"an SM a microsecond, {2048 * n / ms / 1e9:.1f} TFLOP/s "
          f"(dense TF32 peak 494.7)")
CHUNK_LINE = "constexpr int kChunk = {};  "


def passes(what: str, fn) -> None:
    print(f"{what}: device ms a call by kernel (torch.profiler):")
    for name, ms in breakdown(fn):
        short = re.search(r"(" + "|".join(KERNELS) + r")(<[^(]*>)?", name)
        print(f"    {ms:.4f}  {short.group(0) if short else name[:90]}")


def variant(build, name: str, source: str, *edits):
    """The kernel library built from a copy of ``csrc`` whose ``source`` has
    each ``(old, new)`` of ``edits`` replaced; the built library stays loaded
    as it was."""
    csrc = WORK / name / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(build.CSRC, csrc)
    text = (csrc / source).read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{source} has no line {old!r}")
        text = text.replace(old, new)
    (csrc / source).write_text(text)
    saved = build.CSRC, build.BUILD_DIR, build._lib
    try:
        build.CSRC, build.BUILD_DIR, build._lib = csrc, WORK / name, None
        for line in ptxas_lines(build, source, WORK / name / "probe.o",
                                KERNELS):
            if "64, 128, 64" in line or "lru_" in line:
                print(f"  {name}: {line}")
        return build.library()
    finally:
        build.CSRC, build.BUILD_DIR, build._lib = saved


def turns_line(what: str, ms: dict, built) -> None:
    for v, ts in ms.items():
        print(f"  {what} {v}: {', '.join(f'{t:.4f}' for t in ts)} ms"
              f"{' (built)' if v == built else ''}")


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
    WORK.mkdir(parents=True, exist_ok=True)
    print("ptxas -v:")
    for source in ("ssd_scan_bwd.cu", "lru_scan.cu", "lru_scan_bwd.cu"):
        for line in ptxas_lines(build, source, WORK / f"{source}.o", KERNELS):
            print("  " + line)
    built_lib = build.library()
    mma_rate(build)
    libs = {"built": built_lib,
            "chunk pass on 16 warps": variant(
                build, "wc4", "ssd_scan_bwd.cu", (WC_LINE, WC_ALT)),
            "state pass in one block a (batch, head)": variant(
                build, "rb128", "ssd_scan_bwd.cu", (RB_LINE, RB_ALT))}
    # What the chunk pass's time is made of: the same pass without its
    # products, or without the copies of its head loop (timed only: their
    # output is not the function's).
    knocked = {"chunk pass without its products": variant(
                   build, "noprod", "ssd_scan_bwd.cu", NO_PRODUCTS),
               "chunk pass without its head loop's copies": variant(
                   build, "nocopy", "ssd_scan_bwd.cu", *NO_COPIES)}
    built_chunk = ls.CHUNK
    chunk_libs = {built_chunk: built_lib}
    for q in (16, 64):
        chunk_libs[q] = variant(build, f"chunk{q}", "lru_scan.cu",
                                (CHUNK_LINE.format(built_chunk),
                                 CHUNK_LINE.format(q)))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True

    def check(good, what):
        nonlocal ok
        ok &= bool(good)
        if not good:
            print(f"FAILED: {what}")

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
    want = ss.ssd_backward_plain(*ops, dy, chunk=ss.KERNEL_CHUNK)

    def ssd_ok(got, what):
        for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
            scale = max(1.0, float(w.abs().max()))
            err = float((g - w).abs().max())
            check(bool(((g - w).abs() <= 1e-4 * w.abs()
                        + 1e-4 * scale).all()),
                  f"6b {what} {name}: max |kernel - plain| {err:.3g}")

    def use(lib):
        build._lib = lib

    print(f"6b x, dy [{b}, {h}, {s}, {p}], N {n}, chunk pass layouts:")
    turns_line("6b", in_turns(list(libs), lambda k: use(libs[k]),
                              lambda: ss.ssd_scan_backward(*ops, dy,
                                                           states=states),
                              ssd_ok), "built")
    turns_line("6b", in_turns(["built", *knocked],
                              lambda k: use(libs[k] if k == "built"
                                            else knocked[k]),
                              lambda: ss.ssd_scan_backward(*ops, dy,
                                                           states=states),
                              lambda got, what: None), "built")
    use(built_lib)
    passes(f"6b x, dy [{b}, {h}, {s}, {p}], N {n}",
           lambda: ss.ssd_scan_backward(*ops, dy, states=states))
    del x, dy, dt, A, B, C, ops, states, want

    d = 2560
    one_pass = ls.ONE_PASS_CHANNELS
    for bb in (2, 4, 8):
        a = 0.5 + 0.499 * torch.rand((bb, 3072, d), generator=gen, device=dev)
        xb = torch.randn((bb, 3072, d), generator=gen, device=dev)
        h_p, fin_p = ls.lru_chunked_plain(a, xb, 256)

        def lru_ok(got, what):
            for name, g, w in (("h", got[0], h_p), ("h_fin", got[1], fin_p)):
                err = (g - w).abs()
                check(bool((err <= 1e-5 * (1 + w.abs())).all()),
                      f"7 {what} {name}: max |kernel - plain| "
                      f"{float(err.max()):.3g}")

        def path(v):
            ls.ONE_PASS_CHANNELS = {"chunked": 1 << 62, "one-pass": 0}[v]

        print(f"7 a, b [{bb}, 3072, {d}] ({bb * d} channels; bound "
              f"{12 * a.numel() / 3.35e9:.4f} ms by bytes, the chunked "
              f"scan's 20 bytes an element {20 * a.numel() / 3.35e9:.4f}):")
        built_path = "one-pass" if bb * d >= one_pass else "chunked"
        turns_line("7", in_turns([built_path] + [v for v in ("chunked",
                                                             "one-pass")
                                                 if v != built_path],
                                 path, lambda: ls.lru_scan_chunked(a, xb),
                                 lru_ok), built_path)

        def chunk(q):
            use(chunk_libs[q])
            ls.CHUNK = q

        path("chunked")
        turns_line("7 chunked, chunk", in_turns(list(chunk_libs), chunk,
                                                lambda: ls.lru_scan_chunked(
                                                    a, xb), lru_ok),
                   built_chunk)
        ls.ONE_PASS_CHANNELS = one_pass
        passes(f"7 a, b [{bb}, 3072, {d}] ({built_path})",
               lambda: ls.lru_scan_chunked(a, xb))
        if bb == 2:
            hs, _ = ls.lru_scan_chunked(a, xb)
            dh = torch.randn((bb, 3072, d), generator=gen, device=dev)
            passes(f"7b a, h, dh [{bb}, 3072, {d}]",
                   lambda: ls.lru_scan_backward(a, hs, dh))
            del hs, dh
        del a, xb, h_p, fin_p
    print(f"kernel 7 takes the one-pass kernel from {one_pass} channels")
    print("all checks passed" if ok else "SOME CHECKS FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
