#!/usr/bin/env python3
"""Kernel 5b (the attention backward) on the card: what ``ptxas`` makes of
it, whether it agrees with its plain version, and its time at the training
shapes.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 scripts/flash_bwd_tiles.py

Compiles ``src/repro_torch/csrc/flash_attention_bwd.cu`` as the port builds
it and prints what ``ptxas -v`` reports (registers, spill stores and loads)
for every kernel: the tensor-core passes ``dkdv_mma_kernel<D>`` and
``dq_mma_kernel<D>`` (bf16), the FMA passes ``dkdv_kernel`` and
``dq_kernel`` (fp32, and bf16 at head dim 256) and ``row_dot_kernel``.
Then, at hubert-xlarge's and qwen2-1.5b's training shapes, holds the bf16
backward to ``attend_backward_plain`` within ``chip_smoke.py``'s
``BWD_BF16_TOL``, times it in turns beside the plain version,
``scaled_dot_product_attention``'s forward plus backward and its backward
alone (the library calls; the port never makes them), and splits the
kernel's device time by pass (``torch.profiler``).  The edge cases are
``chip_smoke.py --train-only``'s.  The object goes to ``build/`` in the
checkout.  Exit 1 if a check fails.
"""

from __future__ import annotations

import importlib
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
# (name, b, s, hq, hkv, d, causal): the training calls of hubert-xlarge and
# qwen2-1.5b (chip_smoke.py rows 5b and 5bq).
SHAPES = [("hubert-xlarge", 8, 1024, 16, 16, 80, False),
          ("qwen2-1.5b", 8, 1024, 12, 2, 128, True)]
BWD_BF16_TOL = (2**-7, 1e-4)


def ptxas_lines(build, obj: Path) -> list:
    """``ptxas -v``'s registers and spills for each kernel of the source."""
    out = subprocess.run([build._nvcc(), *build.FLAGS, "-Xptxas", "-v", "-c",
                          str(build.CSRC / "flash_attention_bwd.cu"), "-o",
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
        mma = re.search(r"(dkdv|dq)_mma_kernelILi(\d+)E", name)
        fma = re.search(r"(dkdv|dq)_kernelI(f|13__nv_bfloat16)Li(\d+)E", name)
        if mma:
            what = f"{mma.group(1)}_mma_kernel bf16 D {mma.group(2)}"
        elif fma:
            kind = "fp32" if fma.group(2) == "f" else "bf16"
            what = f"{fma.group(1)}_kernel {kind} D {fma.group(3)}"
        elif "row_dot" in name:
            what = "row_dot_kernel " + ("fp32" if "IfE" in name else "bf16")
        else:
            continue
        lines.append(f"{what}: {line.split(':', 1)[-1].strip()}")
    return lines


def close(got, want) -> float:
    """max |got - want| / max(1, max |want|); raises past ``BWD_BF16_TOL``."""
    rtol, atol = BWD_BF16_TOL
    want = want.float()
    diff = (got.float() - want).abs()
    scale = max(1.0, float(want.abs().max()))
    if not bool((diff <= rtol * want.abs() + atol * scale).all()):
        raise AssertionError(f"max |kernel - plain| {float(diff.max())} "
                             f"(scale {scale})")
    return float(diff.max()) / scale


def cuda_ms(fn, reps: int) -> float:
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


def by_pass(fn, calls: int) -> dict:
    """Device ms a call of each kernel ``fn`` launches, over ``calls``
    calls under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        m = re.search(r"(\w+_kernel)", e.key)
        if us and m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + us / 1e3 / calls
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_tiles: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build as build
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    work = ROOT / "build" / "bwd_tiles"
    work.mkdir(parents=True, exist_ok=True)
    print("ptxas -v:")
    for line in ptxas_lines(build, work / "flash_attention_bwd.o"):
        print("  " + line)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for name, b, s, hq, hkv, d, causal in SHAPES:
        q, dout = (torch.randn((b, s, hq, d), generator=gen, device=dev)
                   .bfloat16() for _ in range(2))
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        kw = dict(causal=causal)
        out, lse = fa.attend_with_lse(q, k, v, **kw)
        got = fa.attend_backward(q, k, v, out, dout, lse, **kw)
        want = fa.attend_backward_plain(q, k, v, out, dout, **kw)
        try:
            err = max(close(g, w) for g, w in zip(got, want))
        except AssertionError as e:
            ok = False
            err = float("nan")
            print(f"{name}: FAILED {e}")
        del got, want
        qh = q.transpose(1, 2).contiguous().requires_grad_(True)
        kh, vh = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_(True) for t in (k, v))
        doh = dout.transpose(1, 2).contiguous()
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal)
        o_lib = sdpa()
        times = {"kernel": [], "plain": [], "sdpa": [], "sdpa_bwd": []}
        runs = {
            "kernel": lambda: fa.attend_backward(q, k, v, out, dout, lse,
                                                 **kw),
            "plain": lambda: fa.attend_backward_plain(q, k, v, out, dout,
                                                      **kw),
            "sdpa": lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh),
            "sdpa_bwd": lambda: torch.autograd.grad(
                o_lib, (qh, kh, vh), doh, retain_graph=True)}
        for turn in ("kernel", "plain", "sdpa", "sdpa_bwd", "sdpa_bwd",
                     "sdpa", "plain", "kernel"):
            times[turn].append(cuda_ms(runs[turn],
                                       2 if turn == "plain" else 10))
        print(f"{name}: q [{b}, {s}, {hq}, {d}] over {hkv} KV heads, "
              f"{'causal' if causal else 'non-causal'}, bf16: max |kernel - "
              f"plain| / max(1, max |plain|) {err:.3g}; ms a call "
              + "; ".join(f"{k} {', '.join(f'{t:.4f}' for t in v)}"
                          for k, v in times.items()))
        print(f"{name}: device ms a call by pass (torch.profiler, 5 calls): "
              + ", ".join(f"{k} {v:.4f}" for k, v in
                          by_pass(runs["kernel"], 5).items()))
    print(f"every check passed: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
