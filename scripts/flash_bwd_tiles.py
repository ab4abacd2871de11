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
``dq_mma_kernel<D>`` (bf16 up to head dim 128), ``dkdv_256_kernel``,
``dq_256_kernel`` and ``sum_slices_kernel`` (bf16 at head dim 256), the
FMA passes ``dkdv_kernel`` and ``dq_kernel`` (fp32) and
``row_dot_kernel``.  Then, at hubert-xlarge's, qwen2-1.5b's and
recurrentgemma-2b's training shapes, holds the bf16 backward to
``attend_backward_plain`` within ``chip_smoke.py``'s ``BWD_BF16_TOL``,
times it in turns beside the plain version,
``scaled_dot_product_attention``'s forward plus backward and its backward
alone (the library calls; the port never makes them), and splits the
kernel's device time by pass (``torch.profiler``).

At recurrentgemma's call it also checks and times 1-4 row slices of the
head-dim-256 dK/dV pass in turns, pass by pass (the wrapper's plan,
``_bwd_slices``, gives 2).  The edge cases are ``chip_smoke.py
--train-only``'s.
The objects go to ``build/`` in the checkout.  Exit 1 if a check fails.
"""

from __future__ import annotations

import importlib
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
# (name, b, s, hq, hkv, d, mask keywords): the training calls of
# hubert-xlarge, qwen2-1.5b and recurrentgemma-2b's local attention
# (chip_smoke.py rows 5b, 5bq and 5br).
SHAPES = [("hubert-xlarge", 8, 1024, 16, 16, 80, dict(causal=False)),
          ("qwen2-1.5b", 8, 1024, 12, 2, 128, dict(causal=True)),
          ("recurrentgemma-2b", 2, 3072, 10, 1, 256,
           dict(causal=True, window=2048))]
BWD_BF16_TOL = (2**-7, 1e-4)


def ptxas_lines(build, obj: Path) -> list:
    """``ptxas -v``'s registers and spills for each kernel of the source."""
    out = subprocess.run([build._nvcc(), *build.FLAGS, "-Xptxas",
                          "-v", "-c", str(build.CSRC / "flash_attention_bwd.cu"),
                          "-o", str(obj)], capture_output=True, text=True,
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
        fma = re.search(r"(dkdv|dq)_kernelILi(\d+)E", name)
        d256 = re.search(r"(dkdv|dq)_256_kernel", name)
        if mma:
            what = f"{mma.group(1)}_mma_kernel bf16 D {mma.group(2)}"
        elif fma:
            what = f"{fma.group(1)}_kernel fp32 D {fma.group(2)}"
        elif d256:
            what = f"{d256.group(1)}_256_kernel bf16"
        elif "sum_slices" in name:
            what = "sum_slices_kernel"
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


def compare_slices(fa, gen) -> bool:
    """1-4 row slices of the head-dim-256 dK/dV pass at recurrentgemma-2b's
    call: each held to the plain version and run twice for equal bits, then
    timed in turns (1, 2, 3, 4, 4, 3, 2, 1) and split by pass."""
    _, b, s, hq, hkv, d, kw = SHAPES[-1]
    q, dout = (torch.randn((b, s, hq, d), generator=gen, device="cuda")
               .bfloat16() for _ in range(2))
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    out, lse = fa.attend_with_lse(q, k, v, **kw)
    want = fa.attend_backward_plain(q, k, v, out, dout, **kw)
    run = lambda: fa.attend_backward(q, k, v, out, dout, lse, **kw)
    ok = True
    plan = fa._bwd_slices
    try:
        counts = (1, 2, 3, 4)
        times = {n: [] for n in counts}
        for n in counts + counts[::-1]:
            fa._bwd_slices = lambda *args, n=n: n
            if len(times[n]) == 0:
                got = run()
                if not all(torch.equal(x, y) for x, y in zip(got, run())):
                    ok = False
                    print(f"{n} slices: FAILED, two runs differ")
                for g, w in zip(got, want):
                    close(g, w)
            times[n].append(cuda_ms(run, 5))
        for n in counts:
            fa._bwd_slices = lambda *args, n=n: n
            passes = by_pass(run, 3)
            print(f"{n} row slices (plan {plan(fa._sms(q.device), q.dtype, b, s * hq // hkv, hkv, d, s)}): "
                  f"ms a call {', '.join(f'{t:.4f}' for t in times[n])}; dkdv_256_kernel "
                  f"{passes.get('dkdv_256_kernel', 0.0):.4f}, sum_slices_kernel "
                  f"{passes.get('sum_slices_kernel', 0.0):.4f}")
    except AssertionError as e:
        ok = False
        print(f"row slices: FAILED {e}")
    finally:
        fa._bwd_slices = plan
    return ok


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
    ok = compare_slices(fa, gen)
    for name, b, s, hq, hkv, d, kw in SHAPES:
        q, dout = (torch.randn((b, s, hq, d), generator=gen, device=dev)
                   .bfloat16() for _ in range(2))
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev)
                .bfloat16() for _ in range(2))
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
        if kw.get("window"):
            i = torch.arange(s, device=dev)[:, None]
            j = torch.arange(s, device=dev)[None, :]
            sdpa_kw = dict(attn_mask=(j <= i) & (j > i - kw["window"]))
        else:
            sdpa_kw = dict(is_causal=kw["causal"])
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, **sdpa_kw)
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
        masks = ", ".join(f"{k} {v}" for k, v in kw.items())
        print(f"{name}: q [{b}, {s}, {hq}, {d}] over {hkv} KV heads, "
              f"{masks}, bf16: max |kernel - plain| / max(1, max |plain|) "
              f"{err:.3g}; ms a call "
              + "; ".join(f"{k} {', '.join(f'{t:.4f}' for t in v)}"
                          for k, v in times.items()))
        print(f"{name}: device ms a call by pass (torch.profiler, 5 calls): "
              + ", ".join(f"{k} {v:.4f}" for k, v in
                          by_pass(runs["kernel"], 5).items()))
        del q, k, v, out, dout, lse, qh, kh, vh, doh, o_lib
    print(f"every check passed: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
