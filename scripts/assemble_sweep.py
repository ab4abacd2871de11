#!/usr/bin/env python3
"""Kernel 4 (the ``P > 1`` mesh staging) beside the copies it is measured by.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 scripts/assemble_sweep.py
    python3 scripts/assemble_sweep.py --src OTHER/src   # another tree's kernel

It sorts-and-partitions 2^27 int32 keys as PSRS does over P = 4 processes of
a one-card mesh (v = 16, k = 2), so that the store holds the exchange's real
send words and counts, and then times, on the α = 1 run's first chunk (32
messages of 2^23 words, about 6 % valid) and on the unchunked run's one chunk
(256 messages, 8 GiB written):

- kernel 4 (``assemble_words``) at each span a block moves
  (``SPAN_WORDS``) into each destination layout: the contiguous buffer a
  mesh over several cards ships, and the receivers' recv rows of the store;
  every span's output is held against the first's, bit for bit, on the
  α = 1 chunk;
- kernel 2 (``deliver_words``, the ``P == 1`` delivery) on the same words:
  on the unchunked chunk it is the same function (message ``(s -> d)`` from
  row ``s`` into row ``d``); the α = 1 chunk's 32 messages have no square
  form, so there it delivers 4 × 4 messages of 2ω words, as many bytes
  written, at its own valid share;
- ``Tensor.copy_`` and ``Tensor.fill_`` of as many words: the card's copy
  and write rates, not the same function.

Each line gives the mean ms over ``--reps`` calls between CUDA events, the
rate of the bytes the function must move (the destination written, the
valid words and the counts words read: the bound's bytes) and that rate's
share of 3.35 TB/s.  With ``--src`` it imports ``repro_torch`` from that
tree instead (an older kernel 4 with no span and no strided destination is
timed once, into the buffer).
"""

from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
INT_MIN, INT_MAX = -2**31, 2**31 - 1
HBM_BYTES_PER_S = 3.35e12
P, K = 4, 2


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after a warm-up
    call, between CUDA events."""
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


def line(what: str, ms: float, nbytes: int) -> None:
    rate = nbytes / (ms * 1e-3)
    print(f"  {what}: {ms:.4f} ms, {rate / 1e12:.3f} TB/s of the function's "
          f"bytes, {rate / HBM_BYTES_PER_S * 100:.1f} % of 3.35 TB/s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch is timed")
    ap.add_argument("--log-n", type=int, default=27)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--spans", type=int, nargs="+",
                    default=[1024, 2048, 4096, 8192, 16384, 32768],
                    help="words a block moves of a message")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("assemble_sweep: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import make_mesh
    from repro_torch.kernels import _build
    from repro_torch.pems_apps import psrs_plan
    dv = importlib.import_module(
        "repro_torch.kernels.alltoallv_deliver.alltoallv_deliver")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"repro_torch from {dv.__file__}; library {_build.build().name}")
    strided = hasattr(dv, "SPAN_WORDS")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n, v = 1 << args.log_n, 16
    n_v, m = n // v, v // P
    keys = torch.randint(INT_MIN, INT_MAX + 1, (n,), generator=gen,
                         device=dev, dtype=torch.int64).to(torch.int32)
    pems, load, steps, _ = psrs_plan(v, n_v, k=K, P=P, mesh=make_mesh(P),
                                     alpha=1, driver="explicit", device=dev)
    store = load(keys.reshape(v, n_v))
    del keys
    for name, step in steps:
        store = step(store)
        if name == "partition":
            break
    lo, data = pems.layout, store.data
    ww = n_v
    off_s, off_r = lo.offset("bsend"), lo.offset("brecv")
    off_c, off_rc = lo.offset("bscnt"), lo.offset("brcnt")
    rows = data[:, off_r:off_r + v * ww].view(P, m, P, m, ww)
    rc = data[:, off_rc:off_rc + v].view(P, m, P, m)
    cnt = store.field("bscnt").reshape(P, m, P, m)

    for label, (s0, s, c0, d) in (("alpha = 1, first chunk", (0, K, 0, 1)),
                                  ("unchunked", (0, m, 0, m))):
        nmsg = P * P * d * s
        words = nmsg * ww
        valid = int(cnt[:, s0:s0 + s, :, c0:c0 + d].clamp(0, ww).sum())
        nbytes = 4 * (words + valid + 3 * nmsg)
        print(f"{label}: {nmsg} messages of {ww} words, "
              f"{words * 4 / 2**30:.2f} GiB written, {valid} valid "
              f"({valid / words * 100:.1f} %), bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        buf = torch.empty(words, dtype=torch.int32, device=dev)
        ct = torch.empty(nmsg, dtype=torch.int32, device=dev)
        dests = {"buffer": (buf, ct)}
        if strided:
            dests["recv rows"] = (
                rows[:, c0:c0 + d, :, s0:s0 + s].permute(2, 0, 1, 3, 4),
                rc[:, c0:c0 + d, :, s0:s0 + s].permute(2, 0, 1, 3))
        first = None
        for span in (args.spans if strided else [None]):
            if span is not None:
                dv.SPAN_WORDS = span
            for where, (out, cto) in dests.items():
                def call():
                    dv.assemble_words(data, off_s, m, P, P, s0, s, c0, d, ww,
                                      out, data, off_c, INT_MAX, data, off_c,
                                      cto)
                ms = cuda_ms(call, args.reps)
                if d == 1:                 # exact across spans and layouts
                    got = out.reshape(-1) if where == "buffer" else \
                        out.contiguous().reshape(-1)
                    if first is None:
                        first = got.clone()
                    elif not torch.equal(got, first):
                        raise RuntimeError(f"span {span} into the {where} "
                                           "differs from the first variant")
                    del got
                tag = "kernel 4" if span is None else \
                    f"kernel 4, span {span} words ({span * 4 // 1024} KiB)"
                line(f"{tag} into the {where}", ms, nbytes)
        del first
        if d == m:
            line("kernel 2 on the same words (the P = 1 delivery)",
                 cuda_ms(lambda: dv.deliver_words(
                     data, off_s, data, off_r, v, ww, data, off_c, INT_MAX,
                     data, off_c, data, off_rc), args.reps), nbytes)
        else:
            # 4 x 4 messages of 2 ω words: rows 0-3 of the send and recv
            # fields, masked by those rows' first counts.
            k2_valid = int(store.field("bscnt")[:4, :4].clamp(0, 2 * ww)
                           .sum())
            top = data[:4]
            line(f"kernel 2, v 4 x 2 omega words ({k2_valid} valid): as many "
                 "bytes written",
                 cuda_ms(lambda: dv.deliver_words(
                     top, off_s, top, off_r, 4, 2 * ww, top, off_c,
                     INT_MAX, top, off_c, top, off_rc), args.reps),
                 4 * (words + k2_valid + 3 * 16))
        src = torch.empty_like(buf)
        line("Tensor.copy_ of as many words (reads them all; not the same "
             "function)", cuda_ms(lambda: buf.copy_(src), args.reps),
             8 * words)
        line("Tensor.fill_ of as many words (writes only; not the same "
             "function)", cuda_ms(lambda: buf.fill_(INT_MAX), args.reps),
             4 * words)
        del buf, ct, src, dests
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
