"""Batched serving driver of the port.

    python -m repro_torch.launch.serve --arch mamba2-130m --requests 8 \\
        --prompt-len 1024 --gen-len 64
    python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke --device cpu
    python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
        --requests 8 --prompt-len 3072 --gen-len 64

Weights are made on the device from ``--seed``; prompts are random tokens
from the same seed.  Prints the prefill time, the decode time per step
(median) and the generated tokens per second, each on the device's own
clock (CUDA events on the card).
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from ..configs import ARCH_NAMES, get_config
from ..core.context import resolve_device
from ..models import Model
from ..models.model import check_servable
from ..serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config (CPU tests)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.gen_len < 1:
        ap.error("--gen-len must be at least 1")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    check_servable(cfg)
    dev = resolve_device(args.device)
    model = Model(cfg, device=dev, seed=args.seed)
    eng = ServeEngine(model, max_seq=args.prompt_len + args.gen_len + 8)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.requests, args.prompt_len)))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    out = eng.generate(prompts, steps=args.gen_len,
                       temperature=args.temperature, generator=gen)
    t = eng.timing
    total_s = (t["prefill_ms"] + sum(t["decode_ms"])) / 1e3
    tokens = args.requests * args.gen_len
    print(f"arch={cfg.name} device={dev} requests={args.requests} "
          f"prompt={args.prompt_len} generated={tokens}")
    print(f"prefill {t['prefill_ms']:.3f} ms, decode "
          f"{statistics.median(t['decode_ms']):.3f} ms/step (median of "
          f"{len(t['decode_ms'])}), {tokens / total_s:,.1f} generated tok/s")
    print("sample:", out[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()
