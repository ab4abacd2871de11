"""Training driver of the port: the JAX package's ``repro.launch.train``
with the same flags and print lines, plus ``--device``.

    python -m repro_torch.launch.train --arch qwen2-1.5b --smoke --device cpu
    python -m repro_torch.launch.train --arch hubert-xlarge --steps 5 \\
        --seq 1024 --batch 16 --microbatches 2

It runs on CUDA unless ``--device`` names another device (``cpu`` runs the
kernels' plain versions).  Weights are made from seed 0, as the JAX CLI
uses key 0; the data is the step-addressable synthetic pipeline.  With
``--ckpt-dir`` it keeps checkpoints through the port's ``CheckpointManager``
(atomic, the newest complete one restored) and resumes from the newest: the
data pipeline starts at the restored step, so a resumed run takes exactly
the batches the crashed run would have.  Checkpoints are the port's own: the JAX package
stacks its layers, the port keeps one dict a layer.
"""

from __future__ import annotations

import argparse
import time

from ..checkpoint import CheckpointManager
from ..configs import ARCH_NAMES, get_config
from ..core.context import resolve_device
from ..data import DataConfig, synthetic_batches
from ..models import Model
from ..optim import OptConfig
from ..train import (TrainConfig, init_train_state, load_train_state_,
                     make_train_step)
from ..tree import leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    dev = resolve_device(args.device)
    model = Model(cfg, device=dev)
    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr),
        microbatches=args.microbatches,
        warmup_steps=max(args.steps // 20, 1),
        total_steps=args.steps,
        grad_compress=args.grad_compress,
    )
    dcfg = DataConfig(
        seq_len=args.seq, global_batch=args.batch, vocab=cfg.vocab,
        frontend=cfg.frontend, n_frontend_tokens=cfg.n_frontend_tokens,
        d_model=cfg.d_model)

    params = model.params()
    n_params = sum(p.numel() for p in leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.2f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq}")

    state = init_train_state(params, tcfg)
    step_fn = make_train_step(model, tcfg)

    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        got = mgr.restore_latest(like=state)
        if got is not None:
            start, restored = got
            load_train_state_(state, restored)
            print(f"resumed from step {start}")

    t0 = time.time()
    tokens = 0
    for i, batch in zip(range(start, args.steps),
                        synthetic_batches(dcfg, start_step=start,
                                          device=dev)):
        state, metrics = step_fn(state, batch)
        tokens += args.batch * args.seq
        if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
            dt = time.time() - t0
            print(f"step {i + 1:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['gnorm']):.3f} "
                  f"tok/s={tokens / dt:,.0f}")
        if mgr and ((i + 1) % args.ckpt_every == 0 or i + 1 == args.steps):
            mgr.save(i + 1, state, blocking=False)
    if mgr:
        mgr.wait()
    print("done")
    return state


if __name__ == "__main__":
    main()
