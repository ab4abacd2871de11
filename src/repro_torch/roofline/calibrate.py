"""Calibrated cost model: per-layer, per-microbatch and outside-the-loops
flops, bytes and collective volumes — the port of
``repro/roofline/calibrate.py``.

The JAX package needs it because XLA's ``cost_analysis`` counts a loop body
once.  The port's dry run counts every op as it runs (its layers and
microbatches are Python loops), so its direct count of a cell is already
the whole step; the probes here split that count into the same linear
structure, and the direct count checks it:

  counted(L, B) = OUT + MB(B) + L·LY(B)
  true(L, B_mb, n_mb) = OUT + n_mb · (MB(B_mb) + L·LY(B_mb))

where OUT = outside both loops (optimizer update, gradient reduction), MB =
per-microbatch fixed part (embed, unembed, loss), LY = one layer; MB and LY
are linear in batch, OUT is batch-independent.  Three probes identify all
three terms per metric:

  P_a  = (L=la, B=B0)     P_b = (L=lb, B=B0)     P_a2 = (L=la, B=2·B0)

  LY(B0) = (P_b − P_a)/(lb − la)
  MB(B0) = (P_a2 − P_a) − la·LY(B0)
  OUT    = 2·P_a − P_a2

Serving steps (no optimizer/microbatch loop) use the same probes with
n_mb = 1.  The flops follow the structure exactly (the optimizer does no
matrix product); the bytes and collectives of the optimizer scale with the
layers, so their extrapolation counts a layer's share of it once a
microbatch, as the JAX package's does.
"""

from __future__ import annotations

import json
import os
from typing import Dict

from .analyze import HW, analytic_bytes_floor, collective_bytes, roofline_terms

METRICS = ("flops", "bytes", "coll")


def _counts(trace) -> Dict[str, float]:
    return {"flops": float(trace.flops), "bytes": float(trace.bytes),
            "coll": float(collective_bytes(trace.collectives)
                          ["weighted_bytes"])}


def _probe(arch: str, shape_name: str, mesh, **kw) -> Dict[str, float]:
    from ..launch.dryrun import build_cell
    overrides = {"unroll_layers": True, **kw.pop("cfg_overrides", {})}
    cell, _ = build_cell(arch, shape_name, mesh, cfg_overrides=overrides,
                         **kw)
    return _counts(cell())


def _probe_layers(cfg) -> tuple:
    """(la, lb) respecting layer-group structure (hybrid patterns, leading
    dense layers)."""
    g = len(cfg.block_pattern) if cfg.block_pattern else 1
    base = cfg.first_dense_layers
    la = base + g * (2 if g == 1 else 1)
    lb = base + g * (4 if g == 1 else 2)
    return la, lb


def calibrate_cell(arch: str, shape_name: str, mesh, microbatches: int = 8,
                   *, direct: bool = False, **cell_kw) -> Dict:
    """The calibrated counts of one cell from three probes.  ``cell_kw``
    (``cfg_overrides``, ``seq_len``, ``global_batch``, ``device``) cut the
    cell as :func:`~repro_torch.launch.dryrun.build_cell` takes them; with
    ``direct`` the whole cell is traced too and its counts kept under
    ``"direct"``."""
    import dataclasses

    from ..configs import SHAPES, get_config
    cfg = get_config(arch)
    if cell_kw.get("cfg_overrides"):
        cfg = dataclasses.replace(cfg, **cell_kw["cfg_overrides"])
    shape = SHAPES[shape_name]
    L = cfg.n_layers
    la, lb = _probe_layers(cfg)
    train = shape.kind == "train"
    n_mb = microbatches if train else 1
    b_full = cell_kw.pop("global_batch", None) or shape.global_batch
    b0 = max(b_full // n_mb, 1) if train else b_full
    # Batch probes need 2·B0 ≤ full batch and divisibility by the data axes.
    b2 = min(2 * b0, b_full) if train else b_full
    mbkw = {"microbatches": 1} if train else {}

    pa = _probe(arch, shape_name, mesh, n_layers=la, global_batch=b0,
                **mbkw, **cell_kw)
    pb = _probe(arch, shape_name, mesh, n_layers=lb, global_batch=b0,
                **mbkw, **cell_kw)
    if train and b2 > b0:
        pa2 = _probe(arch, shape_name, mesh, n_layers=la, global_batch=b2,
                     **mbkw, **cell_kw)
    else:
        pa2 = None

    out: Dict = {"probe_layers": (la, lb), "n_mb": n_mb}
    for m in METRICS:
        ly = max((pb[m] - pa[m]) / (lb - la), 0.0)
        if pa2 is not None:
            mb_part = max((pa2[m] - pa[m]) / (b2 / b0 - 1.0) - la * ly, 0.0)
            outpart = max(pa[m] - mb_part - la * ly, 0.0)
        else:
            mb_part = max(pa[m] - la * ly, 0.0)
            outpart = 0.0
        out[m] = outpart + n_mb * (mb_part + L * ly)
        out[m + "_layer"] = ly
        out[m + "_mb_fixed"] = mb_part
        out[m + "_outside"] = outpart
    out["roofline"] = roofline_terms(out["flops"], out["bytes"], out["coll"])
    if direct:
        from ..launch.dryrun import build_cell
        cell, _ = build_cell(arch, shape_name, mesh, global_batch=b_full,
                             microbatches=n_mb if train else None,
                             **cell_kw)
        out["direct"] = _counts(cell())
    return out


def calibrate_and_update(arch: str, shape_name: str, mesh, art_dir: str,
                         tag: str = "single") -> Dict:
    """Write calibrated terms into the cell's dry-run artifact, beside the
    dry run's direct count of the whole cell (``direct_flops``)."""
    from ..configs import SHAPES, get_config

    cal = calibrate_cell(arch, shape_name, mesh)
    fn = os.path.join(art_dir, f"{arch}__{shape_name}__{tag}.json")
    if not os.path.exists(fn):
        return {"calibrated": cal}
    with open(fn) as f:
        d = json.load(f)

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_chips = 1
    for v in d["mesh"].values():
        n_chips *= v
    tokens = shape.global_batch * (
        shape.seq_len if shape.kind != "decode" else 1)
    cache_b = 0
    if shape.kind != "train":
        cache_b = int(d["memory"]["argument_bytes"]) * n_chips  # incl. cache
    floor = analytic_bytes_floor(
        shape.kind, n_params=d["n_params"], n_active=d["n_params_active"],
        n_layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
        tokens=tokens, n_mb=cal["n_mb"], n_chips=n_chips,
        cache_bytes=cache_b,
        opt_bytes_per_param=4 if "int8" in d.get("optimizer", "") else 16)
    cal["bytes_floor"] = floor
    cal["memory_floor_s"] = floor / HW["hbm_bw"]
    cal["direct_flops"] = d["cost"]["flops_per_device"]
    r = cal["roofline"]
    bound_opt = max(r["compute_s"], cal["memory_floor_s"], r["collective_s"])
    cal["roofline_fraction_optimistic"] = (
        r["compute_s"] / bound_opt if bound_opt else 0.0)

    d["calibrated"] = cal
    mf = d.get("model_flops_per_device", 0.0)
    d["calibrated"]["useful_flop_ratio"] = (
        mf / cal["flops"] if cal["flops"] else 0.0)
    with open(fn, "w") as f:
        json.dump(d, f, indent=1)
    return d


def main(argv=None):
    import argparse

    from ..configs import ARCH_NAMES, SHAPES, get_config, skip_reason
    from ..launch.mesh import fake_world, make_production_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_NAMES
    with fake_world(256):
        mesh = make_production_mesh(multi_pod=False)
        for arch in archs:
            cfg = get_config(arch)
            for sh in ([args.shape] if args.shape else list(SHAPES)):
                if skip_reason(cfg, sh):
                    continue
                try:
                    d = calibrate_and_update(arch, sh, mesh, args.out)
                    c = d["calibrated"]
                    r = c["roofline"]
                    print(f"CAL {arch} {sh}: flops={c['flops']:.3e} "
                          f"bytes={c['bytes']:.3e} coll={c['coll']:.3e} "
                          f"dom={r['dominant']} "
                          f"frac={r['roofline_fraction']:.3f} "
                          f"useful={c.get('useful_flop_ratio', 0):.3f}",
                          flush=True)
                except Exception as e:  # a failed cell is reported, the rest run
                    print(f"CALFAIL {arch} {sh}: {e}", flush=True)


if __name__ == "__main__":
    main()
