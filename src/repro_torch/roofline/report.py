"""The dry-run and roofline tables of a directory of dry-run artifacts: the
port of ``repro/roofline/report.py``.

    PYTHONPATH=src python -m repro_torch.roofline.report artifacts/dryrun_torch
"""

from __future__ import annotations

import glob
import json
import os
import sys

from .analyze import HW


def load(art_dir: str):
    rows = []
    for fn in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(fn) as f:
            rows.append(json.load(f))
    return rows


def fmt_bytes(b: float) -> str:
    return f"{b / 1e9:.2f}"


def dryrun_table(rows, mesh_tag: str, hw=HW) -> str:
    """One row a cell of ``mesh_tag`` ("single" or "multi"); the "fits"
    column names the capacity of ``hw`` in GiB."""
    cap = f"{hw['hbm_bytes'] / 1024**3:.3g}GB"
    out = [f"| arch | shape | compile_s | bytes/dev GB | fits {cap} | "
           "collective GB | FLOPs/dev | notes |",
           "|---|---|---|---|---|---|---|---|"]
    for d in rows:
        if d.get("skipped"):
            if mesh_tag == "single":
                out.append(f"| {d['arch']} | {d['shape']} | — | — | — | — | — "
                           f"| SKIP: {d['skipped']} |")
            continue
        if d.get("error"):
            out.append(f"| {d['arch']} | {d['shape']} | — | — | — | — | — "
                       f"| ERROR |")
            continue
        if ("multi" if d["multi_pod"] else "single") != mesh_tag:
            continue
        m = d["memory"]
        out.append(
            f"| {d['arch']} | {d['shape']} | {d['compile_s']} "
            f"| {fmt_bytes(m['per_device_bytes'])} "
            f"| {'yes' if m['fits_hbm'] else 'NO'} "
            f"| {d['collectives']['weighted_bytes'] / 1e9:.3f} "
            f"| {d['cost']['flops_per_device']:.3g} "
            f"| {d.get('optimizer', '')} |")
    return "\n".join(out)


def roofline_table(rows) -> str:
    """Calibrated roofline terms where a cell has them; memory bracketed
    between the analytic floor and the traced bytes accessed."""
    out = ["| arch | shape | compute_s | mem_s floor…hlo | collective_s "
           "| dominant | frac (floor…hlo) | useful-FLOP | next lever |",
           "|---|---|---|---|---|---|---|---|---|"]
    for d in rows:
        if d.get("skipped") or d.get("error") or d.get("multi_pod"):
            continue
        c = d.get("calibrated")
        if c:
            r = c["roofline"]
            uf = c.get("useful_flop_ratio", d.get("useful_flop_ratio", 0.0))
            mem = f"{c.get('memory_floor_s', 0):.3g}…{r['memory_s']:.3g}"
            frac = (f"{c.get('roofline_fraction_optimistic', 0):.3f}…"
                    f"{r['roofline_fraction']:.3f}")
        else:
            r = d["roofline"]
            uf = d.get("useful_flop_ratio", 0.0)
            mem = f"{r['memory_s']:.3g}"
            frac = f"{r['roofline_fraction']:.3f}"
        out.append(
            f"| {d['arch']} | {d['shape']} | {r['compute_s']:.4g} "
            f"| {mem} | {r['collective_s']:.4g} "
            f"| {r['dominant']} | {frac} "
            f"| {uf:.3f} | {_hint(d)} |")
    return "\n".join(out)


def _hint(d) -> str:
    r = d["roofline"]
    dom = r["dominant"]
    if dom == "collective":
        kinds = d["collectives"]["bytes_by_kind"]
        top = max(kinds, key=kinds.get)
        return (f"cut {top} volume (top kind, "
                f"{kinds[top] / 1e9:.2f} GB): reshard or overlap")
    if dom == "memory":
        if d["kind"] == "decode":
            return "decode is weight/cache-streaming bound: batch more reqs"
        return "fuse/remat less, bf16 more intermediates"
    return "compute-bound: already near the right wall; raise utilisation"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    art = argv[0] if argv else "artifacts/dryrun_torch"
    rows = load(art)
    print("## Dry-run — single pod (16×16)\n")
    print(dryrun_table(rows, "single"))
    print("\n## Dry-run — multi-pod (2×16×16)\n")
    print(dryrun_table(rows, "multi"))
    print("\n## Roofline (single pod)\n")
    print(roofline_table(rows))


if __name__ == "__main__":
    main()
