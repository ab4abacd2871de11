"""Run one cell of the benchmark once and print its result.

    python3 pemsbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics untraced, its per-layer metrics traced), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number that
decided ``correct`` with its limit, also printed as the last lines of
standard error.  Exits non-zero with no result where the cell asks for more
cards than CUDA shows, where the program cannot be imported, or where a JAX
module is loaded once the window has closed.

The kernels build into ``build/`` inside the checkout (the program's own
fixed place); the caches that PyTorch and Triton would write go there too.
Profiler traces go to a fixed file under ``TMPDIR`` and are deleted once
read.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "chip_smoke", "benchmarks")


def cache_env(root: Path = ROOT) -> None:
    """Point every build and kernel cache at fixed directories inside the
    checkout, before ``torch`` is imported."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    one of the JAX package's (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(manifest: dict, name: str, seed: int, seconds: float,
             trace: bool, devices, scale_n=None,
             t_start: float = T_START) -> dict:
    """One run of cell ``name`` on ``devices`` (the cell's cards; the CPU
    in the tests, at ``scale_n`` keys a job).  Returns the result's line as
    a dict; ``checks`` comes last."""
    import torch

    from pemsbench import manifest as mf
    from pemsbench import reference
    cell = mf.cell(manifest, name)
    config = mf.config_file(manifest, cell["config"])
    traffic = mf.traffic_file(cell["traffic"])
    sut = mf.system(config["system"]).make(config, traffic, seed, devices,
                                           scale_n)
    rec = sut.traced() if trace else sut.window(seconds, t_start)
    cards = sut.cards
    dev = {"platform": "gpu" if cards else "cpu",
           "kind": torch.cuda.get_device_name(cards[0]) if cards else "cpu",
           "count": len(cards),
           "memory_peak_bytes": max(sut.card_peak, default=0)}
    rec["device_kind"] = dev["kind"]
    correct, checks = reference.verdict(sut.check())
    metrics = {}
    for m in mf.metrics_for(manifest, name, trace):
        value = mf.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": sut.attempted,
           "failed": sut.failed, "metrics": metrics, "device": dev}
    if trace and "busy_s" in rec:
        dev["busy_s"] = sum(rec["busy_s"]) / len(rec["busy_s"])
        dev["window_s"] = rec["window_s"]
        out["breakdown"] = {"device_ops": rec["device_ops"],
                            "idle_gaps": rec["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from pemsbench import manifest as mf
    manifest = mf.load()
    cell = mf.cell(manifest, args.workload)
    import repro_torch  # noqa: F401  (fails here where the program is absent)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"pemsbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); CUDA available: {torch.cuda.is_available()}, "
              f"cards: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    out = run_cell(manifest, args.workload, args.seed, args.seconds,
                   bool(args.trace), devices)
    bad = forbidden_modules()
    if bad:
        print(f"pemsbench: modules loaded that the benchmark must not load: "
              f"{bad}", file=sys.stderr)
        return 3
    for key, c in out["checks"].items():
        limit = (f"limit {c['limit']}" if "limit" in c
                 else f"at least {c['at_least']}")
        print(f"check {key}: {c['value']} ({limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
