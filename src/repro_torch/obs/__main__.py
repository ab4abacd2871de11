"""CLI: ``python -m repro_torch.obs report <trace.json> [--top N]``.

Stdlib-only — runs anywhere the exported trace file can be copied, no
torch or numpy required.  It reads the JAX package's traces as well.
"""

from __future__ import annotations

import argparse
import sys

from .report import report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize a span trace (compute/I-O/stall per "
                    "phase, overlap cross-check, slowest requests).")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="summarize an exported trace")
    rp.add_argument("trace", help="trace JSON written by Pems.export_trace")
    rp.add_argument("--top", type=int, default=10,
                    help="slowest requests to list (default 10)")
    args = ap.parse_args(argv)
    print(report(args.trace, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
