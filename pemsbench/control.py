"""The readings that set each limit of ``correct``, on the chip, at a
cell's own size, in one process.

    python3 pemsbench/control.py --workload <cell> --seeds 1 2 3 ...

For each seed: job 0 of that seed through the program, compared with the
reference (the lower reading; sound runs read 0 on an exact comparison),
and the control, the reference in float32 (:func:`reference.control_sort`)
in the program's place on the same keys (the upper reading).  Prints one
JSON line a seed and a summary line.  The benchmark's own runs never run
this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from pemsbench.run import cache_env  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cache_env()
    import torch

    from pemsbench import manifest as mf
    from pemsbench import reference
    manifest = mf.load()
    cell = mf.cell(manifest, args.workload)
    if torch.cuda.device_count() < cell["chips"]:
        print(f"control: {args.workload} needs {cell['chips']} card(s)",
              file=sys.stderr)
        return 2
    config = mf.config_file(manifest, cell["config"])
    traffic = mf.traffic_file(cell["traffic"])
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    worst = {"program": {}, "control": {}}
    for seed in args.seeds:
        sut = mf.system(config["system"]).make(config, traffic, seed,
                                               devices)
        if seed == args.seeds[0]:
            sut.warm_up()
        sut.job(0)
        program = sut.check()
        keys = sut.jobs.keys(0, sut.home)
        control = reference.compare(reference.control_sort(keys), keys)
        del keys, sut
        print(json.dumps({"seed": seed, "program": program,
                          "control": control}), flush=True)
        for side, got in (("program", program), ("control", control)):
            for name, value in got.items():
                w = worst[side]
                w[name] = ([min(w[name][0], value), max(w[name][1], value)]
                           if name in w else [value, value])
    print(json.dumps({"seeds": len(args.seeds),
                      "min_max": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
