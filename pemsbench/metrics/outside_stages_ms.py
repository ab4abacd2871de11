"""Milliseconds of a job outside its stages: each traced job's host-clock
call time less the sum of its ``stage:*`` spans (the plan build, the load,
the extraction and gather of the output), the mean over the jobs."""

UNIT, LAYER, MOVES = "ms", "Executor host path", "sort_keys_per_s"


def read(rec):
    jobs = [r for r in rec.get("jobs", []) if "stages" in r]
    if not jobs:
        return None
    rest = [r["wall_s"] - sum(dur for _, _, dur in r["stages"]) for r in jobs]
    return sum(rest) / len(rest) * 1e3
