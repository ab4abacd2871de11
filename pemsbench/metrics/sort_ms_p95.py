"""The 95th percentile, by nearest rank, of every window job's time from
the call to its output, between CUDA events on the first card's stream (the
host's clock is too coarse for one job)."""

from pemsbench.yardstick import nearest_rank

UNIT, LAYER, MOVES = "ms", None, None


def read(rec):
    ms = [r["event_ms"] for r in rec.get("jobs", []) if "event_ms" in r]
    return nearest_rank(ms, 0.95) if ms else None
