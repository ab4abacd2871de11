"""Seconds from the process's start to the first timed job: imports, the
cards' contexts, the kernels' build or load, and the warm-up jobs."""

UNIT, LAYER, MOVES = "s", None, None


def read(rec):
    return rec.get("setup_s")
