"""All keys of all jobs completed in the window, over the window's seconds
(host clock; the window ends when the last job's output is ready)."""

UNIT, LAYER, MOVES = "keys/s", None, None


def read(rec):
    if not rec.get("jobs"):
        return None
    return sum(r["n"] for r in rec["jobs"]) / rec["window_s"]
