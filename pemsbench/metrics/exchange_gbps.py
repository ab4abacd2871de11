"""GB/s of the exchange between cards: the keys that have to cross cards
(``yardstick.crossing_bytes``, 4 (v - v/P)/v n bytes a job) over the
traced jobs' ``stage:alltoallv`` spans, total over total.  The modelled
count of ``IOLedger.network``, padding included, is held to the
benchmark's own in ``correct`` and is no numerator here: a staging format
that stops copying the padding would read as a rate past the link's.
Nothing to read on one card."""

UNIT, LAYER, MOVES = "GB/s", "Mesh", "sort_keys_per_s"


def read(rec):
    jobs = [r for r in rec.get("jobs", []) if "stages" in r]
    nbytes = sum(r["crossing_bytes"] for r in jobs)
    secs = sum(dur for r in jobs for name, _, dur in r["stages"]
               if name == "alltoallv")
    if not nbytes or not secs:
        return None
    return nbytes / secs / 1e9
