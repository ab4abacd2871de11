"""The largest over the window's jobs of the call's peak allocated device
bytes, summed over the cell's cards with the input keys resident, per key
sorted: the thesis's measure of space."""

UNIT, LAYER, MOVES = "B/key", None, None


def read(rec):
    per_key = [r["peak_bytes"] / r["n"] for r in rec.get("jobs", [])
               if "peak_bytes" in r]
    return max(per_key) if per_key else None
