"""The share in % of the profiled window in which no kernel, copy or
memset ran on a card, the mean over the cell's cards, from
``torch.profiler`` over jobs run with the program's tracer off."""

UNIT, LAYER, MOVES = "%", "Device", "sort_keys_per_s"


def read(rec):
    busy, window = rec.get("busy_s"), rec.get("window_s")
    if not busy or not window:
        return None
    return (1 - sum(busy) / len(busy) / window) * 100
