"""The frozen arithmetic of the benchmark: peaks, least bytes, quantiles.

The least bytes of a PSRS stage are what any implementation of it has to
move, whatever kernels do the work: each key read once and written once, 8
bytes a key for int32 keys.  Counting a kernel's own output instead (the
cap-wide fill of the message buffers, as ``chip_smoke.py``'s ``bound()``
does) would let a change that stops writing the fill shrink its own bound.
Operations never bound these stages on the H100: log2(n!) comparisons at the
int32 rate take less time than 8n bytes at the memory's rate.
"""

from __future__ import annotations

import math

# Published peak memory bandwidth by device name, as
# ``torch.cuda.get_device_name()`` gives it (NVIDIA's data sheet; the SXM
# part at its 700 W limit).  A card not listed has no roofline.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

KEY_BYTES = 4                           # int32 keys

# The least bytes a stage moves, as a multiple of the keys it sorts.
STAGE_BYTES_PER_KEY = {
    "sort_sample": 2 * KEY_BYTES,       # each key read and written once
    "merge": 2 * KEY_BYTES,             # each received key read, each written
}


def least_bytes(stage: str, n: int) -> int:
    return STAGE_BYTES_PER_KEY[stage] * n


def exchange_bytes(n: int, v: int, P: int) -> int:
    """The bytes a PSRS run moves between real processors in the thesis's
    model of PEMS2's direct Alltoallv, which ``IOLedger.network`` counts:
    each context sends one message of n/v words, padding included, to each
    of the ``v - v/P`` contexts on other processors,
    the gather of the ``v`` samples of ``(value, index)`` pairs reaches the
    root from the ``v - v/P`` remote contexts, and the broadcast of the
    ``v`` splitter pairs reaches the ``P - 1`` other processors.  Zero at
    ``P == 1``."""
    if P == 1:
        return 0
    m = v // P
    cap = n // v
    pairs = v * 2 * KEY_BYTES                 # [v, 2] int32
    return v * (v - m) * cap * KEY_BYTES + (v - m) * pairs + (P - 1) * pairs


def crossing_bytes(n: int, v: int, P: int) -> int:
    """The least bytes of the keys that have to cross between real
    processors: with buckets even, each context's keys go to the ``v``
    contexts alike, and ``v - v/P`` of them lie on other processors.  What
    the exchange has to move whatever its staging format; zero at
    ``P == 1``."""
    return KEY_BYTES * n * (v - v // P) // v


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) of ``values`` by nearest rank: the
    smallest value with at least a share ``q`` of the values at or below."""
    xs = sorted(values)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]
