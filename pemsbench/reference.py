"""The plain reference and the comparison that decides ``correct``.

The reference sorts the job's keys with ``torch.sort``, made afresh from the
seed; it imports nothing of the program and reads nothing the program made.
The comparison is exact: every position of the program's output against
the reference's, so every stage of the sort is under it.

The control puts the reference in the program's place one step below the
configuration's precision: the keys ordered by their float32 images (24
bits of mantissa), the shortcut a sort that looks at fewer key bits would
take.  It is a permutation of the input, so only the order gives it away.
"""

from __future__ import annotations

import torch

# Each number compared and its limit: an exact comparison has the limit 0.
LIMITS = {
    "mismatched_keys": 0,       # positions where output != reference
    "length_gap": 0,            # |len(output) - n|
    "network_bytes_gap": 0,     # |IOLedger.network - the benchmark's count|
    "failed_jobs": 0,           # jobs that raised and gave no output
}


def reference_sort(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys).values


def control_sort(keys: torch.Tensor) -> torch.Tensor:
    """The reference in float32: keys ordered by their float32 images."""
    order = torch.sort(keys.to(torch.float32), stable=True).indices
    return keys[order]


def compare(out: torch.Tensor, keys: torch.Tensor) -> dict:
    """``mismatched_keys`` and ``length_gap`` of ``out`` against the
    reference sort of ``keys`` (on ``keys``' device)."""
    ref = reference_sort(keys)
    out = out.reshape(-1).to(ref.device)
    gap = abs(out.numel() - ref.numel())
    if gap:
        bad = ref.numel()
    else:
        bad = int((out != ref).sum())
    return {"mismatched_keys": bad, "length_gap": gap}


def verdict(readings: dict) -> tuple:
    """``(correct, checks)``: each reading with its limit, and whether every
    one is within it.  ``compared_jobs`` is held to at least one: a run
    that compared nothing is not correct."""
    checks = {name: {"value": readings[name], "limit": LIMITS[name]}
              for name in LIMITS if name in readings}
    ok = (len(checks) == len(LIMITS)
          and all(c["value"] <= c["limit"] for c in checks.values()))
    compared = readings.get("compared_jobs", 0)
    checks["compared_jobs"] = {"value": compared, "at_least": 1}
    return ok and compared >= 1, checks
