"""Shared arithmetic of the metric readers in ``metrics/``.

A reader takes the record of one run (what a system's ``window()`` or
``traced()`` returned, with ``device_kind``) and returns a number, or None
where the run holds nothing for it to read: the harness then leaves the
metric out of the result's line.
"""

from __future__ import annotations

from pemsbench import yardstick


def stage_ms(rec: dict, stage: str):
    """Milliseconds of the program's drained ``stage:<stage>`` spans, total
    over the traced jobs, divided by the jobs."""
    jobs = [r for r in rec.get("jobs", []) if "stages" in r]
    if not jobs:
        return None
    total = sum(dur for r in jobs for name, _, dur in r["stages"]
                if name == stage)
    return total / len(jobs) * 1e3


def roofline(rec: dict, stage: str):
    """The stage's least bytes over the card's peak bandwidth, as a share in
    % of the device time of the operations launched inside the stage."""
    peak = yardstick.HBM_BYTES_PER_S.get(rec.get("device_kind"))
    device_s = rec.get("stage_device_s", {}).get(stage)
    if not peak or not device_s:
        return None
    least = yardstick.least_bytes(stage, rec["stage_keys"])
    return least / peak / device_s * 100
