"""BSP applications running on the port's PEMS executor (thesis Chapter 8)."""

from .psrs import (
    STAGE_SNAPSHOT_FIELDS,
    psrs_plan,
    psrs_run_recoverable,
    psrs_sort,
)

__all__ = ["STAGE_SNAPSHOT_FIELDS", "psrs_plan", "psrs_run_recoverable",
           "psrs_sort"]
