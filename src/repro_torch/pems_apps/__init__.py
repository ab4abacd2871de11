"""BSP applications running on the port's PEMS executor (thesis Chapter 8)."""

from .psrs import (
    STAGE_SNAPSHOT_FIELDS,
    psrs_plan,
    psrs_run_recoverable,
    psrs_sort,
)
from .prefix_sum import prefix_sum
from .list_ranking import list_rank
from .euler_tour import euler_tour

__all__ = ["STAGE_SNAPSHOT_FIELDS", "psrs_plan", "psrs_run_recoverable",
           "psrs_sort", "prefix_sum", "list_rank", "euler_tour"]
