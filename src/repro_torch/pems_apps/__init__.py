"""BSP applications running on the port's PEMS executor (thesis Chapter 8)."""

from .psrs import psrs_plan, psrs_sort

__all__ = ["psrs_plan", "psrs_sort"]
