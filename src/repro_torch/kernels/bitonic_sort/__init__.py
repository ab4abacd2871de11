from .bitonic_sort import bitonic_network, bitonic_sort_rows
from .ops import sort as bitonic_sort

__all__ = ["bitonic_network", "bitonic_sort", "bitonic_sort_rows"]
