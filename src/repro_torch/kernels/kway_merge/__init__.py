from .kway_merge import (exact_splitters, exact_splitters_plain,
                         merge_segments, merge_segments_plain,
                         merge_tile_grid, sort_tile_rows)
from .ops import kway_merge
from .ref import kway_merge_ref

__all__ = ["exact_splitters", "exact_splitters_plain", "kway_merge",
           "kway_merge_ref", "merge_segments", "merge_segments_plain",
           "merge_tile_grid", "sort_tile_rows"]
