from .kway_merge import merge_tile_grid, sort_tile_rows
from .ops import kway_merge
from .ref import kway_merge_ref

__all__ = ["kway_merge", "kway_merge_ref", "merge_tile_grid",
           "sort_tile_rows"]
