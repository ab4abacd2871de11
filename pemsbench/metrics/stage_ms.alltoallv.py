"""Milliseconds a job of the Alltoallv stage (kernel 2's delivery on one
card; kernel 4's staging and the copies between cards on a mesh of cards),
from the program's drained ``stage:alltoallv`` spans."""

from pemsbench.readers import stage_ms

UNIT, LAYER, MOVES = "ms", "Collectives", "sort_keys_per_s"


def read(rec):
    return stage_ms(rec, "alltoallv")
