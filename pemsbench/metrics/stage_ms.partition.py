"""Milliseconds a job of the partition stage (the splitter search and the
grouping of each context's keys into its messages), from the program's
drained ``stage:partition`` spans."""

from pemsbench.readers import stage_ms

UNIT, LAYER, MOVES = "ms", "PSRS app", "sort_keys_per_s"


def read(rec):
    return stage_ms(rec, "partition")
