"""The local sort stage's share of its roofline: each key read and written
once at the card's peak bandwidth, over the device time of the operations
launched inside ``stage:sort_sample`` (kernel 1, the radix sort, and the
sampling around it), from ``torch.profiler``."""

from pemsbench.readers import roofline

UNIT, LAYER, MOVES = "%", "Kernels", "sort_keys_per_s"


def read(rec):
    return roofline(rec, "sort_sample")
