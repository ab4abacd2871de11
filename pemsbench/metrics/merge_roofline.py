"""The merge stage's share of its roofline: each received key read and
written once at the card's peak bandwidth, over the device time of the
operations launched inside ``stage:merge`` (kernel 3's splitters and
segment merge), from ``torch.profiler``."""

from pemsbench.readers import roofline

UNIT, LAYER, MOVES = "%", "Kernels", "sort_keys_per_s"


def read(rec):
    return roofline(rec, "merge")
