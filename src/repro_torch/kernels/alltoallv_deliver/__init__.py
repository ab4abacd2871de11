from .alltoallv_deliver import deliver_tiles, deliver_words, \
    deliver_words_plain
from .ops import check_fill_range, deliver, deliver_fused

__all__ = ["check_fill_range", "deliver", "deliver_fused", "deliver_tiles",
           "deliver_words", "deliver_words_plain"]
