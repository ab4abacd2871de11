from .alltoallv_deliver import assemble_proc_tiles, assemble_words, \
    assemble_words_plain, deliver_tiles, deliver_words, deliver_words_plain
from .ops import assemble_proc_fused, check_fill_range, deliver, \
    deliver_fused

__all__ = ["assemble_proc_fused", "assemble_proc_tiles", "assemble_words",
           "assemble_words_plain", "check_fill_range", "deliver",
           "deliver_fused", "deliver_tiles", "deliver_words",
           "deliver_words_plain"]
