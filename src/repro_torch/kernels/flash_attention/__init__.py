from .flash_attention import (attend, attend_backward, attend_backward_plain,
                              attend_plain, attend_plain_with_lse,
                              attend_with_lse, flash_attention_bh)
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["attend", "attend_backward", "attend_backward_plain",
           "attend_plain", "attend_plain_with_lse", "attend_with_lse",
           "attention_ref", "flash_attention", "flash_attention_bh"]
