from .flash_attention import attend, attend_plain, flash_attention_bh
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["attend", "attend_plain", "attention_ref", "flash_attention",
           "flash_attention_bh"]
