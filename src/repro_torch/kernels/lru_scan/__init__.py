from .lru_scan import (lru_backward_plain, lru_chunked_plain, lru_scan_backward,
                       lru_scan_chunked)
from .ops import lru_scan
from .ref import lru_scan_ref

__all__ = ["lru_backward_plain", "lru_chunked_plain", "lru_scan",
           "lru_scan_backward", "lru_scan_chunked", "lru_scan_ref"]
