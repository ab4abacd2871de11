from .ops import ssd_scan
from .ref import ssd_scan_ref
from .ssd_scan import (ssd_backward_plain, ssd_chunked_plain,
                       ssd_scan_backward, ssd_scan_chunked)

__all__ = ["ssd_backward_plain", "ssd_chunked_plain", "ssd_scan",
           "ssd_scan_backward", "ssd_scan_chunked", "ssd_scan_ref"]
