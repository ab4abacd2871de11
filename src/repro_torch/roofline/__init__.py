from .analyze import HW, collective_bytes, roofline_terms

__all__ = ["HW", "collective_bytes", "roofline_terms"]
