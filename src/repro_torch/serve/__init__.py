from .engine import ServeEngine

__all__ = ["ServeEngine"]
