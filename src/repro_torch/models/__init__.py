"""The serving path's models: dense GQA transformers and Mamba-2 SSMs (the
port of ``repro.models`` for those two families)."""

from .model import Model

__all__ = ["Model"]
