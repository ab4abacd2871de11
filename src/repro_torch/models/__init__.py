"""The serving path's models: dense GQA transformers, Mamba-2 SSMs and the
RG-LRU/local-attention hybrid (the port of ``repro.models`` for those three
families)."""

from .model import Model

__all__ = ["Model"]
