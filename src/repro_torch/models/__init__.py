"""The models: dense GQA transformers, MoE, Mamba-2 SSMs, the RG-LRU/local-
attention hybrid and the patches and frames frontends (the port of
``repro.models``), served and, but for ssm and hybrid, trained."""

from .model import Model

__all__ = ["Model"]
