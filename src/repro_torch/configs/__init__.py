"""Architecture config registry: ``get_config(name)`` / ``--arch <id>``.

The port's own copy of the JAX package's registry, with the same ten
architectures and names; :class:`repro_torch.models.Model` raises for the
families it does not run yet.
"""

from .base import (SHAPES, ModelConfig, ShapeConfig, applicable_shapes,
                   skip_reason)

from .paligemma_3b import CONFIG as _paligemma
from .qwen2_1_5b import CONFIG as _qwen2
from .qwen2_5_3b import CONFIG as _qwen25
from .yi_6b import CONFIG as _yi
from .qwen3_14b import CONFIG as _qwen3
from .hubert_xlarge import CONFIG as _hubert
from .recurrentgemma_2b import CONFIG as _rgemma
from .kimi_k2 import CONFIG as _kimi
from .arctic_480b import CONFIG as _arctic
from .mamba2_130m import CONFIG as _mamba2

REGISTRY = {
    c.name: c
    for c in [
        _paligemma, _qwen2, _qwen25, _yi, _qwen3,
        _hubert, _rgemma, _kimi, _arctic, _mamba2,
    ]
}

ARCH_NAMES = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return REGISTRY[name]


__all__ = ["ARCH_NAMES", "ModelConfig", "REGISTRY", "SHAPES", "ShapeConfig",
           "applicable_shapes", "get_config", "skip_reason"]
