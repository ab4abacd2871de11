"""Mamba2-130M: attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,                   # attention-free
    n_kv_heads=0,
    d_ff=0,                      # no MLP: the mamba block is the layer
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
