"""Qwen2.5-3B: GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B family; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_head=128,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)
