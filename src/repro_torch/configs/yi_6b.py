"""Yi-6B: llama-architecture GQA. [arXiv:2403.04652; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=11008,
    vocab=64000,
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652; hf",
)
