"""RecurrentGemma-2B (Griffin): RG-LRU recurrent blocks + local attention,
2:1 pattern, window 2048.  [arXiv:2402.19427; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,                # MQA for the attention blocks
    d_head=256,
    d_ff=7680,
    vocab=256000,
    act="geglu",
    embed_scale=True,
    tie_embeddings=True,
    local_window=2048,
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    source="arXiv:2402.19427; hf",
)
