"""PaliGemma-3B: SigLIP patch frontend (stub) + Gemma-2B decoder backbone.
[arXiv:2407.07726; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,                # MQA
    d_head=256,                  # gemma uses wide heads
    d_ff=16384,
    vocab=257216,
    act="geglu",
    embed_scale=True,
    tie_embeddings=True,
    frontend="patches",
    n_frontend_tokens=256,       # 224×224 / 14² SigLIP patches
    source="arXiv:2407.07726; hf",
)
