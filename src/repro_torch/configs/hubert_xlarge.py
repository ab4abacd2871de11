"""HuBERT-XLarge: encoder-only audio transformer; the conv feature extractor
is a stub (input_specs provides frame embeddings).  [arXiv:2106.07447]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,               # full MHA
    d_head=80,
    d_ff=5120,
    vocab=504,                   # masked-prediction cluster targets
    causal=False,                # encoder-only: no decode shapes
    act="gelu",
    frontend="frames",
    source="arXiv:2106.07447; unverified",
)
