"""Kimi K2: trillion-parameter MoE, 384 experts top-8 + 1 shared expert,
first layer dense (paper-table configuration with GQA attention as
assigned).  [arXiv:2501.kimi2; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=2048,                   # per-expert FFN width
    vocab=163840,
    n_experts=384,
    top_k=8,
    n_shared_experts=1,
    first_dense_layers=1,
    moe_dense_d_ff=16384,        # dense first-layer FFN (≈ top_k·d_ff)
    source="arXiv:2501.kimi2; unverified",
)
