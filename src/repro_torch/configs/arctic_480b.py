"""Snowflake Arctic: 128-expert top-2 MoE with a dense residual MLP in
parallel on every layer.  [hf:Snowflake/snowflake-arctic-base; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=4864,                   # per-expert FFN width
    vocab=32000,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    moe_dense_d_ff=4864,
    source="hf:Snowflake/snowflake-arctic-base; hf",
)
