"""Model configuration: the port's own copy of the JAX package's
``configs/base.py`` (the port imports nothing of ``repro``).

One frozen dataclass covers all ten assigned architecture families; each
``configs/<arch>.py`` instantiates it with the exact published numbers.
``smoke()`` derives the reduced same-family variant used by CPU smoke tests.
The input shapes (``SHAPES``, ``applicable_shapes``, ``skip_reason``) come
with the train and dry-run slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 → d_model // n_heads

    # attention
    qkv_bias: bool = False
    qk_norm: bool = False
    causal: bool = True          # False → encoder-only (no decode step)
    rope_theta: float = 10_000.0
    local_window: int = 0        # >0 → sliding-window attention
    act: str = "swiglu"          # swiglu | geglu
    embed_scale: bool = False    # gemma: scale embeddings by sqrt(d)
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN parallel to MoE
    first_dense_layers: int = 0       # kimi/deepseek: leading dense layers
    capacity_factor: float = 1.25
    moe_dense_d_ff: int = 0           # d_ff of dense layers/residual (0 → d_ff)
    moe_groups: int = 1               # hierarchical dispatch groups (= DP shards)

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4

    # hybrid (recurrentgemma)
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0

    # modality frontend (stubbed: input_specs provides embeddings)
    frontend: str = "none"       # none | patches | frames
    n_frontend_tokens: int = 0

    # numerics / execution
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    attn_chunk: int = 1024       # kv/q chunking for the streaming attention
    remat: str = "layer"         # none | layer
    unroll_layers: bool = False  # python-loop layers (cost-model probes)
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests: small widths,
        few layers/experts, tiny vocab — same code paths."""
        pattern = self.block_pattern[: 3] if self.block_pattern else ()
        n_layers = (len(pattern) + 1) if pattern else 2
        if self.first_dense_layers:
            n_layers = max(n_layers, 2)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_head=16,
            d_ff=128,
            moe_dense_d_ff=128 if self.moe_dense_d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            # No token dropping in smoke tests (the JAX package exercises
            # capacity effects separately).
            capacity_factor=8.0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else self.ssm_headdim,
            lru_width=64 if self.lru_width else 0,
            block_pattern=pattern,
            n_frontend_tokens=8 if self.n_frontend_tokens else 0,
            local_window=min(self.local_window, 16) if self.local_window else 0,
            attn_chunk=32,
            dtype="float32",
        )
