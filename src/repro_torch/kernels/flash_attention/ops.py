"""The JAX package's ``ops.flash_attention`` signature (``[B, H, S, d]``),
kept only so the parity tests can call both packages alike: no code of the
port calls it, and model code must not (the model calls
:func:`~.flash_attention.attend`).  The CUDA kernel masks its ragged edges
itself, so nothing is padded; ``use_kernel=False`` is the oracle route."""

from __future__ import annotations

import torch

from .flash_attention import attend
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    use_kernel: bool = True) -> torch.Tensor:
    """q [B, Hq, Sq, d], k/v [B, Hkv, Sk, d] → [B, Hq, Sq, d]."""
    if not use_kernel:
        return attention_ref(q, k, v, causal=causal)
    out = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=causal)
    return out.transpose(1, 2)
