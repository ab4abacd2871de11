"""Shared transformer building blocks: RMSNorm, RoPE, GQA attention (with
the sliding window and the prefix-LM mask), gated MLPs — the port of
``repro/models/layers.py``.

Parameters are tensors in plain mappings (the JAX package's dicts, or the
port's :class:`repro_torch.models.model.ParamTree`).  :func:`attention` keeps
the JAX layout ``[B, S, H, d]`` and signature and runs on the flash-attention
kernel's wrapper (:func:`repro_torch.kernels.flash_attention.attend`): the
CUDA kernel on the card, its plain version on the CPU.  The projections and
the MLP stay ``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention.flash_attention import attend


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, d]; positions [..., S] (broadcastable integers)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                 # [..., S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, prefix: int = 0,
              q_offset: int = 0, kv_valid: int | None = None,
              chunk: int = 0) -> torch.Tensor:
    """GQA attention of q ``[B, Sq, Hq, d]`` over k, v ``[B, Sk, Hkv, d]``:
    query row ``i`` sits at position ``q_offset + i``, keys at or past
    ``kv_valid`` are masked, with ``causal`` so are the keys after the row's
    position but those before ``prefix`` (the JAX prefix-LM mask ``(k_pos <=
    q_pos) | (k_pos < prefix)``), and with ``window > 0`` the keys at or
    before the row's position minus ``window`` (the JAX mask ``k_pos > q_pos
    - window``).  ``chunk`` is accepted for the JAX signature: the kernel
    always streams KV tiles, so it never builds the S×S scores."""
    return attend(q, k, v, causal=causal, sk_valid=kv_valid,
                  q_offset=q_offset, window=window, prefix=prefix)


def mlp(x: torch.Tensor, p, act: str) -> torch.Tensor:
    """Gated (swiglu/geglu) or plain-gelu MLP; params:
    gated: {w_in [d, 2, ff], w_out [ff, d]}; plain: {w_in [d, 1, ff], w_out}."""
    w_in, w_out = p["w_in"], p["w_out"]
    d, gates, ff = w_in.shape
    h = (x @ w_in.reshape(d, gates * ff)).unflatten(-1, (gates, ff))
    if gates == 2:
        gate, up = h[..., 0, :], h[..., 1, :]
        g = F.silu(gate) if act == "swiglu" else F.gelu(gate, approximate="tanh")
        h = g * up
    else:
        h = F.gelu(h[..., 0, :], approximate="tanh")
    return h @ w_out


def mlp_params(gen: torch.Generator, d: int, ff: int, act: str,
               dtype: torch.dtype) -> dict:
    gates = 1 if act == "gelu" else 2
    return {
        "w_in": _init(gen, (d, gates, ff), d, dtype),
        "w_out": _init(gen, (ff, d), ff, dtype),
    }


def _init(gen: torch.Generator, shape, fan_in: int,
          dtype: torch.dtype) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights made on the generator's device."""
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.div_(math.sqrt(fan_in)).to(dtype)
