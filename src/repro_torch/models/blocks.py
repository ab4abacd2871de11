"""Per-family layer blocks of the serving path — the port of the GQA
attention, Mamba-2 (SSD) and RG-LRU blocks of ``repro/models/blocks.py``.

Every block has ``<name>_params(gen, cfg)``, ``<name>_apply`` and
``<name>_cache``.  Parameters are mappings of tensors named as in the JAX
package.  Unlike the JAX package, whose caches are immutable, the port
updates a cache **in place**: ``attn_apply`` writes the new keys and values
into ``cache["k"]``/``cache["v"]`` and ``mamba_apply`` overwrites
``cache["ssm"]``/``cache["conv"]`` and ``rglru_apply`` ``cache["h"]``/
``cache["conv"]``; each returns the same dict.  At full width a functional
copy of the KV cache per decode step would move the whole cache twice a
layer.  The MoE block comes with its family (``ROADMAP.md`` queue 1 item
10).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.lru_scan.lru_scan import lru_scan_chunked
from ..kernels.ssd_scan.ssd_scan import ssd_scan_chunked
from .layers import _init, attention, rmsnorm, rope


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matrix product."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


# =========================================================================== #
# GQA attention block                                                          #
# =========================================================================== #

def attn_params(gen: torch.Generator, cfg) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = _dtype(cfg)
    p = {
        "wq": _init(gen, (d, hq, dh), d, dt),
        "wk": _init(gen, (d, hkv, dh), d, dt),
        "wv": _init(gen, (d, hkv, dh), d, dt),
        "wo": _init(gen, (hq, dh, d), hq * dh, dt),
    }
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=gen.device)
    if cfg.qkv_bias:
        p["bq"], p["bk"], p["bv"] = zeros(hq, dh), zeros(hkv, dh), zeros(hkv, dh)
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = zeros(dh), zeros(dh)
    return p


def attn_apply(cfg, p, x: torch.Tensor, *, window: int = 0, prefix: int = 0,
               cache: Optional[dict] = None, cache_pos: Optional[int] = None,
               ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x [B, S, d] → (out [B, S, d], cache).  With a cache (``{"k","v":
    [B, Smax, Hkv, dh]}``) the new keys and values are written into it at
    ``cache_pos`` and the queries attend over its first ``cache_pos + S``
    positions."""
    b, s, _ = x.shape
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)

    offset = 0 if cache_pos is None else int(cache_pos)
    pos = offset + torch.arange(s, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)

    if cache is None:
        out = attention(q, k, v, causal=cfg.causal, window=window,
                        prefix=prefix, chunk=cfg.attn_chunk)
    else:
        if offset + s > cache["k"].shape[1]:
            raise ValueError(f"KV cache of {cache['k'].shape[1]} positions "
                             f"cannot take positions {offset}..{offset + s - 1}")
        cache["k"][:, offset:offset + s] = k
        cache["v"][:, offset:offset + s] = v
        out = attention(q, cache["k"], cache["v"], causal=cfg.causal,
                        window=window, prefix=prefix, q_offset=offset,
                        kv_valid=offset + s, chunk=cfg.attn_chunk)
    return out.flatten(2) @ p["wo"].flatten(0, 1), cache


def attn_cache(cfg, batch: int, max_seq: int, device) -> dict:
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=device)}


# =========================================================================== #
# Mamba-2 (SSD) block                                                          #
# =========================================================================== #

def mamba_params(gen: torch.Generator, cfg) -> dict:
    d, din, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = din + 2 * n
    dt = _dtype(cfg)
    dev = gen.device
    return {
        "in_proj": _init(gen, (d, 2 * din + 2 * n + h), d, dt),
        "conv_w": _init(gen, (cfg.ssm_conv, conv_dim), cfg.ssm_conv, dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "A_log": torch.zeros((h,), dtype=torch.float32, device=dev),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm_w": torch.zeros((din,), dtype=dt, device=dev),
        "out_proj": _init(gen, (din, d), din, dt),
    }


def mamba_apply(cfg, p, x: torch.Tensor, *, cache: Optional[dict] = None,
                cache_pos: Optional[int] = None,
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x [B, S, d] → (out [B, S, d], cache).  A prefill (no cache, or
    S > 1) runs the SSD scan kernel's wrapper and, with a cache, stores the
    final state and the conv window in it; a decode step (S == 1 with a
    cache) advances the cached state by one step in plain PyTorch."""
    b, s, d = x.shape
    din, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    cw = cfg.ssm_conv

    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :din]
    xBC = zxbcdt[..., din:din + din + 2 * n]
    dtv = zxbcdt[..., -h:].float()

    if cache is None or s > 1:
        # Causal depthwise conv over the sequence (prefill keeps the raw tail
        # as the next conv window).
        raw = xBC
        pad = F.pad(xBC, (0, 0, cw - 1, 0))
        xBC = sum(pad[:, i:i + s] * p["conv_w"][i] for i in range(cw))
        xBC = F.silu(xBC + p["conv_b"])
        conv_tail = (torch.cat([cache["conv"], raw], dim=1)[:, -(cw - 1):]
                     if cache is not None else None)
    else:
        # Single-step (s == 1) conv using the cached window.
        window = torch.cat([cache["conv"], xBC], dim=1)
        out = sum(window[:, i:i + 1] * p["conv_w"][i] for i in range(cw))
        conv_tail = window[:, 1:]
        xBC = F.silu(out + p["conv_b"])

    xs = xBC[..., :din].reshape(b, s, h, pd).transpose(1, 2)       # [B,H,S,P]
    Bm = xBC[..., din:din + n]
    Cm = xBC[..., din + n:]
    dtv = F.softplus(dtv + p["dt_bias"]).transpose(1, 2)           # [B,H,S]
    A = -torch.exp(p["A_log"])

    if cache is None or s > 1:
        y, new_state = ssd_scan_chunked(
            xs.float(), dtv, A, Bm.float(), Cm.float(),
            chunk=min(128, max(16, s)))
    else:
        S = cache["ssm"].float()                     # [B, H, N, P]
        dt1 = dtv[..., 0]                            # [B, H]
        decay = torch.exp(A[None] * dt1)             # [B, H]
        x1 = xs[:, :, 0].float()                     # [B, H, P]
        B1 = Bm[:, 0].float()                        # [B, N]
        C1 = Cm[:, 0].float()
        new_state = (decay[..., None, None] * S
                     + dt1[..., None, None] * B1[:, None, :, None]
                     * x1[:, :, None, :])
        y = torch.einsum("bn,bhnp->bhp", C1, new_state)[:, :, None]

    y = y + p["D"][None, :, None, None] * xs.float()
    y = y.transpose(1, 2).reshape(b, s, din).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(y, p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"]

    if cache is not None:
        cache["ssm"].copy_(new_state)
        cache["conv"].copy_(conv_tail)
    return out, cache


def mamba_cache(cfg, batch: int, device) -> dict:
    din, n = cfg.d_inner, cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, cfg.ssm_heads, n, cfg.ssm_headdim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, din + 2 * n),
                            dtype=_dtype(cfg), device=device),
    }


# =========================================================================== #
# RG-LRU recurrent block (RecurrentGemma / Griffin)                            #
# =========================================================================== #

_RG_C = 8.0
_RG_CONV = 4   # width of the block's causal depthwise conv


def rglru_params(gen: torch.Generator, cfg) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    dt = _dtype(cfg)
    dev = gen.device
    zeros = lambda dtype: torch.zeros((w,), dtype=dtype, device=dev)
    return {
        "in_x": _init(gen, (d, w), d, dt),
        "in_gate": _init(gen, (d, w), d, dt),
        "conv_w": _init(gen, (_RG_CONV, w), _RG_CONV, dt),
        "conv_b": zeros(dt),
        "w_a": _init(gen, (w, w), w, dt),
        "b_a": zeros(torch.float32),
        "w_i": _init(gen, (w, w), w, dt),
        "b_i": zeros(torch.float32),
        "lam": torch.full((w,), 2.0, dtype=torch.float32, device=dev),
        "out": _init(gen, (w, d), w, dt),
    }


def rglru_apply(cfg, p, x: torch.Tensor, *, cache: Optional[dict] = None,
                cache_pos: Optional[int] = None,
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x [B, S, d] → (out [B, S, d], cache).  A prefill (no cache, or
    S > 1) runs the LRU scan kernel's wrapper and, with a cache, stores the
    final state and the conv window in it; a decode step (S == 1 with a
    cache) advances the cached state by one step in plain PyTorch."""
    b, s, _ = x.shape
    cw = _RG_CONV
    gate = F.gelu(x @ p["in_gate"], approximate="tanh")   # jax.nn.gelu's form
    xr = x @ p["in_x"]

    if cache is None or s > 1:
        pad = F.pad(xr, (0, 0, cw - 1, 0))
        xc = sum(pad[:, i:i + s] * p["conv_w"][i] for i in range(cw))
        conv_tail = (torch.cat([cache["conv"], xr[:, -(cw - 1):]],
                               dim=1)[:, -(cw - 1):]
                     if cache is not None else None)
    else:
        window = torch.cat([cache["conv"], xr], dim=1)
        xc = sum(window[:, i:i + 1] * p["conv_w"][i] for i in range(cw))
        conv_tail = window[:, 1:]
    xc = xc + p["conv_b"]

    r = torch.sigmoid((xc @ p["w_a"]).float() + p["b_a"])
    i = torch.sigmoid((xc @ p["w_i"]).float() + p["b_i"])
    a = torch.exp(-_RG_C * F.softplus(p["lam"]) * r)
    gated_x = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * xc.float())

    if cache is None or s > 1:
        h, h_fin = lru_scan_chunked(a, gated_x, chunk=min(256, max(16, s)))
    else:
        h = a * cache["h"][:, None] + gated_x
        h_fin = h[:, -1]

    out = (h.to(x.dtype) * gate) @ p["out"]
    if cache is not None:
        cache["h"].copy_(h_fin)
        cache["conv"].copy_(conv_tail)
    return out, cache


def rglru_cache(cfg, batch: int, device) -> dict:
    w = cfg.lru_width
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, _RG_CONV - 1, w), dtype=_dtype(cfg),
                            device=device),
    }
