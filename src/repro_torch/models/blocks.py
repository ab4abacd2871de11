"""Per-family layer blocks of the serving path — the port of the GQA
attention, MoE (capacity dispatch), Mamba-2 (SSD) and RG-LRU blocks of
``repro/models/blocks.py``.

Every block has ``<name>_params(gen, cfg)``, ``<name>_apply`` and
``<name>_cache``.  Parameters are mappings of tensors named as in the JAX
package.  Unlike the JAX package, whose caches are immutable, the port
updates a cache **in place**: ``attn_apply`` writes the new keys and values
into ``cache["k"]``/``cache["v"]`` and ``mamba_apply`` overwrites
``cache["ssm"]``/``cache["conv"]`` and ``rglru_apply`` ``cache["h"]``/
``cache["conv"]``; each returns the same dict.  At full width a functional
copy of the KV cache per decode step would move the whole cache twice a
layer.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.lru_scan.lru_scan import lru_scan_chunked
from ..kernels.ssd_scan.ssd_scan import ssd_scan_chunked
from .layers import _init, attention, mlp, mlp_params, rmsnorm, rope


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
# MoE block — PEMS-style capacity dispatch                                     #
# =========================================================================== #
#
# The experts are the thesis' virtual processors: each group's tokens are
# bucketed by destination expert under a capacity ω (``cap``), delivered
# straight into per-expert buffers, processed expert by expert (one batched
# matrix product over the experts) and combined back; tokens past the
# capacity are dropped.  The JAX package does all of it in plain XLA, no
# Pallas kernel, so the port keeps it plain PyTorch: a stable sort,
# ``searchsorted``, gathers and ``torch.bmm``.

def _init_experts(gen: torch.Generator, shape, fan_in: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """:func:`~.layers._init` of an ``[E, ...]`` expert stack, made one
    expert at a time into a preallocated ``dtype`` tensor: at full width a
    stack made whole in float32 first would not fit beside the model (kimi's
    ``w_in`` is 11.3 G elements)."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for e in range(shape[0]):
        out[e] = _init(gen, shape[1:], fan_in, dtype)
    return out


def moe_params(gen: torch.Generator, cfg) -> dict:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    dt = _dtype(cfg)
    gates = 1 if cfg.act == "gelu" else 2
    p = {
        "router": _init(gen, (d, e), d, torch.float32),
        "w_in": _init_experts(gen, (e, d, gates, ff), d, dt),
        "w_out": _init_experts(gen, (e, ff, d), ff, dt),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_params(gen, d, cfg.d_ff * cfg.n_shared_experts,
                                 cfg.act, dt)
    if cfg.moe_dense_residual:
        p["dense"] = mlp_params(gen, d, cfg.moe_dense_d_ff or cfg.d_ff,
                                cfg.act, dt)
    return p


def moe_groups(cfg, t: int, n_groups: int = 0) -> Tuple[int, int, int]:
    """``(n_groups, tg, cap)`` for ``t`` tokens, as the JAX ``moe_apply``
    picks them: ``n_groups`` (``cfg.moe_groups`` unless given) reduced until
    it divides ``t``, ``tg = t / n_groups`` tokens a group and the capacity
    ``max(1, ceil(tg·K/E·capacity_factor))`` slots an expert a group."""
    n_groups = n_groups or getattr(cfg, "moe_groups", 1) or 1
    n_groups = min(n_groups, t)
    while t % n_groups:
        n_groups -= 1
    tg = t // n_groups
    cap = max(1, int(math.ceil(tg * cfg.top_k / cfg.n_experts
                               * cfg.capacity_factor)))
    return n_groups, tg, cap


def _top_k(logits: torch.Tensor, k: int):
    """``lax.top_k``: the ``k`` largest along the last axis, descending, the
    lower index first among equal values (``torch.topk`` promises no order
    among them)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_dispatch(cfg, router: torch.Tensor, xg: torch.Tensor,
                 cap: int) -> dict:
    """The JAX ``group_dispatch`` of every group at once: ``xg [G, tg, d]``
    → the routing and the dispatch indices, named as in the JAX package,
    each with a leading group dim.  ``sel``/``weights`` ``[G, tg, K]``: the
    top-K experts of each token from its float32 router logits and the
    softmax over the K chosen; ``aux [G]``, the load-balance loss; over the
    ``tg·K`` (token, choice) entries sorted stably by expert (``order``):
    ``se`` the expert, ``pos_c`` the slot (``pos = i - start[se]`` clamped
    to ``cap - 1``), ``keep = pos < cap``, ``tok_sorted`` the token and
    ``w_sorted`` the gate weight.  The integers equal the JAX package's bit
    for bit.  ``served``: the entries whose slot still holds their token
    after the JAX scatter ``xe.at[se, pos_c].set(src)``, in the order XLA
    keeps on the CPU, where the last write to a slot wins: every dropped
    entry writes zeros to its expert's slot ``cap - 1`` after the kept
    entry there, so an expert past its capacity serves only its first
    ``cap - 1`` entries (each expert's last entry writes that slot
    last)."""
    g, tg, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = xg.float() @ router                                # [G, tg, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, sel = _top_k(logits, k)                          # [G, tg, K]
    weights = torch.softmax(gate_vals, dim=-1)

    density = F.one_hot(sel[..., 0], e).float().mean(dim=1)     # [G, E]
    aux = e * (density * probs.mean(dim=1)).sum(dim=-1)         # [G]

    flat_e = sel.reshape(g, tg * k)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    se = flat_e.gather(1, order)
    start = torch.searchsorted(
        se, torch.arange(e, device=xg.device).expand(g, e).contiguous())
    pos = torch.arange(tg * k, device=xg.device) - start.gather(1, se)
    keep = pos < cap
    last = torch.ones_like(keep)
    last[:, :-1] = se[:, 1:] != se[:, :-1]      # the expert's last entry
    return dict(sel=sel, weights=weights, aux=aux, order=order, se=se,
                pos_c=pos.clamp(max=cap - 1), keep=keep,
                served=keep & ((pos < cap - 1) | last), tok_sorted=order // k,
                w_sorted=weights.reshape(g, tg * k).gather(1, order))


def _experts(cfg, p, xe: torch.Tensor) -> torch.Tensor:
    """The grouped expert MLP: ``xe [E, n, d]`` → ``[E, n, d]``, one batched
    matrix product a projection (``einsum("gecd,edGf->gecGf")`` and
    ``("gecf,efd->gecd")`` in the JAX package)."""
    w_in, w_out = p["w_in"], p["w_out"]
    e, d, gates, ff = w_in.shape
    h = torch.bmm(xe, w_in.view(e, d, gates * ff)).unflatten(-1, (gates, ff))
    if gates == 2:
        gate = (F.silu(h[..., 0, :]) if cfg.act == "swiglu"
                else F.gelu(h[..., 0, :], approximate="tanh"))
        h = gate * h[..., 1, :]
    else:
        h = F.gelu(h[..., 0, :], approximate="tanh")
    return torch.bmm(h, w_out)


def moe_apply(cfg, p, x: torch.Tensor,
              n_groups: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] → (out [B, S, d], aux load-balance loss): the JAX
    ``moe_apply``.  Tokens are cut into ``n_groups`` groups
    (:func:`moe_groups`); each group bucketises its tokens by expert under
    the capacity ``cap`` (:func:`moe_dispatch`), the experts run on their
    ``[E, G·cap, d]`` buffers, and each token's K contributions come back
    weighted, dropped entries weighing 0.

    Two writes the JAX package leaves to XLA's order are made
    deterministic here, in the order XLA keeps on the CPU:

    - the dispatch ``xe.at[se, pos_c].set(src)``: only the ``served``
      entries' rows are written (:func:`moe_dispatch`); an expert past its
      capacity keeps its last slot zero, so the kept token there gets the
      expert's output of zeros, as in the JAX package;
    - the combine ``.at[tok].add``: a token's K contributions are summed in
      the sorted order (ascending expert) in the model's dtype, one after
      the other from zero, never by an ``index_add_`` whose order on CUDA
      changes from run to run."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n_groups, tg, cap = moe_groups(cfg, b * s, n_groups)
    xg = x.reshape(n_groups, tg, d)
    r = moe_dispatch(cfg, p["router"], xg, cap)

    # Dispatch: slot (expert se, group g, pos_c) is row se·G·cap + g·cap +
    # pos_c of the expert buffers; entries that write no slot go to one
    # spare row past them, dropped after.
    group = torch.arange(n_groups, device=x.device)[:, None]
    slot = r["se"] * (n_groups * cap) + group * cap + r["pos_c"]  # [G, tg·K]
    spare = e * n_groups * cap
    xe = x.new_zeros((spare + 1, d))
    src = xg.gather(1, r["tok_sorted"][..., None].expand(-1, -1, d))
    xe[torch.where(r["served"], slot, spare).flatten()] = src.flatten(0, 1)
    ye = _experts(cfg, p, xe[:spare].view(e, n_groups * cap, d))
    ye = ye.reshape(spare, d)

    # Combine: entry i of the sorted order weighs w_sorted·keep (in x's
    # dtype, as JAX casts it); each token's K entries in their sorted order.
    wk = (r["w_sorted"] * r["keep"]).to(x.dtype)
    inv = torch.empty_like(r["order"])
    inv.scatter_(1, r["order"], torch.arange(tg * k, device=x.device)
                 .expand(n_groups, -1).contiguous())
    mine = inv.view(n_groups, tg, k).sort(dim=-1).values       # [G, tg, K]
    y = x.new_zeros((n_groups, tg, d))
    for j in range(k):
        i = mine[..., j]
        y = y + ye[slot.gather(1, i)] * wk.gather(1, i)[..., None]
    y = y.reshape(b, s, d)

    if "shared" in p:
        y = y + mlp(x, p["shared"], cfg.act)
    if "dense" in p:
        y = y + mlp(x, p["dense"], cfg.act)
    return y.to(x.dtype), r["aux"].mean()


def moe_apply_dense_oracle(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """The JAX ``moe_apply_dense_oracle``: every token through every expert
    (O(E) compute; checks only), combined with its top-K gate weights and no
    capacity."""
    b, s, d = x.shape
    e = cfg.n_experts
    xf = x.reshape(-1, d)
    logits = xf.float() @ p["router"]
    gate_vals, sel = _top_k(logits, cfg.top_k)
    weights = torch.softmax(gate_vals, dim=-1)
    ye = _experts(cfg, p, xf.expand(e, -1, -1))                 # [E, T, d]
    comb = torch.zeros(logits.shape, dtype=ye.dtype, device=x.device)
    comb.scatter_(1, sel, weights.to(ye.dtype))
    y = torch.einsum("te,etd->td", comb, ye).reshape(b, s, d)
    if "shared" in p:
        y = y + mlp(x, p["shared"], cfg.act)
    if "dense" in p:
        y = y + mlp(x, p["dense"], cfg.act)
    return y.to(x.dtype)


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
