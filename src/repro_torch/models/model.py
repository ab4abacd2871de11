"""The serving model: the port of ``repro/models/model.py`` for the ``dense``
family without experts, for ``ssm`` and for ``hybrid``.

A :class:`Model` is an ``nn.Module`` holding its weights; its layers are an
``nn.ModuleList`` run in a Python loop (the JAX package scans a stacked
pytree).  A hybrid model's layers are one flat list in the order the JAX
package runs them: each ``block_pattern`` group's blocks (``b0, b1, b2``),
group after group, then the rec layers left over (its ``extra`` stack); see
:func:`layer_kinds`.  Weights are made on the device from ``seed`` with an
explicit ``torch.Generator``, or carried over from the JAX package with
:func:`repro_torch.interop.params_from_jax`.

API (the JAX package's, with the parameters held by the module):
  init_cache(batch, max_seq) → cache
  prefill(batch, cache) → (logits_last [B, 1, V] float32, cache)
  decode(tokens, pos, cache) → (logits [B, 1, V] float32, cache)

Caches are updated in place (see :mod:`.blocks`).  Families, knobs and
methods outside the slice raise ``NotImplementedError`` naming their
``ROADMAP.md`` item.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core.context import resolve_device
from .blocks import (attn_apply, attn_cache, attn_params, mamba_apply,
                     mamba_cache, mamba_params, rglru_apply, rglru_cache,
                     rglru_params)
from .layers import _init, mlp, mlp_params, rmsnorm

_LATER = "ROADMAP.md queue 1 item 10"


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a configuration the port does not
    serve yet."""
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"({_LATER}); the port serves 'dense', 'ssm' and 'hybrid'")
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: MoE layers are not ported "
                                  f"yet ({_LATER})")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend!r} frontend "
                                  f"is not ported yet ({_LATER})")
    if cfg.is_encoder_only:
        raise NotImplementedError(f"{cfg.name} is encoder-only: no decode "
                                  "step to serve")


def layer_kinds(cfg) -> list:
    """Each layer's kind, in the order the model runs them: ``"ssm"``,
    ``"attn"`` or, for the hybrid family, ``block_pattern[i % len]`` for the
    layers of whole groups and ``"rec"`` for those left over.  A hybrid
    ``"attn"`` layer attends within ``cfg.local_window`` (the JAX package's
    ``attn_local``); a dense one sees every earlier key."""
    if cfg.family == "ssm":
        return ["ssm"] * cfg.n_layers
    if cfg.family != "hybrid":
        return ["attn"] * cfg.n_layers
    pat = cfg.block_pattern
    grouped = cfg.n_layers // len(pat) * len(pat)
    return [pat[i % len(pat)] if i < grouped else "rec"
            for i in range(cfg.n_layers)]


def init_params(cfg, gen: torch.Generator) -> Dict:
    """Random weights of ``cfg`` on ``gen``'s device, the JAX package's
    initialisation (normal / sqrt(fan_in), norms and biases zero) with the
    layer stack as a list of per-layer dicts."""
    dt = getattr(torch, cfg.dtype)
    zeros = lambda n: torch.zeros((n,), dtype=dt, device=gen.device)
    params: Dict = {
        "embed": _init(gen, (cfg.vocab, cfg.d_model), cfg.d_model, dt),
        "final_norm": zeros(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        params["head"] = _init(gen, (cfg.d_model, cfg.vocab), cfg.d_model, dt)
    layers = []
    for kind in layer_kinds(cfg):
        if kind == "ssm":
            layers.append({"ln": zeros(cfg.d_model),
                           "mamba": mamba_params(gen, cfg)})
            continue
        mixer = rglru_params(gen, cfg) if kind == "rec" else attn_params(gen, cfg)
        layers.append({
            "ln1": zeros(cfg.d_model),
            kind: mixer,
            "ln2": zeros(cfg.d_model),
            "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.act, dt),
        })
    params["layers"] = layers
    return params


class ParamTree(nn.Module):
    """Nested frozen parameters addressed like the JAX package's dicts
    (``layer["attn"]["wq"]``)."""

    def __init__(self, tree: Dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class Model(nn.Module):
    def __init__(self, cfg, *, device=None, seed: int = 0,
                 params: Optional[Dict] = None):
        """``cfg``'s model on ``device`` (CUDA unless the caller names
        another), with weights made from ``seed`` or, when given, ``params``
        (:func:`init_params`'s layout)."""
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        if params is None:
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
        self.cfg = cfg
        self.top = ParamTree(_to({k: v for k, v in params.items()
                                  if k != "layers"}, dev))
        self.layers = nn.ModuleList(ParamTree(_to(lp, dev))
                                    for lp in params["layers"])

    @property
    def device(self) -> torch.device:
        return self.top["embed"].device

    # --------------------------------------------------------------- forward
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        emb = self.top["embed"][tokens]
        if self.cfg.embed_scale:
            emb = emb * math.sqrt(self.cfg.d_model)
        return emb

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rmsnorm(x, self.top["final_norm"], cfg.norm_eps)
        w = self.top["embed"].T if cfg.tie_embeddings else self.top["head"]
        return (x @ w).float()

    def _layer(self, lp, x, cache, pos):
        cfg = self.cfg
        if "mamba" in lp:
            h, nc = mamba_apply(cfg, lp["mamba"],
                                rmsnorm(x, lp["ln"], cfg.norm_eps),
                                cache=cache, cache_pos=pos)
            return x + h, nc
        y = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if "rec" in lp:
            h, nc = rglru_apply(cfg, lp["rec"], y, cache=cache, cache_pos=pos)
        else:
            window = cfg.local_window if cfg.family == "hybrid" else 0
            h, nc = attn_apply(cfg, lp["attn"], y, window=window, cache=cache,
                               cache_pos=pos)
        x = x + h
        return x + mlp(rmsnorm(x, lp["ln2"], cfg.norm_eps), lp["mlp"],
                       cfg.act), nc

    def _run_stack(self, x, cache, pos):
        for lp, c in zip(self.layers, cache["layers"]):
            x, _ = self._layer(lp, x, c, pos)
        return x

    # ----------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_seq: int) -> Dict:
        cfg, dev = self.cfg, self.device
        one = {"ssm": lambda: mamba_cache(cfg, batch, dev),
               "rec": lambda: rglru_cache(cfg, batch, dev),
               "attn": lambda: attn_cache(cfg, batch, max_seq, dev)}
        return {"layers": [one[kind]() for kind in layer_kinds(cfg)]}

    def prefill(self, batch: Dict, cache: Dict) -> Tuple[torch.Tensor, Dict]:
        """The prompt ``batch["tokens"] [B, S]`` from position 0: fills the
        cache and returns the last position's logits."""
        x = self._run_stack(self._embed(batch["tokens"]), cache, 0)
        return self._unembed(x[:, -1:]), cache

    def decode(self, tokens: torch.Tensor, pos: int,
               cache: Dict) -> Tuple[torch.Tensor, Dict]:
        """One decode step: tokens [B, 1] at absolute position ``pos``."""
        x = self._run_stack(self._embed(tokens), cache, int(pos))
        return self._unembed(x), cache

    # ----------------------------------------------------------------- train
    def loss(self, batch):
        raise NotImplementedError(
            f"training (loss, remat, optim) is not ported yet ({_LATER})")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
