"""The model: the port of ``repro/models/model.py``.  It serves every family
with a decode step (``dense``, ``moe``, ``ssm``, ``hybrid`` and ``vlm``, the
patches frontend) and trains every family (those and ``audio``, the frames
frontend): kernel 5's gradient is kernel 5b, the SSD scan's (kernel 6) is
kernel 6b and the RG-LRU scan's (kernel 7) is kernel 7b.

A :class:`Model` is an ``nn.Module`` holding its weights; its layers are an
``nn.ModuleList`` run in a Python loop (the JAX package scans a stacked
pytree).  The layers are one flat list in the order the JAX package runs
them: an MoE model's leading dense layers (its ``dense0`` stack) and then
its MoE layers; a hybrid model's ``block_pattern`` groups' blocks (``b0,
b1, b2``), group after group, then the rec layers left over (its ``extra``
stack); see :func:`layer_kinds`.  Weights are made on the device from
``seed`` with an explicit ``torch.Generator``, or carried over from the JAX
package with :func:`repro_torch.interop.params_from_jax`.

API (the JAX package's, with the parameters held by the module):
  loss(batch) → (loss, {"ce", "aux"})      train forward
  logits(batch) → (logits [B, S, V] float32, aux)
  init_cache(batch, max_seq) → cache
  prefill(batch, cache) → (logits_last [B, 1, V] float32, cache)
  decode(tokens, pos, cache) → (logits [B, 1, V] float32, cache)
  params() → the parameters as :func:`init_params` lays them out

A patches model takes ``batch["patches"]`` ``[B, n_frontend_tokens, d]``
(the stubbed frontend's embeddings) before the tokens and attends over them
with the prefix-LM mask; a frames model (hubert) takes ``batch["frames"]``
``[B, S, d]`` through ``frontend_proj`` and, in training, ``batch["labels"]
[B, S]``.  Caches are updated in place (see :mod:`.blocks`).  Serving an
encoder-only model raises (no decode step).

The weights are made with ``requires_grad=False``; the training step
(:func:`repro_torch.train.init_train_state`) makes them trainable.  With
``cfg.remat == "layer"`` a training forward checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant), so the backward reruns the
layer's forward, kernels 5, 6 and 7 included, as ``jax.checkpoint`` does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.context import resolve_device
from .blocks import (attn_apply, attn_cache, attn_params, mamba_apply,
                     mamba_cache, mamba_params, moe_apply, moe_params,
                     rglru_apply, rglru_cache, rglru_params)
from .layers import _init, mlp, mlp_params, rmsnorm

def check_servable(cfg) -> None:
    """Raise ``NotImplementedError`` for a configuration with no decode step
    (encoder-only hubert, which ``repro/launch/serve.py`` refuses too)."""
    if cfg.is_encoder_only:
        raise NotImplementedError(f"{cfg.name} is encoder-only: no decode "
                                  "step to serve")


def layer_kinds(cfg) -> list:
    """Each layer's kind, in the order the model runs them: ``"ssm"``,
    ``"attn"`` (attention and an MLP), ``"moe"`` (attention and the MoE
    block: an MoE model's layers after its ``first_dense_layers``) or, for
    the hybrid family, ``block_pattern[i % len]`` for the layers of whole
    groups and ``"rec"`` for those left over.  A hybrid ``"attn"`` layer
    attends within ``cfg.local_window`` (the JAX package's ``attn_local``);
    the others see every earlier key."""
    if cfg.family == "ssm":
        return ["ssm"] * cfg.n_layers
    if cfg.is_moe:
        n_dense = min(cfg.first_dense_layers, cfg.n_layers)
        return ["attn"] * n_dense + ["moe"] * (cfg.n_layers - n_dense)
    if cfg.family != "hybrid":
        return ["attn"] * cfg.n_layers
    pat = cfg.block_pattern
    grouped = cfg.n_layers // len(pat) * len(pat)
    return [pat[i % len(pat)] if i < grouped else "rec"
            for i in range(cfg.n_layers)]


def layer_stacks(cfg) -> list:
    """The JAX package's layer stacks, ``[(keys, layer indices), ...]`` in
    its tree's order: the key path of each stacked leaf group in the JAX
    tree (``("layers",)``; an MoE model's leading dense layers
    ``("dense0",)``; a hybrid model's ``("layers", "b<j>")`` over its
    groups and ``("extra",)``) and the indices of the port's layers it
    stacks, in stack order."""
    n = cfg.n_layers
    if cfg.family == "hybrid":
        p = len(cfg.block_pattern)
        grouped = n // p * p
        out = [(("layers", f"b{j}"), list(range(j, grouped, p)))
               for j in range(p)]
        return out + ([(("extra",), list(range(grouped, n)))]
                      if grouped < n else [])
    if cfg.family != "ssm" and cfg.first_dense_layers:
        k = cfg.first_dense_layers
        return [(("dense0",), list(range(k))), (("layers",),
                                                 list(range(k, n)))]
    return [(("layers",), list(range(n)))]


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
    if cfg.frontend == "frames":
        params["frontend_proj"] = _init(gen, (cfg.d_model, cfg.d_model),
                                        cfg.d_model, dt)
    layers = []
    for kind in layer_kinds(cfg):
        if kind == "ssm":
            layers.append({"ln": zeros(cfg.d_model),
                           "mamba": mamba_params(gen, cfg)})
            continue
        if kind == "rec":
            layer = {"ln1": zeros(cfg.d_model), "rec": rglru_params(gen, cfg),
                     "ln2": zeros(cfg.d_model),
                     "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                       dt)}
        else:
            layer = {"ln1": zeros(cfg.d_model), "attn": attn_params(gen, cfg),
                     "ln2": zeros(cfg.d_model)}
            if kind == "moe":
                layer["moe"] = moe_params(gen, cfg)
            else:   # a transformer layer's MLP: moe_dense_d_ff where set
                layer["mlp"] = mlp_params(gen, cfg.d_model,
                                          cfg.moe_dense_d_ff or cfg.d_ff,
                                          cfg.act, dt)
        layers.append(layer)
    params["layers"] = layers
    return params


def meta_params(cfg) -> Dict:
    """:func:`init_params`' nest for ``cfg`` on the ``meta`` device: the
    shapes and dtypes without storage, traced as the dry run traces them
    (the ``like`` of a checkpoint restore that must not build the
    weights)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..tree import map_tree
    with FakeTensorMode():
        fake = init_params(cfg, torch.Generator())
    return map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), fake)


def make_cache(cfg, batch: int, max_seq: int, device) -> Dict:
    """Every layer's cache for ``batch`` sequences of ``max_seq`` positions
    on ``device`` (:meth:`Model.init_cache` after its check that the model
    has a decode step; the dry run's prefill of an encoder-only model takes
    it directly, as the JAX package's does)."""
    one = {"ssm": lambda: mamba_cache(cfg, batch, device),
           "rec": lambda: rglru_cache(cfg, batch, device),
           "attn": lambda: attn_cache(cfg, batch, max_seq, device),
           "moe": lambda: attn_cache(cfg, batch, max_seq, device)}
    return {"layers": [one[kind]() for kind in layer_kinds(cfg)]}


class ParamTree(nn.Module):
    """Nested parameters addressed like the JAX package's dicts
    (``layer["attn"]["wq"]``), frozen until training asks for gradients."""

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

    def tree(self) -> Dict:
        """The parameters as a nested dict (the module's own tensors)."""
        out = dict(self._parameters)
        out.update((k, m.tree()) for k, m in self._modules.items())
        return out


class Model(nn.Module):
    def __init__(self, cfg, *, device=None, seed: int = 0,
                 params: Optional[Dict] = None):
        """``cfg``'s model on ``device`` (CUDA unless the caller names
        another), with weights made from ``seed`` or, when given, ``params``
        (:func:`init_params`'s layout)."""
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
        self.cfg = cfg
        self.top = ParamTree(_to({k: v for k, v in params.items()
                                  if k != "layers"}, dev))
        self.layers = nn.ModuleList(ParamTree(_to(lp, dev))
                                    for lp in params["layers"])
        # Applied to the residual stream before every layer and before the
        # final norm when set (the JAX package's ``act_constraint``, which
        # its layer scan applies to each layer's input): the dry run pins
        # the activations to the data axes with it.
        self.act_constraint = None

    @property
    def device(self) -> torch.device:
        return self.top["embed"].device

    def params(self) -> Dict:
        """The model's parameters (its own tensors, not copies) laid out as
        :func:`init_params` makes them: the top-level weights and
        ``"layers"``, a list of per-layer dicts."""
        return {**self.top.tree(), "layers": [lp.tree() for lp in self.layers]}

    # --------------------------------------------------------------- forward
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        emb = self.top["embed"][tokens]
        if self.cfg.embed_scale:
            emb = emb * math.sqrt(self.cfg.d_model)
        return emb

    def _embed_inputs(self, batch: Dict) -> Tuple[torch.Tensor, int]:
        """``(x [B, S, d], prefix)``: a frames model's ``frames [B, S, d]``
        through ``frontend_proj``; else the token embeddings, after the
        ``patches`` ``[B, n_frontend_tokens, d]`` where a patches model is
        given them (then ``prefix`` is ``n_frontend_tokens``, else 0)."""
        cfg = self.cfg
        if cfg.frontend == "frames":
            dt = self.top["frontend_proj"].dtype
            return batch["frames"].to(dt) @ self.top["frontend_proj"], 0
        emb = self._embed(batch["tokens"])
        if cfg.frontend != "patches" or "patches" not in batch:
            return emb, 0
        patches = batch["patches"]
        want = (emb.shape[0], cfg.n_frontend_tokens, cfg.d_model)
        if tuple(patches.shape) != want:
            raise ValueError(f"{cfg.name}: patches must be {list(want)}, got "
                             f"{list(patches.shape)}")
        return (torch.cat([patches.to(emb.dtype), emb], dim=1),
                cfg.n_frontend_tokens)

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if self.act_constraint is not None:
            x = self.act_constraint(x)
        x = rmsnorm(x, self.top["final_norm"], cfg.norm_eps)
        w = self.top["embed"].T if cfg.tie_embeddings else self.top["head"]
        return (x @ w).float()

    def _layer(self, lp, x, cache, pos, prefix: int = 0):
        """One layer: ``(x, cache, aux)``, aux the MoE block's load-balance
        loss (None for other layers)."""
        cfg = self.cfg
        if "mamba" in lp:
            h, nc = mamba_apply(cfg, lp["mamba"],
                                rmsnorm(x, lp["ln"], cfg.norm_eps),
                                cache=cache, cache_pos=pos)
            return x + h, nc, None
        y = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if "rec" in lp:
            h, nc = rglru_apply(cfg, lp["rec"], y, cache=cache, cache_pos=pos)
        else:
            window = cfg.local_window if cfg.family == "hybrid" else 0
            h, nc = attn_apply(cfg, lp["attn"], y, window=window,
                               prefix=prefix, cache=cache, cache_pos=pos)
        x = x + h
        y = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        if "moe" in lp:
            h2, aux = moe_apply(cfg, lp["moe"], y)
            return x + h2, nc, aux
        return x + mlp(y, lp["mlp"], cfg.act), nc, None

    def _run_stack(self, x, cache, pos, prefix: int = 0):
        for lp, c in zip(self.layers, cache["layers"]):
            if self.act_constraint is not None:
                x = self.act_constraint(x)
            x, _, _ = self._layer(lp, x, c, pos, prefix)
        return x

    def _train_stack(self, x, prefix: int = 0):
        """Every layer without a cache: ``(x, aux)``, aux the MoE layers'
        load-balance losses summed in float32 (0 without MoE).  Under
        ``remat == "layer"`` and autograd each layer is checkpointed."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = self.cfg.remat == "layer" and torch.is_grad_enabled()
        for lp in self.layers:
            if self.act_constraint is not None:
                x = self.act_constraint(x)

            def one(x, lp=lp):
                x, _, a = self._layer(lp, x, None, None, prefix)
                return x, (a if a is not None else torch.zeros_like(aux))
            x, a = (checkpoint(one, x, use_reentrant=False) if remat
                    else one(x))
            aux = aux + a
        return x, aux

    # ----------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_seq: int) -> Dict:
        check_servable(self.cfg)
        return make_cache(self.cfg, batch, max_seq, self.device)

    def prefill(self, batch: Dict, cache: Dict) -> Tuple[torch.Tensor, Dict]:
        """The prompt ``batch["tokens"] [B, S]`` from position 0, after
        ``batch["patches"]`` for a patches model (the prefix-LM mask over
        them): fills the cache and returns the last position's logits."""
        x, prefix = self._embed_inputs(batch)
        x = self._run_stack(x, cache, 0, prefix)
        return self._unembed(x[:, -1:]), cache

    def decode(self, tokens: torch.Tensor, pos: int,
               cache: Dict) -> Tuple[torch.Tensor, Dict]:
        """One decode step: tokens [B, 1] at absolute position ``pos``."""
        x = self._run_stack(self._embed(tokens), cache, int(pos))
        return self._unembed(x), cache

    # ----------------------------------------------------------------- train
    def logits(self, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(logits [B, S, V] float32, aux)`` of a training batch."""
        x, prefix = self._embed_inputs(batch)
        x, aux = self._train_stack(x, prefix)
        return self._unembed(x), aux

    def loss(self, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """``(loss, {"ce", "aux"})``, the JAX ``Model.loss``: the cross
        entropy over ``labels`` (frames), over the text positions after the
        patches (patches), else of each token's next; plus ``1e-2`` times
        the MoE layers' summed load-balance loss."""
        cfg = self.cfg
        if cfg.frontend == "patches" and "patches" not in batch:
            raise ValueError(f"{cfg.name} trains on {cfg.n_frontend_tokens} "
                             "patch embeddings before the tokens: the batch "
                             f"needs 'patches' [B, {cfg.n_frontend_tokens}, "
                             f"{cfg.d_model}]")
        logits, aux = self.logits(batch)
        if cfg.frontend == "frames":
            ce = _xent(logits, batch["labels"]).mean()
        else:
            tokens = batch["tokens"]
            txt = (logits[:, cfg.n_frontend_tokens:]
                   if cfg.frontend == "patches" else logits)
            ce = _xent(txt[:, :-1], tokens[:, 1:]).mean()
        return ce + 1e-2 * aux, {"ce": ce, "aux": aux}


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position cross entropy of float32 ``logits [..., V]`` against
    ``labels [...]``: ``logsumexp - gold``.  No softmax copy is kept beyond
    what autograd saves of the logits (at qwen2-1.5b's full vocabulary the
    float32 logits of a batch of 8 × 1024 are 5.0 GB)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return logz - gold


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
