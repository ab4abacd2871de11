"""Training step: microbatch accumulation, optional int8 error-feedback
gradient compression, AdamW, cosine schedule — the port of
``repro/train/train_step.py``.

The microbatches are the PEMS pattern at the training level: one round's
activations at a time, the gradients summed into an ``accum_dtype``
accumulator (the carried context).  Gradients come from
``torch.autograd.grad`` of the model's loss with respect to every parameter
leaf; a leaf the loss does not reach (a frames model's ``embed``) gets zeros,
as ``jax.grad`` gives it, so AdamW still decays it and the global norm sums
over every leaf.

The state's parameters are the model's own tensors: the step updates them,
the moments and the error-feedback residuals in place (see
:mod:`repro_torch.optim.adamw`).  :class:`TrainState` is a ``NamedTuple`` so
the port's ``CheckpointManager`` keys its leaves ``.params[...]``,
``.opt[...]`` and ``.ef[...]`` as ``jax.tree_util.keystr`` does for the JAX
package's dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..models.model import layer_stacks
from ..optim import OptConfig, adamw_init, adamw_update, cosine_schedule
from ..tree import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_compress: bool = False   # int8 + error feedback on the DP reduce
    accum_dtype: str = "float32"  # bf16 halves the accumulator for T-param MoE


class TrainState(NamedTuple):
    params: Any
    opt: Dict
    ef: Optional[Any]            # error-feedback residuals (compression)


def init_train_state(params, tcfg: TrainConfig) -> TrainState:
    """The state of step 0 over ``params`` (a model's
    :meth:`~repro_torch.models.Model.params`), which it makes trainable
    (``requires_grad``): zero moments and, with ``grad_compress``, zero
    float32 residuals."""
    for p in leaves(params):
        p.requires_grad_(True)
    ef = (map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
          if tcfg.grad_compress else None)
    return TrainState(params=params, opt=adamw_init(params, tcfg.opt), ef=ef)


@torch.no_grad()
def load_train_state_(state: TrainState, got: TrainState) -> TrainState:
    """Copy the leaves of ``got`` (a restored checkpoint) into ``state``'s
    tensors, the model's parameters among them; returns ``state``."""
    for dst, src in zip(leaves(state), leaves(got)):
        dst.copy_(src)
    return state


def _compress_ef(grads, ef, block: int = 2048, stacks=()):
    """int8 blockwise quantization with error feedback: the residual of each
    round is added back next round, so compression error does not
    accumulate (what the DP all-reduce would carry on the wire).  Returns
    the dequantized gradients (each in its gradient's dtype); ``ef`` is
    updated in place.  A leaf's blocks of ``block`` elements run over it
    flattened; ``stacks`` (:func:`~repro_torch.models.model.layer_stacks`)
    names the layers of ``grads["layers"]`` that the JAX package stacks
    into one leaf, whose blocks run over the stack (layer after layer), so
    a block may straddle two layers as it does there."""
    def one(gs, es):
        x = torch.cat([(g.float() + e).reshape(-1) for g, e in zip(gs, es)])
        n = x.numel()
        nb = -(-n // block)
        flat = torch.nn.functional.pad(x, (0, nb * block - n)).reshape(
            nb, block)
        scale = flat.abs().amax(dim=1)
        safe = torch.where(scale == 0.0, 1.0, scale)
        q = torch.round(torch.clamp(flat / safe[:, None] * 127.0, -127, 127))
        deq = (q * safe[:, None] / 127.0).reshape(-1)[:n]
        out, off = [], 0
        for g, e in zip(gs, es):
            d = deq[off:off + g.numel()].reshape(g.shape)
            e.copy_(x[off:off + g.numel()].reshape(g.shape) - d)
            out.append(d.to(g.dtype))
            off += g.numel()
        return out

    stacked = [idx for _, idx in stacks] if isinstance(grads, dict) else []
    rest = {i for idx in stacked for i in idx}
    out = map_tree(lambda g, e: one([g], [e])[0],
                   {k: v for k, v in grads.items() if k != "layers"}
                   if stacked else grads,
                   {k: v for k, v in ef.items() if k != "layers"}
                   if stacked else ef)
    if not stacked:
        return out
    layers = [map_tree(lambda g, e: one([g], [e])[0], grads["layers"][i],
                       ef["layers"][i]) if i not in rest else None
              for i in range(len(grads["layers"]))]
    for idx in stacked:
        got = [[] for _ in idx]
        for parts in zip(*(_paths(grads["layers"][i]) for i in idx)):
            path = parts[0][0]
            deqs = one([g for _, g in parts],
                       [_at(ef["layers"][i], path) for i in idx])
            for slot, d in zip(got, deqs):
                slot.append((path, d))
        for i, pairs in zip(idx, got):
            layers[i] = _nest(pairs)
    return {**out, "layers": layers}


def _paths(tree, prefix=()):
    """``(key path, leaf)`` pairs of a nest of dicts, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _nest(pairs) -> dict:
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def make_train_step(model, tcfg: TrainConfig, split_microbatches=None):
    """``train_step(state, batch) -> (state, metrics)`` for ``model``:
    ``metrics`` holds ``loss``, ``gnorm`` and ``lr`` (0-d tensors).  A batch
    is cut along its first dim into ``tcfg.microbatches`` rounds: each entry
    reshaped to ``[nmb, B / nmb, ...]``, round ``i`` taking row ``i``.
    ``split_microbatches(entry, nmb)``, when given, makes that reshape
    instead (the dry run's, which keeps each device's rows on it where the
    JAX package re-constrains the reshaped batch by its
    ``microbatch_sharding`` hook)."""
    nmb = tcfg.microbatches
    acc_dt = getattr(torch, tcfg.accum_dtype)
    stacks = layer_stacks(model.cfg)

    def grads_of(params, batch):
        flat = list(leaves(params))
        loss, metrics = model.loss(batch)
        got = torch.autograd.grad(loss, flat, allow_unused=True)
        got = iter([torch.zeros_like(p) if g is None else g
                    for p, g in zip(flat, got)])
        return loss.detach(), metrics, map_tree(lambda _: next(got), params)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        params = state.params
        if nmb == 1:
            loss, _, grads = grads_of(params, batch)
        else:
            split = {k: (v.reshape((nmb, v.shape[0] // nmb) + v.shape[1:])
                         if split_microbatches is None
                         else split_microbatches(v, nmb))
                     for k, v in batch.items()}
            mbs = [{k: v[i] for k, v in split.items()} for i in range(nmb)]
            grads = map_tree(lambda p: torch.zeros_like(p, dtype=acc_dt),
                             params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.opt["step"].device)
            for mb in mbs:
                loss_i, _, g = grads_of(params, mb)
                map_tree(lambda a, b: a.add_(b.to(acc_dt)), grads, g)
                del g
                loss = loss + loss_i
            loss = loss / nmb
            map_tree(lambda g: g.div_(nmb), grads)

        if tcfg.grad_compress:
            grads = _compress_ef(grads, state.ef, stacks=stacks)

        lr_scale = cosine_schedule(state.opt["step"],
                                   warmup=tcfg.warmup_steps,
                                   total=tcfg.total_steps)
        _, _, opt_metrics = adamw_update(params, grads, state.opt, tcfg.opt,
                                         lr_scale)
        return state, {"loss": loss, **opt_metrics}

    return train_step
