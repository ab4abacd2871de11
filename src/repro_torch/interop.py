"""Carry state between the JAX package and the port: a context store, and a
model's parameters.

The JAX package keeps its ``[v, words]`` store as ``uint32`` words; the port
keeps the same bits as ``int32`` words.  Converting is a reinterpretation of
the bits, never a value conversion, so a store taken mid-plan from one side
resumes bit-identically on the other — the port's counterpart of carrying
weights over: run the JAX ``psrs_plan`` stages up to some stage, move the
store with :func:`store_from_numpy` (device tier) or
:func:`tiered_store_from_numpy` (a backing tier), and finish the stages in
the port's ``psrs_plan``.  A JAX memmap or file backing needs no carrying:
the port's backing of the same path reopens it as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.backing import TieredStore, make_backing
from .core.context import ContextLayout, ContextStore, resolve_device


def store_from_numpy(layout: ContextLayout, words_u32: np.ndarray,
                     device=None) -> ContextStore:
    """The port's store over ``words_u32`` (``[v, layout.words]`` uint32,
    e.g. ``np.asarray(jax_store.data)``), copied to ``device`` (CUDA by
    default)."""
    words = np.ascontiguousarray(words_u32)
    if words.dtype != np.uint32 or words.ndim != 2:
        raise TypeError(f"expected [v, words] uint32 words, got {words.dtype} "
                        f"{words.shape}")
    if words.shape[1] != layout.words:
        raise ValueError(f"store rows hold {words.shape[1]} words but the "
                         f"layout has {layout.words}")
    data = torch.from_numpy(words.view(np.int32).copy())
    return ContextStore(layout, data.to(resolve_device(device)))


def tiered_store_from_numpy(layout: ContextLayout, words_u32: np.ndarray,
                            tier: str, backing_path=None, *, ledger=None,
                            shard_ledgers=None, **backing_kw) -> TieredStore:
    """The port's backing-tier store (``tier`` ``"host"``, ``"memmap"`` or
    ``"file"``, at ``backing_path``) holding ``words_u32`` (``[v,
    layout.words]`` uint32, e.g. a JAX store's words).  ``backing_kw`` goes
    to :func:`~repro_torch.core.make_backing` (``P``, ``io_driver``, ...);
    ``ledger``/``shard_ledgers`` are the store's, as ``Pems.init`` passes
    its own.  Loading the words is outside the ledger."""
    words = np.ascontiguousarray(words_u32)
    if words.dtype != np.uint32 or words.ndim != 2:
        raise TypeError(f"expected [v, words] uint32 words, got {words.dtype} "
                        f"{words.shape}")
    if words.shape[1] != layout.words:
        raise ValueError(f"store rows hold {words.shape[1]} words but the "
                         f"layout has {layout.words}")
    backing = make_backing(tier, words.shape[0], layout.words, backing_path,
                           **backing_kw)
    store = TieredStore(layout, backing, ledger, shard_ledgers=shard_ledgers)
    store.load_rows(0, words)
    return store


def store_to_numpy(store: ContextStore) -> np.ndarray:
    """The store's words as a ``[v, words]`` uint32 numpy array (the JAX
    package's ``ContextStore.data`` bits)."""
    return store.data.cpu().numpy().view(np.uint32)


def params_from_jax(cfg, tree, device=None):
    """The port's :class:`repro_torch.models.Model` of ``cfg`` holding the
    JAX package's parameters ``tree`` (its ``Model.init`` pytree as numpy
    arrays, ``jax.tree.map(np.asarray, params)``), on ``device`` (CUDA by
    default).  The JAX package stacks the layers along a leading ``[L, ...]``
    axis for its scan; the port keeps one dict per layer, so the stack is cut
    into its ``L`` layers.  A hybrid tree stacks groups of ``block_pattern``
    blocks (``layers["b<j>"][g]``) and the rec layers left over
    (``extra[e]``): group ``g``'s block ``j`` becomes layer ``3g + j`` (for a
    pattern of 3) and ``extra[e]`` follows the groups; an MoE tree's leading
    dense layers (``dense0``, a stack of its own) come before its MoE stack
    (``layers``): the order the JAX model runs them.  Every array keeps its
    dtype (an MoE router stays float32 in a bfloat16 model), and bfloat16
    arrays carry over bit for bit."""
    from .models.model import Model

    def tensor(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())

    def layer(t, i):
        if isinstance(t, dict):
            return {k: layer(v, i) for k, v in t.items()}
        return tensor(t[i])

    def depth(stack):
        return len(next(iter(_leaves(stack))))

    stack = tree["layers"]
    if cfg.family == "hybrid":
        blocks = [f"b{j}" for j in range(len(cfg.block_pattern))]
        flat = [layer(stack[bj], g) for g in range(depth(stack[blocks[0]]))
                for bj in blocks]
        if "extra" in tree:
            flat += [layer(tree["extra"], e)
                     for e in range(depth(tree["extra"]))]
    else:
        flat = [layer(tree["dense0"], i) for i in range(depth(tree["dense0"]))
                ] if "dense0" in tree else []
        flat += [layer(stack, i) for i in range(depth(stack))]
    if len(flat) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: the tree stacks {len(flat)} layers, "
                         f"the config has {cfg.n_layers}")
    params = {k: tensor(v) for k, v in tree.items()
              if k not in ("layers", "extra", "dense0")}
    params["layers"] = flat
    return Model(cfg, device=device, params=params)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
