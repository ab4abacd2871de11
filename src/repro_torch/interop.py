"""Carry state between the JAX package and the port: a context store, a
model's parameters, and a training state (and back to numpy, to compare).

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
from .core.context import ContextLayout, ContextStore, MeshStore, \
    resolve_device


def store_from_numpy(layout: ContextLayout, words_u32: np.ndarray,
                     device=None, mesh=None) -> ContextStore | MeshStore:
    """The port's store over ``words_u32`` (``[v, layout.words]`` uint32,
    e.g. ``np.asarray(jax_store.data)``, the global words of a sharded JAX
    store too), copied to ``device`` (CUDA by default); over a ``mesh`` of
    cards (:attr:`~repro_torch.core.Mesh.spans_devices`) a
    :class:`~repro_torch.core.context.MeshStore`, its rows split into one
    block a card."""
    words = np.ascontiguousarray(words_u32)
    if words.dtype != np.uint32 or words.ndim != 2:
        raise TypeError(f"expected [v, words] uint32 words, got {words.dtype} "
                        f"{words.shape}")
    if words.shape[1] != layout.words:
        raise ValueError(f"store rows hold {words.shape[1]} words but the "
                         f"layout has {layout.words}")
    data = torch.from_numpy(words.view(np.int32).copy())
    if mesh is not None and len(mesh.devices) > 1 and mesh.spans_devices:
        m = data.shape[0] // len(mesh.devices)
        return MeshStore(layout, [data[p * m:(p + 1) * m].to(dev, copy=True)
                                  for p, dev in enumerate(mesh.devices)])
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


def store_to_numpy(store: ContextStore | MeshStore) -> np.ndarray:
    """The store's words as a ``[v, words]`` uint32 numpy array (the JAX
    package's ``ContextStore.data`` bits; a mesh store's blocks joined in
    process order)."""
    if isinstance(store, MeshStore):
        return np.concatenate([b.cpu().numpy() for b in store.blocks]).view(
            np.uint32)
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
    (``layers``): the order the JAX model runs them.  Every other top-level
    entry (``embed``, ``head``, ``final_norm``, a frames model's
    ``frontend_proj``) carries over as it is.  Every array keeps its dtype
    (an MoE router stays float32 in a bfloat16 model), and bfloat16 arrays
    carry over bit for bit."""
    from .models.model import Model
    return Model(cfg, device=device, params=_port_layout(cfg, tree))


def train_state_from_jax(cfg, state, device=None):
    """``(model, state)``: the port's model and
    :class:`~repro_torch.train.TrainState` holding the JAX package's
    training state (its ``TrainState`` as numpy arrays,
    ``jax.tree.map(np.asarray, state)``): the parameters as
    :func:`params_from_jax` carries them, the moments ``m`` and ``v``
    (float32, or int8 blocks with their scales) and the error-feedback
    residuals ``ef`` with their layers cut the same way, and the step.  The
    parameters are trainable, as :func:`~repro_torch.train.init_train_state`
    leaves them."""
    from .train import TrainState
    from .tree import leaves, map_tree
    model = params_from_jax(cfg, state.params, device)
    dev = model.device
    on_dev = lambda t: map_tree(lambda x: x.to(dev), _port_layout(cfg, t))
    opt = {"step": _tensor(state.opt["step"]).to(dev),
           "m": on_dev(state.opt["m"]), "v": on_dev(state.opt["v"])}
    ef = None if state.ef is None else on_dev(state.ef)
    params = model.params()
    for p in leaves(params):
        p.requires_grad_(True)
    return model, TrainState(params, opt, ef)


def train_state_to_numpy(cfg, state) -> dict:
    """The inverse of :func:`train_state_from_jax`, for comparing the two
    packages after steps: ``{"params", "opt": {"step", "m", "v"}, "ef"}`` as
    numpy arrays in the JAX package's stacked layout (``layers``, and
    ``dense0`` or ``extra`` where the JAX model has them).  bfloat16 leaves
    come back as float32 arrays (exact)."""
    def numpy(t):
        if isinstance(t, dict):
            return {k: numpy(v) for k, v in t.items()}
        if isinstance(t, list):
            return [numpy(v) for v in t]
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def jax_layout(tree):
        return None if tree is None else _jax_layout(cfg, numpy(tree))

    return {"params": jax_layout(state.params),
            "opt": {"step": numpy(state.opt["step"]),
                    "m": jax_layout(state.opt["m"]),
                    "v": jax_layout(state.opt["v"])},
            "ef": jax_layout(state.ef)}


def _tensor(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _convert(t):
    return ({k: _convert(v) for k, v in t.items()} if isinstance(t, dict)
            else _tensor(t))


def _port_layout(cfg, tree) -> dict:
    """A JAX-layout tree of ``cfg`` (parameters, or moments of the same
    structure) in :func:`repro_torch.models.model.init_params`' layout: the
    top-level entries as tensors and ``"layers"`` the list of per-layer
    dicts, cut from the stacks that
    :func:`repro_torch.models.model.layer_stacks` names (see
    :func:`params_from_jax`)."""
    from .models.model import layer_stacks

    def layer(t, i):
        if isinstance(t, dict):
            return {k: layer(v, i) for k, v in t.items()}
        return _tensor(t[i])

    flat = [None] * cfg.n_layers
    for keys, idx in layer_stacks(cfg):
        stack = tree
        for k in keys:
            stack = stack.get(k, {}) if isinstance(stack, dict) else {}
        depth = len(next(iter(_leaves(stack)), ()))
        if depth != len(idx):
            raise ValueError(f"{cfg.name}: the tree's {'/'.join(keys)} "
                             f"stacks {depth} layers, the config has "
                             f"{len(idx)} there")
        for n, i in enumerate(idx):
            flat[i] = layer(stack, n)
    params = {k: _convert(v) for k, v in tree.items()
              if k not in ("layers", "extra", "dense0")}
    params["layers"] = flat
    return params


def _jax_layout(cfg, tree) -> dict:
    """The inverse of :func:`_port_layout` on numpy leaves: the per-layer
    list stacked as the JAX model stacks it
    (:func:`repro_torch.models.model.layer_stacks`)."""
    from .models.model import layer_stacks

    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([t[k] for t in layers]) for k in layers[0]}
        return np.stack(layers)

    out = {k: v for k, v in tree.items() if k != "layers"}
    for keys, idx in layer_stacks(cfg):
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = stack([tree["layers"][i] for i in idx])
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
