"""Sharding rules: every parameter, optimizer moment, batch entry and cache
tensor placed on the (pod, data, model) production mesh — the port of
``repro/distributed/sharding.py``.

Strategy (DTensor then issues the collectives):

* **TP** on the model axis: attention heads, FFN hidden dim, expert dim,
  vocab dim.
* **DP** on (pod, data): the batch dimension of activations and caches.
* **FSDP** (optional) on the data axes: parameters additionally sharded on
  a non-TP dim so the giant MoE configs fit (ZeRO-3 style).
* A dim is only assigned a mesh axis when divisible by it — otherwise the
  tensor is replicated on that axis (e.g. kv_heads=1 MQA replicates KV).

A placement is a **spec**: a tuple with one entry per tensor dim, ``None``
(replicated), an axis name, or a tuple of axis names (sharded over their
product, the first outermost), as the JAX package's ``PartitionSpec``;
:func:`to_placements` turns one into DTensor placements on a mesh.

The port's layers are a list of per-layer dicts where the JAX package
stacks them (``models/model.py`` ``layer_stacks``).  The name rules below
are the JAX package's, read on each leaf's JAX path (``layers/…``,
``dense0/…``, ``extra/…``, ``layers/b<j>/…``) and its shape with a stack
dim in front, so a port layer's spec is JAX's with the stack entry dropped.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Tuple

from ..models.model import layer_stacks

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Any                                  # DeviceMesh (or .shape dict)
    model_axis: str = "model"
    data_axes: Tuple[str, ...] = ("data",)     # ("pod", "data") multi-pod
    fsdp: bool = False                         # shard params on data too
    # Which expert-weight dim carries the FSDP shard:
    #   "ff"       — output/hidden dim (ZeRO-style)
    #   "contract" — contraction dim (matmul partial sums; weights are
    #                never gathered)
    #   "none"     — experts sharded on the model axis only
    expert_fsdp_dim: str = "contract"

    def axis_size(self, axis: str) -> int:
        mesh = self.mesh
        if hasattr(mesh, "mesh_dim_names"):
            return mesh.size(mesh.mesh_dim_names.index(axis))
        return mesh.shape[axis]

    @property
    def model_size(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def data_size(self) -> int:
        out = 1
        for a in self.data_axes:
            out *= self.axis_size(a)
        return out


def _axes(axes: Tuple[str, ...]):
    """A spec entry for ``axes``: the name alone for one axis, as
    ``PartitionSpec`` writes it."""
    return axes[0] if len(axes) == 1 else tuple(axes)


def _divisible(dim: int, size: int) -> bool:
    return dim % size == 0 and dim >= size


def _spec_for_param(rules: ShardingRules, path: str,
                    shape: Tuple[int, ...]) -> Spec:
    """Parameter placement by name pattern on the JAX path and shape
    (leading ``layers``/``dense0``/``extra`` stack dims never sharded)."""
    ax_m = rules.model_axis
    ms = rules.model_size
    spec = [None] * len(shape)

    def put(dim: int, axis) -> bool:
        size = (rules.data_size if axis != ax_m else ms)
        if spec[dim] is None and _divisible(shape[dim], size):
            spec[dim] = axis
            return True
        return False

    stacked = path.startswith(("layers", "dense0", "extra"))
    base = 1 if stacked else 0          # skip the stack dim

    def d(i):                            # logical dim index
        return base + i

    leaf = path.split("/")[-1]

    rank = len(shape) - base             # logical (unstacked) rank

    if leaf == "embed" or path.endswith("embed"):
        put(0, ax_m)                     # vocab
    elif leaf == "head":
        put(1, ax_m)                     # [d, vocab]
    elif leaf in ("wq", "wk", "wv"):
        put(d(1), ax_m)                  # [d, H, dh] → heads
    elif leaf == "wo":
        put(d(0), ax_m)                  # [H, dh, d] → heads
    elif leaf == "w_in" and rank == 4:   # expert stack [E, d, g, ff]
        put(d(0), ax_m)                  # experts (EP)
        if rules.fsdp and rules.expert_fsdp_dim != "none":
            put(d(1) if rules.expert_fsdp_dim == "contract" else d(3),
                _axes(rules.data_axes))
    elif leaf == "w_out" and rank == 3 and "moe" in path:
        put(d(0), ax_m)                  # [E, ff, d]
        if rules.fsdp and rules.expert_fsdp_dim != "none":
            put(d(1), _axes(rules.data_axes))   # ff: the 2nd mm's contraction
    elif leaf == "w_in":                 # dense MLP [d, g, ff]
        put(d(2), ax_m)
    elif leaf == "w_out":                # dense MLP [ff, d]
        put(d(0), ax_m)
    elif leaf == "router":
        pass                             # small: replicate
    elif leaf in ("in_proj", "out_proj", "in_x", "in_gate", "out",
                  "w_a", "w_i"):
        put(d(1), ax_m)                  # project wide dim
    if rules.fsdp and all(s is None for s in spec):
        # ZeRO fallback: biggest dim on data axes if divisible.
        dims = sorted(range(base, len(shape)), key=lambda i: -shape[i])
        for i in dims:
            if _divisible(shape[i], rules.data_size):
                spec[i] = _axes(rules.data_axes)
                break
    return tuple(spec)


def _paths(tree, prefix=""):
    """``(path, leaf)`` of a nest of dicts, ``/``-joined keys."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _nest_like(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _nest_like(v, fn, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, tree)


def _stacked(cfg, tree: Dict, spec_fn) -> Dict:
    """``spec_fn(jax_path, shape)`` over ``tree`` (a model's parameters or
    cache: top-level leaves and ``"layers"``, a list of per-layer dicts),
    each layer's leaves on their JAX stacked path with a stack dim of 1 in
    front, the stack entry dropped from the result."""
    out = _nest_like({k: v for k, v in tree.items() if k != "layers"},
                     lambda p, leaf: spec_fn(p, tuple(leaf.shape)))
    layers = [None] * len(tree["layers"])
    for keys, idx in layer_stacks(cfg):
        for i in idx:
            layers[i] = _nest_like(
                tree["layers"][i],
                lambda p, leaf: spec_fn("/".join(keys + (p,)),
                                        (1,) + tuple(leaf.shape))[1:])
    out["layers"] = layers
    return out


def param_placements(rules: ShardingRules, cfg, params: Dict) -> Dict:
    """A spec for every leaf of ``params`` (a model's
    :meth:`~repro_torch.models.Model.params`, or a nest of anything with a
    ``.shape`` laid out alike)."""
    return _stacked(cfg, params,
                    lambda p, shape: _spec_for_param(rules, p, shape))


def _cache_spec(rules: ShardingRules, path: str,
                shape: Tuple[int, ...]) -> Spec:
    """KV/state caches (stacked layout ``[L, B, ...]``): batch on the data
    axes; the KV sequence dim on the model axis when kv_heads can't use it
    (the 32k decode memory fix)."""
    dax = _axes(rules.data_axes)
    ax_m = rules.model_axis
    ms = rules.model_size
    names = path.split("/")
    spec = [None] * len(shape)
    # layouts: attn k/v [L, B, S, Hkv, dh]; ssm [L, B, H, N, P];
    # rglru h [L, B, W]; conv [L, B, w, C]
    if "k" in names or "v" in names:
        if _divisible(shape[1], rules.data_size):
            spec[1] = dax
        if _divisible(shape[3], ms):
            spec[3] = ax_m               # kv heads
        elif _divisible(shape[2], ms):
            spec[2] = ax_m               # cache sequence
    else:
        if len(shape) > 1 and _divisible(shape[1], rules.data_size):
            spec[1] = dax
        for i in range(2, len(shape)):
            if _divisible(shape[i], ms):
                spec[i] = ax_m
                break
    return tuple(spec)


def cache_placements(rules: ShardingRules, cfg, cache: Dict) -> Dict:
    """A spec for every leaf of a model's decode cache
    (:meth:`~repro_torch.models.Model.init_cache`)."""
    def spec(path, shape):
        if not path.startswith(("layers", "dense0", "extra")):
            raise ValueError(f"unexpected cache leaf {path}")
        return _cache_spec(rules, path, shape)

    return _stacked(cfg, cache, spec)


def opt_placements(rules: ShardingRules, cfg, opt: Dict,
                   params: Dict) -> Dict:
    """Optimizer-state placement: f32 moments mirror their parameter's
    spec; an int8 moment's ``q`` mirrors it too and its ``scale``
    (``param.shape[:-1] + (blocks,)``) takes it with the last dim
    replicated."""
    pspecs = param_placements(rules, cfg, params)

    def moments(tree, specs):
        if isinstance(tree, dict) and set(tree) == {"q", "scale"}:
            scale = list(specs) + [None] * (tree["scale"].dim() - len(specs))
            scale = scale[: tree["scale"].dim()]
            scale[-1] = None
            return {"q": specs, "scale": tuple(scale)}
        if isinstance(tree, dict):
            return {k: moments(v, specs[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [moments(v, s) for v, s in zip(tree, specs)]
        return specs

    return {"step": (), "m": moments(opt["m"], pspecs),
            "v": moments(opt["v"], pspecs)}


def batch_placements(rules: ShardingRules, batch_specs: Dict) -> Dict:
    """Batch inputs: leading batch dim over the data axes."""
    def one(s):
        spec = [None] * len(s.shape)
        if _divisible(s.shape[0], rules.data_size):
            spec[0] = _axes(rules.data_axes)
        return tuple(spec)

    return {k: one(v) for k, v in batch_specs.items()}


def to_placements(mesh, spec: Spec) -> list:
    """DTensor placements on ``mesh`` (a ``DeviceMesh`` with named dims)
    of a spec: each mesh dim shards the tensor dim whose entry names it,
    else replicates."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry,) if isinstance(entry, str) else entry:
            out[mesh.mesh_dim_names.index(axis)] = Shard(dim)
    return out


def local_shape(rules: ShardingRules, shape, spec: Spec) -> Tuple[int, ...]:
    """The shape of one device's shard of a tensor of ``shape`` placed by
    ``spec`` (every sharded dim divides evenly: the rules shard no other)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry,) if isinstance(entry, str) else entry:
            out[dim] //= rules.axis_size(axis)
    return tuple(out)


def register_kernel_rules() -> None:
    """Register the sharding rules of the kernels' custom ops with DTensor
    (once a process)."""
    global _REGISTERED
    if _REGISTERED:
        return
    for name in ("flash_attention", "ssd_scan", "lru_scan"):
        importlib.import_module(f"repro_torch.kernels.{name}.{name}"
                                ).register_sharding_rules()
    _REGISTERED = True


_REGISTERED = False
