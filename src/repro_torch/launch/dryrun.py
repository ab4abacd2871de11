"""Multi-pod dry run: trace every (architecture × input shape) on the
production meshes with nothing allocated — the port of
``repro/launch/dryrun.py``.

A cell runs one train step, one prefill or one decode of the port
(:func:`~repro_torch.train.make_train_step`, ``Model.prefill``,
``Model.decode``) under ``FakeTensorMode`` on a fake process group
(:mod:`repro_torch.launch.mesh`): the parameters, optimizer moments, batch
and cache are DTensors of their local shard shapes, placed by
:mod:`repro_torch.distributed.sharding`, and DTensor plans the collectives.
By default it traces the card's path: the kernels' custom ops through their
fake implementations, on fake ``"cuda"`` tensors (on ``"meta"`` tensors
where PyTorch is built without CUDA, whose autograd cannot place a CUDA
tensor: the same ops either way).  ``device="cpu"`` traces the plain path.

For each cell it records, per device:

  * ``memory``: the arguments' bytes (params, moments and batch, plus the
    cache when serving), the outputs', the aliased (state updated in place),
    and the peak of live bytes over the step (``per_device_bytes``); the
    temporaries are the peak less the arguments and the new outputs, so
    ``per_device = argument + output + temp - alias``;
  * ``cost``: the flops (``torch.utils.flop_counter``'s formulas, the
    kernels' own among them) and the bytes accessed (every op's operand and
    output bytes, views excepted: XLA's unfused count), counted on the local
    shards by a dispatch mode below DTensor;
  * ``collectives``: the bytes of the collectives DTensor issued, as
    ``CommDebugMode`` sees them (:func:`~repro_torch.roofline.collective_bytes`);
  * the roofline terms over the H100's constants and the dominant term.

``lower_s`` and ``compile_s`` hold the seconds the build and the trace took
(there is no compile).

Usage:
  python -m repro_torch.launch.dryrun --arch mamba2-130m --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out artifacts/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import ARCH_NAMES, SHAPES, get_config, skip_reason
from ..data import BatchSpec, DataConfig, make_batch_specs
from ..distributed.sharding import (ShardingRules, batch_placements,
                                    cache_placements, local_shape,
                                    opt_placements, param_placements,
                                    register_kernel_rules, to_placements)
from ..models.model import Model, init_params, make_cache
from ..optim import OptConfig, adamw_init
from ..roofline import HW, collective_bytes, roofline_terms
from ..roofline.analyze import collective_kind
from ..train import TrainConfig, TrainState, make_train_step
from ..tree import leaves
from .mesh import (data_axes_of, fake_world, make_production_mesh,
                   production_shape)

# Per-arch execution choices (the JAX package's).
BIG_MOE = ("kimi-k2-1t-a32b", "arctic-480b")
FSDP_ARCHS = BIG_MOE + ("qwen3-14b",)
TRAIN_MICROBATCHES = 8


def trace_device(device: str = "cuda") -> torch.device:
    """The device the fake tensors of a trace live on: ``"cpu"`` for the
    plain path; for the card's path ``"cuda"``, or ``"meta"`` where PyTorch
    is built without CUDA (the kernels' wrappers take their custom op on any
    tensor not on the CPU, so both trace the same ops)."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return torch.device("cuda" if torch.version.cuda else "meta")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    """The tensors in ``x`` (a tensor, or dicts, lists and tuples of them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        out = []
        for v in x:
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, (list, tuple, dict)):
                out.extend(_tensors(v))
        return out
    return []


class LocalCost(TorchDispatchMode):
    """A dispatch mode below DTensor (it hands every op on DTensors back to
    DTensor and so sees the ops DTensor runs on the local shards): per
    device the flops (``torch.utils.flop_counter.flop_registry``), the
    bytes accessed (operands and outputs of every op that is not a view)
    and the live bytes of the storages the traced ops made, with their
    peak."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._made = set()      # ids of the live storages the ops made
        self._paused = 0

    def __enter__(self):
        # DTensor's sharding propagation runs each new op once more on fake
        # tensors of the global shapes to learn its outputs' metadata; none
        # of that runs on a device, so this mode counts nothing meanwhile.
        prop = DTensor._op_dispatcher.sharding_propagator
        name = next((n for n in ("_propagate_tensor_meta_non_cached",
                                 "_propagate_tensor_meta")
                     if hasattr(prop, n)), None)
        if name is None:
            raise RuntimeError("this PyTorch's DTensor has no tensor-meta "
                               "propagation the dry run knows")
        meta_fn = getattr(prop, name)

        def paused(*args, **kwargs):
            self._paused += 1
            try:
                return meta_fn(*args, **kwargs)
            finally:
                self._paused -= 1

        setattr(prop, name, paused)      # shadows the method while we run
        self._unpause = lambda: delattr(prop, name)
        return super().__enter__()

    def __exit__(self, *exc):
        self._unpause()
        return super().__exit__(*exc)

    def _track(self, t) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._made:
            return
        self._made.add(key)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._made.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused or isinstance(func, torch._ops.HigherOrderOperator):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs,
                                                            out)))
            # An in-place op (or an ``out=`` one) returns its operand's
            # storage: nothing new is made.
            given = {id(t.untyped_storage())
                     for t in _tensors((args, kwargs))}
            for t in _tensors(out):
                if id(t.untyped_storage()) not in given:
                    self._track(t)
        return out


class PlacementPolicy(TorchDispatchMode):
    """Above DTensor, the rules its op-by-op propagation lacks (GSPMD plans
    the whole step, forward and backward together):

    * an operand that is a partial sum is all-reduced (redistributed to
      replicated on those mesh dims) before the op runs, forward and
      backward alike, as a Megatron-style step reduces a row-parallel
      product at once.  Left to itself DTensor reduce-scatters a partial
      sum onto whichever dim its cost model picks, the sequence among them,
      on which no kernel of the model is local;
    * a matrix product's operands decide its output's placement, mesh
      dim by mesh dim (:func:`_local_mm`): DTensor otherwise shards a
      replicated weight's columns for free and unflattens heads that do
      not divide the mesh, and its rule for a strided shard (a gated
      MLP's ``[d, 2, ff]`` weight flattened) fails under fake tensors;
    * a constant pad over dims that are not sharded pads the local shard,
      and an accumulating ``index_put`` of batch-sharded rows into a
      replicated tensor (the embedding's gradient) accumulates each
      device's rows into a partial sum (:func:`_local_pad`,
      :func:`_local_index_put`), where DTensor's rules fail on some PyTorch
      releases (2.11 among them);
    * an op DTensor has no rule for (the MoE dispatch's ``searchsorted``)
      runs row by row on the local shards where all its operands are
      placed alike and sharded on their leading dim only
      (:func:`_rowwise`);
    * a view DTensor cannot make, or makes a strided shard of, is made on
      the local shard with the shard kept on one dim of its group
      (:func:`_local_view`), so a gated MLP's ``[d, 2, ff]`` weight
      flattened and its product unflattened stay sharded on ``ff``:
      DTensor's product and view rules for a strided shard fail under fake
      tensors;
    * a replicated broadcast (``expand``) whose leading dim divides over
      the data axes is sharded on them, and a new tensor made in the shape
      of a batch-sharded one (``new_zeros`` and its kin, as a gather's
      backward makes its gradient) is made batch-sharded: DTensor makes
      both replicated, so the loss's gradient (a broadcast of a replicated
      scalar) would reach the logits' backward replicated and make
      global-size temporaries on every device."""

    def __init__(self, mesh, data_axes, data_size):
        super().__init__()
        self.batch = [Shard(0) if a in data_axes else None
                      for a in mesh.mesh_dim_names]
        self.data_size = data_size

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if func in _VIEWS:         # a view of a partial sum stays partial
            try:
                out = func(*args, **kwargs)
            except RuntimeError:   # DTensor cannot regroup this shard
                out = None
            if out is None or _strided(out):
                out = _local_view(func, args[0], list(args[1]))
            if out is not None:
                return out
        # An in-place op updates its own operand, partial or not.
        args = ((args[0], *_reduced(args[1:])) if func._schema.is_mutable
                else _reduced(args))
        kwargs = _reduced(kwargs)
        local = _LOCAL_RULES.get(func)
        if local is not None:
            out = local(*args, **kwargs)
            if out is not None:
                return out
        if func in _NEW_LIKE and self._batch_sharded(args[0], args[1]):
            x, size = args[0], list(args[1])
            size[0] //= self.data_size
            local = func(x.to_local(), size, *args[2:], **kwargs)
            return DTensor.from_local(local, x.device_mesh, [
                b or Replicate() for b in self.batch], run_check=False)
        try:
            out = func(*args, **kwargs)
        except NotImplementedError as e:   # DTensor has no rule for it
            out = _rowwise(func, args, kwargs)
            if out is None:
                raise RuntimeError(f"dry run: DTensor has no rule for {func}"
                                   f" on {_placed(args)}: {e}") from e
        except (RuntimeError, IndexError, ValueError) as e:
            raise RuntimeError(f"dry run: DTensor could not run {func} on "
                               f"{_placed(args)}: {e}") from e
        if (func is torch.ops.aten.expand.default and out.ndim >= 2
                and out.shape[0] % self.data_size == 0
                and all(p.is_replicate() for p, b in
                        zip(out.placements, self.batch) if b is not None)):
            out = out.redistribute(out.device_mesh, [
                b or p for p, b in zip(out.placements, self.batch)])
        return out

    def _batch_sharded(self, x, size) -> bool:
        """Whether ``x`` is sharded on its leading dim over the data axes
        alone and ``size`` keeps that dim."""
        return (x.ndim >= 1 and len(size) >= 1 and size[0] == x.shape[0]
                and all((p == b) if b is not None else p.is_replicate()
                        for p, b in zip(x.placements, self.batch)))


def _local_mm(a, b):
    """``a @ b`` of DTensors ``[M, K] @ [K, N]`` computed on the local
    shards, each mesh dim placed by its operands' placements there: both
    replicated, replicated; ``a`` sharded on M, or ``b`` on N, that shard
    (strided shards included); both sharded on K alike, a partial sum; one
    sharded on K (plain), the other's slice of K taken, a partial sum.
    None where the operands conflict (both sharded, not on K alike): then
    DTensor redistributes."""
    out, la, lb = [], a.to_local(), b.to_local()
    mesh = a.device_mesh
    for i, (pa, pb) in enumerate(zip(a.placements, b.placements)):
        sa = pa.dim if pa.is_shard() else None
        sb = pb.dim if pb.is_shard() else None
        if sa is None and sb is None:
            out.append(Replicate())
        elif sa == 0 and sb is None:
            out.append(pa)
        elif sa is None and sb == 1:
            out.append(pb)
        elif sa == 1 and sb == 0 and pa == pb:
            out.append(Partial())
        elif sa == 1 and sb is None and type(pa) is Shard:
            lb = lb.chunk(mesh.size(i), 0)[0]
            out.append(Partial())
        elif sa is None and sb == 0 and type(pb) is Shard:
            la = la.chunk(mesh.size(i), 1)[0]
            out.append(Partial())
        else:
            return None
    if la.shape[1] != lb.shape[0]:
        return None
    return _wrap((a.shape[0], b.shape[1]), mesh,
                 torch.ops.aten.mm.default(la, lb), out)


def _wrap(shape, mesh, local, placements):
    """A DTensor over ``local`` placed by ``placements`` (its global shape
    and strides follow from the local shard's, each shard even), checked to
    be of global ``shape``."""
    out = DTensor.from_local(local, mesh, placements, run_check=False)
    if tuple(out.shape) != tuple(shape):
        raise RuntimeError(f"dry run: a local shard {tuple(local.shape)} "
                           f"placed {tuple(placements)} is "
                           f"{tuple(out.shape)}, not {tuple(shape)}")
    return out


def _local_pad(x, pad, value=0.0):
    """``constant_pad_nd`` of DTensor ``x`` on its local shard, where no
    padded dim is sharded (None otherwise)."""
    n = len(pad) // 2
    padded = range(x.ndim - n, x.ndim)
    if any(p.is_partial() or (p.is_shard() and p.dim in padded)
           for p in x.placements):
        return None
    shape = list(x.shape)
    for i in range(n):
        shape[x.ndim - 1 - i] += pad[2 * i] + pad[2 * i + 1]
    local = torch.ops.aten.constant_pad_nd.default(x.to_local(), pad, value)
    return _wrap(shape, x.device_mesh, local, x.placements)


def _local_index_put(x, indices, values, accumulate=False):
    """``index_put(x, [idx], values, accumulate=True)`` of a replicated
    ``x`` with ``idx`` and ``values`` sharded alike on their leading dim
    (or replicated) on each mesh dim: each device accumulates its own rows,
    a partial sum over the dims that shard them.  None for anything
    else."""
    if (not accumulate or len(indices) != 1
            or not all(isinstance(t, DTensor)
                       for t in (x, indices[0], values))):
        return None
    out = []
    for px, pi, pv in zip(x.placements, indices[0].placements,
                          values.placements):
        if not px.is_replicate():
            return None
        if pi.is_replicate() and pv.is_replicate():
            out.append(Replicate())
        elif pi == Shard(0) and pv == Shard(0):
            out.append(Partial())
        else:
            return None
    local = torch.ops.aten.index_put.default(
        x.to_local(), [indices[0].to_local()], values.to_local(), True)
    return _wrap(x.shape, x.device_mesh, local, out)


_VIEWS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)


def _strided(x) -> bool:
    """Whether DTensor ``x`` has a strided shard (a shard of a later dim of
    a merged group)."""
    return any(getattr(p, "split_factor", None) is not None
               for p in x.placements)


def _groups(a, b):
    """The dims of shapes ``a`` and ``b`` (one element count) in groups of
    equal products: ``[(dims of a, dims of b), ...]``."""
    groups, i, j = [], 0, 0
    while i < len(a) or j < len(b):
        ga, gb, pa, pb = [], [], 1, 1
        if i < len(a):
            ga.append(i)
            pa *= a[i]
            i += 1
        if j < len(b):
            gb.append(j)
            pb *= b[j]
            j += 1
        while pa != pb:
            if pa < pb:
                ga.append(i)
                pa *= a[i]
                i += 1
            else:
                gb.append(j)
                pb *= b[j]
                j += 1
        groups.append((ga, gb))
    return groups


def _local_view(func, x, size):
    """``x.view(size)`` on the local shard, each shard of ``x`` moved to
    the first dim of its dim's group in ``size`` that divides by it (a
    group's dims merge or split into others of one element count).  A shard
    of a merged group's later dim so stays a plain shard of the merged dim
    on the same local elements, and splitting that dim again puts it back
    where it was.  None where ``x`` has no shard or no such dim exists."""
    if not any(p.is_shard() for p in x.placements):
        return None
    if -1 in size:
        known = 1
        for d in size:
            known *= d if d != -1 else 1
        size = [x.numel() // known if d == -1 else d for d in size]
    where = {}
    for ga, gb in _groups(list(x.shape), size):
        for d in ga:
            where[d] = gb
    out_pl, div = [], [1] * len(size)
    for i, p in enumerate(x.placements):
        if not p.is_shard():
            out_pl.append(p)
            continue
        n = x.device_mesh.size(i)
        dims = [o for o in where[p.dim] if size[o] % (div[o] * n) == 0]
        if not dims:
            return None
        div[dims[0]] *= n
        out_pl.append(Shard(dims[0]))
    local = func(x.to_local(), [s // k for s, k in zip(size, div)])
    return _wrap(size, x.device_mesh, local, out_pl)


_LOCAL_RULES = {torch.ops.aten.mm.default: _local_mm,
                torch.ops.aten.constant_pad_nd.default: _local_pad,
                torch.ops.aten.index_put.default: _local_index_put}

_NEW_LIKE = (torch.ops.aten.new_zeros.default,
             torch.ops.aten.new_empty.default,
             torch.ops.aten.new_ones.default)


def _rowwise(func, args, kwargs):
    """``func`` on the local shards of operands all placed alike, sharded
    on their leading dim only (or replicated; a plain tensor of as many
    rows counts as replicated and gives this device's rows): each device's
    rows give its rows of every output, placed as the operands.  None
    otherwise."""
    ds = [t for t in _tensors((args, kwargs)) if isinstance(t, DTensor)]
    pl = ds[0].placements
    if any(t.placements != pl for t in ds) or any(
            p.is_partial() or (p.is_shard() and p.dim != 0) for p in pl):
        return None
    mesh = ds[0].device_mesh
    n = 1
    for i, p in enumerate(pl):
        if p.is_shard():
            n *= mesh.size(i)
    rows = ds[0].shape[0]

    def local(x):
        # A plain tensor is implicitly replicated: its rows of this device.
        if isinstance(x, DTensor):
            return x.to_local()
        if isinstance(x, torch.Tensor) and x.ndim and x.shape[0] == rows:
            return x[: rows // n]
        if isinstance(x, dict):
            return {k: local(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(local(v) for v in x)
        return x

    out = func(*local(args), **local(kwargs))
    outs = out if isinstance(out, (list, tuple)) else [out]
    if any(o.ndim == 0 for o in outs):
        return None
    wrapped = [_wrap((o.shape[0] * n,) + tuple(o.shape[1:]), mesh, o,
                           pl) for o in outs]
    return type(out)(wrapped) if isinstance(out, (list, tuple)) else wrapped[0]


def _placed(args) -> str:
    """The shapes and placements of the DTensors in ``args``, for an
    error message."""
    return ", ".join(f"{tuple(a.shape)} {tuple(a.placements)}"
                     for a in _tensors(args) if isinstance(a, DTensor))


def _reduced(x):
    if isinstance(x, DTensor):
        if any(p.is_partial() for p in x.placements):
            return x.redistribute(x.device_mesh, [
                Replicate() if p.is_partial() else p for p in x.placements])
        return x
    if isinstance(x, dict):
        return {k: _reduced(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_reduced(v) for v in x)
    return x


class CommRecord(CommDebugMode):
    """A ``CommDebugMode`` that also keeps ``(op name, output bytes)`` of
    every collective it sees, in ``.collectives``.  It hands the collectives
    alone to ``CommDebugMode``'s own bookkeeping (``get_comm_counts``
    counts them): its record of every other op costs a trace of a step
    thousands of ops' worth of time and counts nothing."""

    def __init__(self):
        super().__init__()
        self.collectives = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        name = (func._overloadpacket._qualified_op_name
                if isinstance(func, torch._ops.OpOverload) else "")
        if collective_kind(name) is None:
            return func(*args, **(kwargs or {}))
        out = super().__torch_dispatch__(func, types, args, kwargs)
        self.collectives.append((name, sum(_nbytes(t)
                                           for t in _tensors(out))))
        return out


@dataclasses.dataclass
class Trace:
    """What one traced step counted on one device."""
    flops: int
    bytes: int
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    peak_bytes: int
    collectives: list
    seconds: float


def _dtensor(mesh, rules, dev, shape, dtype, spec):
    """A DTensor of global ``shape`` placed by ``spec`` whose local shard
    is a fake tensor on ``dev``."""
    local = torch.empty(local_shape(rules, shape, spec), dtype=dtype,
                        device=dev)
    return _wrap(shape, mesh, local, to_placements(mesh, spec))


def _place(mesh, rules, dev, tree, specs):
    """:func:`_dtensor` of every leaf of ``tree`` (anything with ``shape``
    and ``dtype``) at the matching spec of ``specs``."""
    if isinstance(tree, dict):
        return {k: _place(mesh, rules, dev, v, specs[k])
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place(mesh, rules, dev, v, s) for v, s in zip(tree, specs)]
    return _dtensor(mesh, rules, dev, tuple(tree.shape), tree.dtype, specs)


def _local_bytes(tree) -> int:
    return sum(_nbytes(t.to_local()) for t in leaves(tree))


def build_cell(arch: str, shape_name: str, mesh, *, n_layers=None,
               global_batch=None, microbatches=None, cfg_overrides=None,
               seq_len=None, device: str = "cuda"):
    """Returns ``(cell, meta)`` for one (arch × shape) cell on ``mesh`` (a
    ``DeviceMesh`` over a fake group): ``cell()`` builds the cell's state
    and runs its step under ``FakeTensorMode`` and returns a
    :class:`Trace` (:class:`Cell`).

    ``n_layers``/``global_batch``/``microbatches`` overrides exist for the
    calibrated cost model (:mod:`repro_torch.roofline.calibrate`), which
    probes at two layer counts and two batch sizes; ``cfg_overrides`` and
    ``seq_len`` for a cell cut to a size a real step can be held against.
    """
    register_kernel_rules()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if n_layers is not None:          # a probe's depth wins over overrides
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=global_batch)
    if seq_len is not None:
        shape = dataclasses.replace(shape, seq_len=seq_len)
    rules = ShardingRules(mesh=mesh, data_axes=data_axes_of(mesh),
                          fsdp=arch in FSDP_ARCHS)
    if cfg.is_moe:
        # Hierarchical MoE dispatch: one token group per DP shard.
        cfg = dataclasses.replace(cfg, moe_groups=rules.data_size)
    dev = trace_device(device)
    dcfg = DataConfig(
        seq_len=shape.seq_len, global_batch=shape.global_batch,
        vocab=cfg.vocab, frontend=cfg.frontend,
        n_frontend_tokens=cfg.n_frontend_tokens, d_model=cfg.d_model)
    fake = FakeTensorMode(allow_non_fake_inputs=False)

    with fake:
        shapes = init_params(cfg, torch.Generator())
    n_params = sum(t.numel() for t in leaves(shapes))
    expert_params = sum(
        t.numel() for lp in shapes["layers"] if "moe" in lp
        for k in ("w_in", "w_out") for t in [lp["moe"][k]])
    n_active = (n_params - expert_params
                + expert_params * cfg.top_k / max(cfg.n_experts, 1))

    meta = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "n_params": int(n_params), "n_params_active": int(n_active),
        "fsdp": rules.fsdp,
    }
    mb = TRAIN_MICROBATCHES if microbatches is None else microbatches
    tcfg = None
    if shape.kind == "train":
        ocfg = OptConfig(quantize_moments=arch in BIG_MOE,
                         scan_stacked=arch in BIG_MOE + FSDP_ARCHS)
        tcfg = TrainConfig(
            opt=ocfg, microbatches=mb,
            accum_dtype="bfloat16" if arch in BIG_MOE else "float32")
        meta["optimizer"] = ("adamw-int8" if ocfg.quantize_moments
                             else "adamw-f32")
        meta["microbatches"] = tcfg.microbatches
        meta["tokens"] = shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        meta["tokens"] = shape.global_batch * shape.seq_len
    else:
        meta["tokens"] = shape.global_batch

    cell = Cell(cfg, shape, rules, mesh, dev, fake, shapes, dcfg,
                tcfg)
    return cell, meta


class Cell:
    """One (arch × shape) cell on a mesh (:func:`build_cell`): its
    ``cfg``, ``shape`` and, training, ``tcfg``.  Calling it traces the step
    and returns a :class:`Trace`; :meth:`argument_bytes` builds the
    arguments alone."""

    def __init__(self, cfg, shape, rules, mesh, dev, fake, shapes, dcfg,
                 tcfg):
        self.cfg, self.shape, self.tcfg = cfg, shape, tcfg
        self.rules, self.mesh, self.dev, self.fake = rules, mesh, dev, fake
        self.shapes, self.dcfg = shapes, dcfg

    def _build(self):
        """``(run, args)``: the step as a thunk and the nests of its
        arguments (DTensors), made under the cell's fake mode."""
        cfg, shape, rules, mesh, dev = (self.cfg, self.shape, self.rules,
                                        self.mesh, self.dev)
        params = _place(mesh, rules, dev, self.shapes,
                        param_placements(rules, cfg, self.shapes))
        model = Model(cfg, device=dev, params=params)
        model.act_constraint = _Pin(mesh, rules.data_axes, rules.data_size)
        params = model.params()
        specs = make_batch_specs(self.dcfg)
        batch = {k: _dtensor(mesh, rules, dev, s.shape, s.dtype, sp)
                 for (k, s), sp in zip(specs.items(),
                                       batch_placements(rules,
                                                        specs).values())}
        if shape.kind == "train":
            for p in leaves(params):
                p.requires_grad_(True)
            opt_s = adamw_init(self.shapes, self.tcfg.opt)
            opt = _place(mesh, rules, dev, opt_s,
                         opt_placements(rules, cfg, opt_s, self.shapes))
            state = TrainState(params=params, opt=opt, ef=None)
            step = make_train_step(model, self.tcfg,
                                   split_microbatches=_split_local)
            return (lambda: step(state, batch)), [params, batch, opt]
        cache_s = make_cache(cfg, shape.global_batch, shape.seq_len, dev)
        cache = _place(mesh, rules, dev, cache_s,
                       cache_placements(rules, cfg, cache_s))
        if shape.kind == "prefill":
            return (lambda: model.prefill(batch, cache)), [params, batch,
                                                           cache]
        spec = BatchSpec((shape.global_batch, 1), torch.int32)
        tok = _dtensor(mesh, rules, dev, spec.shape, spec.dtype,
                       batch_placements(rules, {"t": spec})["t"])
        return ((lambda: model.decode(tok, shape.seq_len - 1, cache)),
                [params, {"tokens": tok}, cache])

    def argument_bytes(self) -> int:
        """One device's bytes of the step's arguments: parameters, moments
        and batch, or parameters, batch (decode: its tokens) and cache."""
        with self.fake:
            _, args = self._build()
            return sum(_local_bytes(a) for a in args)

    def __call__(self) -> Trace:
        t0 = time.perf_counter()
        with self.fake:
            run, args = self._build()
            arg_bytes = sum(_local_bytes(a) for a in args)
            arg_ids = {id(t.to_local().untyped_storage())
                       for a in args for t in leaves(a)}
            comm = CommRecord()
            cost = LocalCost()
            policy = PlacementPolicy(self.mesh, self.rules.data_axes,
                                     self.rules.data_size)
            with implicit_replication(), comm, cost, policy:
                out = run()
            outs = [t.to_local() if isinstance(t, DTensor) else t
                    for t in _tensors(out)]
            out_bytes = sum(_nbytes(t) for t in outs)
            alias = sum(_nbytes(t) for t in outs
                        if id(t.untyped_storage()) in arg_ids)
        return Trace(flops=cost.flops, bytes=cost.bytes,
                     argument_bytes=arg_bytes, output_bytes=out_bytes,
                     alias_bytes=alias, peak_bytes=arg_bytes + cost.peak,
                     collectives=comm.collectives,
                     seconds=time.perf_counter() - t0)


class _PinFn(torch.autograd.Function):
    """Redistribute to ``placements`` in the forward, and the gradient to
    the same placements in the backward (``with_sharding_constraint``'s
    transpose constrains the cotangent alike)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


class _Pin:
    """The dry run's ``act_constraint``: the residual stream ``[B, S, d]``
    before every layer batch-sharded on the data axes and replicated on the
    others, its gradient too.  The JAX package pins only the MoE models;
    DTensor, which picks each op's placement greedily where GSPMD plans the
    whole step, otherwise drifts the dense models' gradients onto the
    sequence."""

    def __init__(self, mesh, data_axes, data_size):
        self.placements = [Shard(0) if a in data_axes else Replicate()
                           for a in mesh.mesh_dim_names]
        self.data_size = data_size

    def __call__(self, x):
        if x.ndim == 3 and x.shape[0] % self.data_size == 0:
            return _PinFn.apply(x, self.placements)
        return x


def _split_local(x, nmb: int):
    """``x [B, ...]`` as ``[nmb, B / nmb, ...]`` with each device's rows
    kept on it: its local ``[B / D, ...]`` rows regrouped into ``nmb``
    microbatches, placed as ``x`` was with the batch dim moved to dim 1.  It
    moves nothing (a data loader hands each device its microbatches so);
    on a mesh of one device it is the plain reshape."""
    local = x.to_local()
    parts = local.reshape((nmb, local.shape[0] // nmb) + local.shape[1:])
    placements = [Shard(p.dim + 1) if isinstance(p, Shard) else p
                  for p in x.placements]
    return DTensor.from_local(parts, x.device_mesh, placements,
                              run_check=False)


def cell_result(trace: Trace, meta: Dict, multi_pod: bool,
                build_s: float) -> Dict:
    """The JSON record of a traced cell (the JAX package's fields)."""
    coll = collective_bytes(trace.collectives)
    flops, bytes_acc = float(trace.flops), float(trace.bytes)
    terms = roofline_terms(flops, bytes_acc, coll["weighted_bytes"])
    n_chips = 1
    for v in meta["mesh"].values():
        n_chips *= v
    model_fl = (6.0 if meta["kind"] == "train" else 2.0) * \
        meta["n_params_active"] * meta["tokens"]
    temp = (trace.peak_bytes - trace.argument_bytes
            - (trace.output_bytes - trace.alias_bytes))
    device_bytes = (trace.argument_bytes + trace.output_bytes + temp
                    - trace.alias_bytes)
    return {
        **meta,
        "multi_pod": multi_pod,
        "lower_s": round(build_s, 2),
        "compile_s": round(trace.seconds, 2),
        "memory": {
            "argument_bytes": trace.argument_bytes,
            "output_bytes": trace.output_bytes,
            "temp_bytes": temp,
            "alias_bytes": trace.alias_bytes,
            "per_device_bytes": device_bytes,
            "fits_hbm": bool(device_bytes <= HW["hbm_bytes"]),
        },
        "cost": {"flops_per_device": flops, "bytes_per_device": bytes_acc},
        "collectives": coll,
        "roofline": terms,
        "model_flops_total": model_fl,
        "model_flops_per_device": model_fl / n_chips,
        "useful_flop_ratio": (model_fl / n_chips) / flops if flops else 0.0,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             device: str = "cuda") -> Dict:
    """Trace one cell on the production mesh (a fake group of 256 ranks, or
    512 ``multi_pod``) and return its record."""
    n = 1
    for s in production_shape(multi_pod)[0]:
        n *= s
    with fake_world(n):
        mesh = make_production_mesh(
            multi_pod=multi_pod, device_type="cpu" if device == "cpu"
            else "cuda")
        t0 = time.perf_counter()
        cell, meta = build_cell(arch, shape_name, mesh, device=device)
        build_s = time.perf_counter() - t0
        return cell_result(cell(), meta, multi_pod, build_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_NAMES)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="trace the card's path (default; needs no card) "
                         "or the plain path")
    args = ap.parse_args(argv)

    cells = []
    archs = ARCH_NAMES if (args.all or args.arch is None) else [args.arch]
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([args.shape] if args.shape else list(SHAPES))
        for sh in shapes:
            cells.append((arch, sh, skip_reason(cfg, sh)))

    if args.list:
        for arch, sh, reason in cells:
            print(f"{arch:24s} {sh:12s} "
                  f"{'SKIP: ' + reason if reason else 'RUN'}")
        return

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}
    failures = 0
    for arch, sh, reason in cells:
        if reason:
            _write(args.out, arch, sh, "any",
                   {"arch": arch, "shape": sh, "skipped": reason})
            print(f"SKIP {arch} {sh}: {reason}")
            continue
        for mp in meshes[args.mesh]:
            tag = "multi" if mp else "single"
            try:
                res = run_cell(arch, sh, mp, device=args.device)
                _write(args.out, arch, sh, tag, res)
                r = res["roofline"]
                print(f"OK   {arch} {sh} [{tag}] compile={res['compile_s']}s "
                      f"bytes/dev={res['memory']['per_device_bytes']/1e9:.2f}GB "
                      f"dominant={r['dominant']} "
                      f"frac={r['roofline_fraction']:.3f}", flush=True)
            except Exception as e:  # a failed cell is recorded, the rest run
                failures += 1
                _write(args.out, arch, sh, tag,
                       {"arch": arch, "shape": sh, "mesh": tag,
                        "error": str(e),
                        "traceback": traceback.format_exc()})
                print(f"FAIL {arch} {sh} [{tag}]: {e}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


def _write(out, arch, sh, tag, payload):
    fn = os.path.join(out, f"{arch}__{sh}__{tag}.json")
    with open(fn, "w") as f:
        json.dump(payload, f, indent=1)


if __name__ == "__main__":
    main()
