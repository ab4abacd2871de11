"""DTensor sharding rules of the kernels' custom ops.

Kernels 5, 6 and 7 and their backwards are local on the batch and on the
heads (the channels for kernel 7): a device that holds a slice of either
computes its slice of the outputs from its slices of the operands alone.
:func:`local_rule` turns that into the strategies
``torch.distributed.tensor.experimental.register_sharding`` takes, and no
others: an axis is offered only where its sizes divide every mesh dim (no
uneven split of a GQA group is guessed), and a kernel never runs on a slice
of the sequence or the head dim.  An operand that arrives placed otherwise
(a gradient DTensor left sharded on the sequence, or an unreduced partial
sum) is redistributed by DTensor to one of the offered strategies first,
and the collective that costs shows in the dry run's record.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

# Per axis: the dim of each positional argument that carries it (None: the
# argument does not, or is no tensor) and the placement of each output (an
# int: sharded on that dim; "partial": summed over the axis; None:
# replicated).
Axes = Dict[str, Tuple[Sequence, Sequence]]


def local_rule(op: str, args: Sequence, axes: Axes) -> list:
    """The acceptable ``(output placements, input placements)`` of ``op``
    called on ``args`` (DTensor specs where the op takes a tensor): every
    operand and output replicated, or for each axis of ``axes`` whose sizes
    divide every mesh dim's, the operands sharded on that axis's dims and
    the outputs placed as ``axes`` says.  Raises ``ValueError`` when no
    operand is a DTensor."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    specs = [(i, a) for i, a in enumerate(args) if hasattr(a, "placements")]
    if not specs:
        raise ValueError(f"{op}: no DTensor operand")
    mesh = specs[0][1].mesh

    def dim(dims, i):
        return dims[i] if i < len(dims) else None

    n_out = len(next(iter(axes.values()))[1])
    out = [([Replicate()] * n_out,
            [Replicate() if hasattr(a, "placements") else None
             for a in args])]
    for in_dims, out_pl in axes.values():
        sizes = [args[i].shape[dim(in_dims, i)] for i, _ in specs
                 if dim(in_dims, i) is not None]
        if any(n % m for n in sizes for m in mesh.shape):
            continue
        ins = [None if not hasattr(a, "placements") else
               (Replicate() if dim(in_dims, i) is None
                else Shard(dim(in_dims, i)))
               for i, a in enumerate(args)]
        outs = [Replicate() if p is None else
                Partial() if p == "partial" else Shard(p) for p in out_pl]
        out.append((outs, ins))
    return out


def register(op, axes: Axes) -> None:
    """Register :func:`local_rule` with ``axes`` for ``op`` (an
    ``OpOverload``) with DTensor."""
    from torch.distributed.tensor.experimental import register_sharding

    name = str(op)

    @register_sharding(op)
    def _(*args, **kwargs):
        return local_rule(name, args, axes)
