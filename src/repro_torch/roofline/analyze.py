"""Roofline analysis of a dry-run step: the port of
``repro/roofline/analyze.py``.

Three terms per (arch × shape × mesh), in seconds, all per device:

  compute    = flops / peak_flops
  memory     = bytes accessed / hbm_bw
  collective = collective bytes / link_bw

The dry run (:mod:`repro_torch.launch.dryrun`) counts a traced step's flops
and bytes on each device's own shards; :func:`collective_bytes` sums the
collectives DTensor issued in it (``CommDebugMode`` sees them), each
collective's **output** bytes on one device, all-reduce weighted 2× (its
ring realisation moves about twice the payload: a reduce-scatter and an
all-gather).

:data:`HW` is one NVIDIA H100 SXM's data-sheet figures (dense bf16 on the
tensor cores, HBM3, NVLink 4 each way); every function takes the hardware
as an argument, ``hw=HW`` by default.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from ..tree import leaves

# NVIDIA H100 SXM (NVIDIA's data sheet, 700 W): bf16 dense FLOP/s, HBM3
# bytes/s, NVLink bytes/s each way; and the device memory that
# ``torch.cuda.get_device_properties(0).total_memory`` read on the card
# ("NVIDIA H100 80GB HBM3, 700.00 W" as nvidia-smi gives its name and power
# limit; torch 2.11.0+cu128).
HW = {
    "peak_flops": 989e12,
    "hbm_bw": 3.35e12,
    "link_bw": 450e9,
    "hbm_bytes": 85_017_493_504,
}

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# The collectives DTensor issues (``torch.ops._c10d_functional`` and the
# c10d ops), by op name, and the kind each is.
_OP_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "send_": "collective-permute",
    "permute_tensor": "collective-permute",
}


def collective_kind(op_name: str):
    """The kind of the collective op ``op_name`` (``"ns::name"`` or
    ``"name"``), or None for an op that is no collective."""
    return _OP_KINDS.get(op_name.split("::")[-1].split(".")[0])


def collective_bytes(record: Iterable[Tuple[str, int]]) -> Dict:
    """Per-kind per-device collective output bytes of a traced step.
    ``record`` holds ``(op name, output bytes on one device)`` for each
    collective the step issued, as the dry run's ``CommRecord`` (a
    ``CommDebugMode``) keeps them; ops of no collective kind are ignored."""
    out = {k: 0 for k in _COLL_KINDS}
    count = {k: 0 for k in _COLL_KINDS}
    for name, nbytes in record:
        kind = collective_kind(name)
        if kind is None:
            continue
        out[kind] += int(nbytes)
        count[kind] += 1
    return {
        "bytes_by_kind": out,
        "count_by_kind": count,
        "weighted_bytes": sum(
            b * (2 if k == "all-reduce" else 1) for k, b in out.items()),
    }


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   hw: Dict = HW) -> Dict[str, float]:
    """All inputs per-device; returns seconds per term + the bottleneck."""
    t_c = flops / hw["peak_flops"]
    t_m = bytes_accessed / hw["hbm_bw"]
    t_x = coll_bytes / hw["link_bw"]
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x}
    dominant = max(terms, key=terms.get)
    bound = max(t_c, t_m, t_x)
    terms["dominant"] = dominant.replace("_s", "")
    terms["step_lower_bound_s"] = bound
    terms["roofline_fraction"] = (t_c / bound) if bound > 0 else 0.0
    return terms


def analytic_bytes_floor(kind: str, *, n_params: int, n_active: int,
                         n_layers: int, d_model: int, vocab: int,
                         tokens: int, n_mb: int, n_chips: int,
                         cache_bytes: int = 0, opt_bytes_per_param: int = 16,
                         param_bytes: int = 2) -> float:
    """Physical lower bound on per-device HBM traffic for one step.

    The traced ``bytes accessed`` sums every op's operand and output bytes
    and so over-counts what a fused step moves; this floor counts only the
    unavoidable streams: parameter reads (per microbatch, fwd+bwd),
    gradient and optimizer-state read/write, saved layer activations (write
    + read), logits, and KV/state-cache traffic for serving.  True HBM time
    lies between this floor and the traced figure.
    """
    p_loc = n_params / n_chips
    act_loc = n_active / n_chips
    tok_loc = tokens / n_chips
    if kind == "train":
        # fwd+bwd param reads per microbatch (active params only for MoE),
        # grad accum rw, opt state rw, param update rw.
        b = 2 * act_loc * param_bytes * 2 * n_mb
        b += p_loc * (4 * 2 + opt_bytes_per_param)      # grads + m/v
        b += p_loc * param_bytes * 2                     # param update
        b += n_layers * tok_loc * d_model * 2 * 2        # residuals w+r
        b += (tokens * vocab * 4 / n_chips) * 2          # f32 logits w+r
        return b
    # serving: one param read + cache traffic (+ logits for prefill)
    b = act_loc * param_bytes
    b += cache_bytes / n_chips * (2 if kind == "prefill" else 1)
    if kind == "prefill":
        b += tokens * d_model * 2 / n_chips * 2 * n_layers
    return b


def model_flops(cfg, shape, n_params_active: float) -> float:
    """MODEL_FLOPS: 6·N·D train (fwd+bwd), 2·N·D forward-only."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_params_active * tokens


def count_params(tree) -> int:
    """Elements of every leaf of a nest of tensors (the model's
    :meth:`~repro_torch.models.Model.params`; a DTensor counts its global
    shape)."""
    return sum(_prod(leaf.shape) for leaf in leaves(tree))


def active_param_fraction(cfg) -> float:
    """Fraction of parameters active per token: 1 for a dense model, and
    for an MoE model -1, the dry run counting the active parameters from
    the parameter groups' sizes (``launch/dryrun.py``)."""
    return 1.0 if not cfg.is_moe else -1.0


def _prod(t) -> int:
    out = 1
    for x in t:
        out *= int(x)
    return out
