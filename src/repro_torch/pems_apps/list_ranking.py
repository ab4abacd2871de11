"""CGM list ranking on PEMS via pointer jumping (used by the Euler-tour
application, thesis §8.4.3; CGMLib provides the same primitive).

Each of ⌈log₂ n⌉ rounds is a request/response pair of Alltoallvs: every
element asks the owner of its successor for ``(rank[succ], succ[succ])`` and
then jumps.  Terminals are fixpoints (``succ[i] == i``); on convergence
``rank[i]`` is the number of hops from i to its list's terminal — for a
forest of lists every list is ranked independently (exactly what the Euler
tour needs).

The stages take the round's ``k`` contexts at once (``rhos [k]``, a batched
:class:`~repro_torch.core.Ctx`).  In direct mode on a CUDA store each
Alltoallv is one launch of the delivery kernel
(:mod:`repro_torch.kernels.alltoallv_deliver`): two a round.
"""

from __future__ import annotations

import math

import torch

from ..core import ContextLayout, Pems, PemsConfig, resolve_device
from .common import group_by_dest, take_from_slots


def _build(v: int, k: int, n_v: int, rounds: int, driver: str, mode: str,
           device=None):
    cap = n_v  # worst case: all of a VP's successors live on one owner
    lo = (
        ContextLayout()
        .add("succ", (n_v,), torch.int32)
        .add("rank", (n_v,), torch.int32)
        .add("dest", (n_v,), torch.int32)
        .add("spos", (n_v,), torch.int32)
        .add("qs", (v, cap), torch.int32)    # request send (global indices)
        .add("qscnt", (v,), torch.int32)
        .add("qr", (v, cap), torch.int32)    # request recv
        .add("qrcnt", (v,), torch.int32)
        .add("as_", (v, cap, 2), torch.int32)  # answer send (rank, succ)
        .add("ascnt", (v,), torch.int32)
        .add("ar", (v, cap, 2), torch.int32)   # answer recv
        .add("arcnt", (v,), torch.int32)
    )
    pems = Pems(PemsConfig(v=v, k=k, driver=driver), lo, device=device)
    lane = torch.arange(n_v, dtype=torch.int32, device=pems.device)

    def make_requests(rhos, ctx):
        succ = ctx.get("succ")                 # [k, n_v]
        dest = succ // n_v
        msgs, counts, spos, _ = group_by_dest(succ, dest, v, cap)
        return (ctx.set("qs", msgs).set("qscnt", counts)
                .set("dest", dest).set("spos", spos))

    def answer(rhos, ctx):
        req = ctx.get("qr")                    # [k, v, cap] global indices
        local = torch.clamp(req - rhos[:, None, None] * n_v, 0, n_v - 1)
        local = local.reshape(ctx.k, v * cap).to(torch.int64)
        r = torch.gather(ctx.get("rank"), 1, local)
        s = torch.gather(ctx.get("succ"), 1, local)
        ans = torch.stack([r, s], dim=-1)      # [k, v·cap, 2]
        return ctx.set("as_", ans).set("ascnt", ctx.get("qrcnt"))

    def jump(rhos, ctx):
        got = take_from_slots(ctx.get("ar"), ctx.get("dest"),
                              ctx.get("spos"))  # [k, n_v, 2]
        succ = ctx.get("succ")
        rank = ctx.get("rank")
        live = succ != rhos[:, None] * n_v + lane
        rank = torch.where(live, rank + got[..., 0], rank)
        succ = torch.where(live, got[..., 1], succ)
        return ctx.set("succ", succ).set("rank", rank)

    def program(succ_blocks):
        store = pems.init().with_field("succ", succ_blocks)
        gid = torch.arange(v * n_v, dtype=torch.int32,
                           device=pems.device).reshape(v, n_v)
        store = store.with_field("rank", (succ_blocks != gid).to(torch.int32))
        for _ in range(rounds):
            store = pems.superstep(store, make_requests,
                                   reads=["succ"],
                                   writes=["qs", "qscnt", "dest", "spos"])
            store = pems.alltoallv(store, "qs", "qr", "qscnt", "qrcnt",
                                   mode=mode)
            store = pems.superstep(store, answer,
                                   reads=["qr", "qrcnt", "rank", "succ"],
                                   writes=["as_", "ascnt"])
            store = pems.alltoallv(store, "as_", "ar", "ascnt", "arcnt",
                                   mode=mode)
            store = pems.superstep(store, jump,
                                   reads=["ar", "dest", "spos", "succ",
                                          "rank"],
                                   writes=["succ", "rank"])
        return store.field("rank"), store.field("succ")

    return pems, program


def list_rank(succ, v: int, k: int = 1, driver: str = "explicit",
              mode: str = "direct", return_pems: bool = False, device=None):
    """Rank the linked list(s) ``succ`` ([n] global successor indices,
    terminals are self-loops).  Returns ``rank`` ([n] int32: hops to
    terminal), a tensor on ``device``.

    Same arguments and results as ``repro.pems_apps.list_rank``, on the
    device tier, plus ``device``: CUDA by default (the Alltoallvs' delivery
    kernel launches there in direct mode), ``"cpu"`` for the plain PyTorch
    paths.  ``mode`` picks PEMS2 direct delivery or the PEMS1 indirect
    baseline for both Alltoallvs of every round.

    Raises ``ValueError`` for n not divisible by v, ``RuntimeError`` when
    CUDA is asked for and missing.
    """
    dev = resolve_device(device)
    succ = torch.as_tensor(succ).to(device=dev, dtype=torch.int32)
    n = succ.shape[0]
    if n % v:
        raise ValueError(f"n={n} must be divisible by v={v}")
    n_v = n // v
    rounds = max(1, math.ceil(math.log2(n)))
    pems, program = _build(v, k, n_v, rounds, driver, mode, device=dev)
    rank, _ = program(succ.reshape(v, n_v))
    rank = rank.reshape(-1)
    if return_pems:
        return rank, pems
    return rank
