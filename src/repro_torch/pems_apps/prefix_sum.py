"""CGM inclusive prefix sum on PEMS (thesis §8.4.2).

Three virtual supersteps: local total → Gather at root → root prefix-sums the
v totals → Bcast offsets → local cumsum + offset.  Communication volume is
O(v) independent of n, which is why this application benefits most from the
``sliced`` driver (the data field is only touched in the first and last
superstep — cf. Fig 8.14's flat mmap curves).

The stages take the round's ``k`` contexts at once (``rhos [k]``, a batched
:class:`~repro_torch.core.Ctx`).  Sums wrap at 32 bits, as ``jnp.cumsum`` of
int32 does: torch sums int32 into int64, and the cast back keeps the low
word, which is the same bits whatever the order of the additions.
"""

from __future__ import annotations

import torch

from ..core import ContextLayout, Pems, PemsConfig, resolve_device


def _build(v: int, k: int, n_v: int, driver: str, tier: str = "device",
           backing_path=None, device_cap_bytes=None,
           io_driver=None, io_queue_depth=None, device=None):
    lo = (
        ContextLayout()
        .add("x", (n_v,), torch.int32)
        .add("tot", (1,), torch.int32)
        .add("atot", (v, 1), torch.int32)
        .add("offs", (v,), torch.int32)
        .add("res", (n_v,), torch.int32)
    )
    io_kw = {}
    if io_driver is not None:
        io_kw["io_driver"] = io_driver
    if io_queue_depth is not None:
        io_kw["io_queue_depth"] = io_queue_depth
    pems = Pems(PemsConfig(v=v, k=k, driver=driver, tier=tier,
                           backing_path=backing_path,
                           device_cap_bytes=device_cap_bytes, **io_kw), lo,
                device=device)

    def local_total(rhos, ctx):
        tot = ctx.get("x").sum(dim=1).to(torch.int32)
        return ctx.set("tot", tot[:, None])

    def root_prefix(rhos, ctx):
        tots = ctx.get("atot")[:, :, 0]         # [k, v]
        offs = torch.cumsum(tots, dim=1) - tots  # exclusive prefix of totals
        return ctx.set("offs", offs.to(torch.int32))

    def local_prefix(rhos, ctx):
        x = ctx.get("x")                         # [k, n_v]
        rows = torch.arange(ctx.k, device=x.device)
        off = ctx.get("offs")[rows, rhos.to(torch.int64)]
        res = torch.cumsum(x, dim=1) + off[:, None]
        return ctx.set("res", res.to(torch.int32))

    def program(blocks):
        store = pems.init().with_field("x", blocks)
        store = pems.superstep(store, local_total,
                               reads=["x"], writes=["tot"])
        store = pems.gather(store, "tot", "atot", root=0)
        store = pems.superstep(store, root_prefix,
                               reads=["atot"], writes=["offs"])
        store = pems.bcast(store, "offs", root=0)
        store = pems.superstep(store, local_prefix,
                               reads=["x", "offs"], writes=["res"])
        return store.field("res")

    return pems, program


def prefix_sum(x, v: int, k: int = 1, driver: str = "explicit",
               return_pems: bool = False, tier: str = "device",
               backing_path=None, device_cap_bytes=None,
               io_driver=None, io_queue_depth=None, device=None):
    """Inclusive prefix sum of int32 ``x`` ([n], n divisible by v) on PEMS,
    wrapping at 32 bits.

    Same arguments and results as ``repro.pems_apps.prefix_sum``, plus
    ``device``: where the stages run, CUDA by default, ``"cpu"`` for the
    plain PyTorch paths.  On the device tier the result is a tensor on
    ``device``; on a backing tier (``"host"``, ``"memmap"``, ``"file"``,
    ``k`` contexts on the device at a time under ``device_cap_bytes``) it
    is a CPU tensor, as the population lives there.  Every tier and driver
    gives the same bits.

    Raises ``ValueError`` for n not divisible by v (and for any invalid
    :class:`~repro_torch.core.PemsConfig` combination), ``RuntimeError``
    when CUDA is asked for and missing.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x)
    x = x.to(device=dev if tier == "device" else x.device, dtype=torch.int32)
    n = x.shape[0]
    if n % v:
        raise ValueError(f"n={n} must be divisible by v={v}")
    pems, program = _build(v, k, n // v, driver, tier=tier,
                           backing_path=backing_path,
                           device_cap_bytes=device_cap_bytes,
                           io_driver=io_driver,
                           io_queue_depth=io_queue_depth, device=dev)
    res = program(x.reshape(v, n // v)).reshape(-1)
    if return_pems:
        return res, pems
    return res
