"""The real processors of a ``P > 1`` simulation, and their exchange.

The JAX package runs ``P`` real processors as one program over a
``jax.sharding.Mesh`` (``shard_map`` over the ``vp`` axis, the network phase
through ``lax.all_to_all``).  The port keeps that single-controller shape: a
:class:`Mesh` names ``P`` device entries along one axis, the store stays one
``[v, words]`` tensor, and real processor ``p`` owns its rows ``[p·m,
(p+1)·m)`` with ``m = v/P``.  When every entry names the same device (the
only mesh ported so far) the network phase needs no exchange of its own:
the fused Alltoallv lands each message in its receiver's rows from the
sender's (``core/collectives.py``), and only the dense route's transpose
ships through :meth:`Mesh.all_to_all`, a copy between row blocks in that
device's memory.  A mesh over several cards (row blocks on distinct
devices, the exchange by peer copies or NCCL) replaces
:meth:`Mesh.all_to_all` and ships the fused route's staged chunks through
it; until then it raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .context import resolve_device

MULTI_DEVICE_ITEM = "queue 1 item 7b (a mesh over several cards)"


def canonical(device) -> torch.device:
    """``device`` with the current CUDA device's index filled in, so that
    ``"cuda"`` and ``"cuda:0"`` compare equal where they are one card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """``P`` device entries along one named axis — the part of
    ``jax.sharding.Mesh`` the executor reads: ``.shape[axis]``,
    ``.axis_names`` and ``.devices``."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str] = ("vp",)):
        if len(axis_names) != 1:
            raise ValueError(f"a mesh has one axis, got {axis_names!r}")
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    def __repr__(self) -> str:
        return f"Mesh({self.axis_names[0]}={len(self.devices)}, " \
               f"devices={[str(d) for d in self.devices]})"

    def device(self) -> torch.device:
        """The one device every entry names; ``NotImplementedError`` for a
        mesh over several devices."""
        first = self.devices[0]
        if any(d != first for d in self.devices[1:]):
            raise NotImplementedError(
                f"{self!r} spans several devices; the port runs a mesh on "
                f"one device so far, ROADMAP.md {MULTI_DEVICE_ITEM} brings "
                "the rest")
        return canonical(first)

    def all_to_all(self, send: torch.Tensor, recv: torch.Tensor) -> None:
        """The network phase (``lax.all_to_all`` in the JAX package):
        ``send[q, p]`` is what process ``q`` ships to process ``p``; after
        the call ``recv[p, q]`` holds it.  Both are ``[P, P, ...]`` and may
        be strided views (``recv`` usually views the destination rows of the
        store, so the message lands where it is read).  On a one-device
        mesh this is one copy in that device's memory."""
        n = len(self.devices)
        if send.shape[:2] != (n, n) or recv.shape != send.transpose(
                0, 1).shape:
            raise ValueError(
                f"all_to_all over {n} processes: send {tuple(send.shape)} "
                f"and recv {tuple(recv.shape)} must be [P, P, ...] and its "
                "transpose")
        self.device()                          # one device only, so far
        recv.copy_(send.transpose(0, 1))


def make_mesh(P: int, axis: str = "vp", device=None) -> Mesh:
    """A mesh of ``P`` real processors on one device (CUDA unless ``device``
    names another; ``RuntimeError`` when CUDA is asked for and missing)."""
    if P < 1:
        raise ValueError(f"P={P} must be >= 1")
    return Mesh([resolve_device(device)] * P, (axis,))
