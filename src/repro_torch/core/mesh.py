"""The real processors of a ``P > 1`` simulation, and their exchange.

The JAX package runs ``P`` real processors as one program over a
``jax.sharding.Mesh`` (``shard_map`` over the ``vp`` axis, the network phase
through ``lax.all_to_all``).  The port keeps that single-controller shape: a
:class:`Mesh` names ``P`` device entries along one axis, and real processor
``p`` owns the contexts ``[p·m, (p+1)·m)`` with ``m = v/P``.  It takes two
forms:

* **One device** (every entry the same, :func:`make_mesh`): the store stays
  one ``[v, words]`` tensor whose row blocks are the processes.  The fused
  Alltoallv lands each message in its receiver's rows from the sender's
  (``core/collectives.py``), and only the dense route's transpose ships
  through :meth:`Mesh.all_to_all`, one copy in that device's memory.
* **A mesh of cards** (distinct entries, ``Mesh(["cuda:0", ..., "cuda:3"])``,
  :attr:`Mesh.spans_devices`): process ``p``'s row block lives only on
  ``devices[p]`` (a :class:`~.context.MeshStore`), one process drives every
  card, and the network phase copies between cards (``Tensor.copy_``, a peer
  copy over NVLink where peer access is on): the fused Alltoallv stages each
  sender's chunk on its own card with kernel 4 and ships each ``(q, p)``
  slab to card ``p``, and :meth:`Mesh.all_to_all` moves per-card blocks.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .context import resolve_device


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
    ``.axis_names`` and ``.devices``.  The entries name one device, or a
    distinct device each (a mesh of cards: all of one type, CUDA cards by
    index); ``ValueError`` for anything between."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str] = ("vp",)):
        if len(axis_names) != 1:
            raise ValueError(f"a mesh has one axis, got {axis_names!r}")
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        first = self.devices[0]
        if any(d != first for d in self.devices[1:]) and (
                len(set(self.devices)) != len(self.devices)
                or any(d.type != first.type for d in self.devices)
                or any(d.type == "cuda" and d.index is None
                       for d in self.devices)):
            raise ValueError(
                f"{self!r}: a mesh names one device, or a distinct device "
                "each (one type, CUDA cards by index)")

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def spans_devices(self) -> bool:
        """Whether the entries are distinct devices: each process's row
        block then lives on its own card, and the network phase copies
        between cards."""
        return len(self.devices) > 1 and self.devices[1] != self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({self.axis_names[0]}={len(self.devices)}, " \
               f"devices={[str(d) for d in self.devices]})"

    def all_to_all(self, send, recv) -> None:
        """The network phase (``lax.all_to_all`` in the JAX package):
        ``send[q][p]`` is what process ``q`` ships to process ``p``; after
        the call ``recv[p][q]`` holds it.

        On a one-device mesh both are ``[P, P, ...]`` tensors and may be
        strided views (``recv`` usually views the destination rows of the
        store, so the message lands where it is read): one copy in that
        device's memory.  On a mesh of cards they are per-card blocks:
        ``send[q]`` lies on card ``q`` and ``recv[p]`` on card ``p`` (each a
        sequence of ``P`` tensors, or a ``[P, ...]`` tensor), and each pair
        is copied from card ``q`` to card ``p``, ``P − 1`` of each card's
        ``P`` off the card, in rounds ``p = q + r (mod P)``; a slab whose
        rows lie apart (a view of the receiver's recv rows) goes row by
        row, each row one contiguous copy.

        Nothing waits on the host.  A copy between cards runs on the source
        card's current stream after the destination's current stream's
        queued work, and the destination's current stream waits for it
        (``Tensor.copy_``'s two-way barrier).  So each off-card pair is
        copied between two streams of its own, one on each card, each of
        which first waits for its card's queued work: no pair's copy queues
        behind another's.  Both cards' current streams wait for them before
        the call returns, so later work (reading ``recv``, freeing or
        refilling ``send``) comes after them."""
        n = len(self.devices)
        if not self.spans_devices:
            if not (isinstance(send, torch.Tensor)
                    and isinstance(recv, torch.Tensor)) \
                    or send.shape[:2] != (n, n) \
                    or recv.shape != send.transpose(0, 1).shape:
                raise ValueError(
                    f"all_to_all over {n} processes of one device: send and "
                    "recv must be [P, P, ...] tensors, each the other's "
                    "transpose")
            recv.copy_(send.transpose(0, 1))
            return
        if len(send) != n or len(recv) != n:
            raise ValueError(f"all_to_all over {n} cards takes {n} send and "
                             f"{n} recv blocks, got {len(send)} and "
                             f"{len(recv)}")
        for q in range(n):
            for p in range(n):
                if send[q][p].shape != recv[p][q].shape:
                    raise ValueError(
                        f"all_to_all: send[{q}][{p}] "
                        f"{tuple(send[q][p].shape)} and recv[{p}][{q}] "
                        f"{tuple(recv[p][q].shape)} differ")
        for q in range(n):
            _copy(recv[q][q], send[q][q])
        side = []
        for r in range(1, n):
            for q in range(n):
                p = (q + r) % n
                src, dst = send[q][p], recv[p][q]
                if not src.is_cuda:
                    _copy(dst, src)
                    continue
                streams = []
                for dev in (dst.device, src.device):
                    main = torch.cuda.current_stream(dev)
                    stream = torch.cuda.Stream(dev)
                    stream.wait_stream(main)
                    streams.append(stream)
                    side.append((main, stream))
                with torch.cuda.stream(streams[0]), \
                        torch.cuda.stream(streams[1]):
                    _copy(dst, src)
        for main, stream in side:
            main.wait_stream(stream)


def _copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; row by row where ``dst``'s rows are each
    contiguous but lie apart, so that each is one contiguous copy."""
    if dst.dim() > 1 and not dst.is_contiguous() and dst[0].is_contiguous():
        for a, b in zip(dst, src):
            a.copy_(b)
    else:
        dst.copy_(src)


def make_mesh(P: int, axis: str = "vp", device=None) -> Mesh:
    """A mesh of ``P`` real processors on one device (CUDA unless ``device``
    names another; ``RuntimeError`` when CUDA is asked for and missing).  A
    mesh of cards is ``Mesh(["cuda:0", ..., f"cuda:{P - 1}"])``."""
    if P < 1:
        raise ValueError(f"P={P} must be >= 1")
    return Mesh([resolve_device(device)] * P, (axis,))
