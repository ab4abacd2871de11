"""Virtual-processor contexts: allocator, layout, store and views.

The thesis stores each virtual processor's memory (its *context*, size μ) in
external memory and swaps it into one of ``k`` partitions.  PEMS2 replaces the
bump allocator of PEMS1 with offset/size records and a free list so memory can
be freed and reused, and so swapping touches only *live* bytes (§6.6).

An :class:`Allocator` hands out word offsets inside the context, and a
:class:`ContextLayout` maps field names to ``(offset, shape, dtype)``.  The
whole population of contexts is a single ``[v, words]`` tensor (the
:class:`ContextStore`) on one device — that tensor *is* the external memory —
or, over a mesh of cards, one ``[v/P, words]`` row block a card (the
:class:`MeshStore`).

Store words are ``torch.int32``: torch's ``uint32`` has no comparison or
``searchsorted`` on the CPU, and 4-byte words keep the typed views exact
bitcasts (``Tensor.view(dtype)``) for the float32/int32/uint32 payloads of the
BSP applications.  The JAX package keeps the same bits as ``uint32``
(:mod:`repro_torch.interop` converts between the two).

Unlike the JAX package, whose arrays are immutable, the port updates the store
**in place**: ``ContextStore.with_field``/``with_field_words`` and ``Ctx.set``
write into the tensor they wrap and return a view over the same storage.  At
full scale the store is tens of GiB, so a functional copy per update is not an
option.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

WORD = 4  # bytes per store word

_DTYPES = {
    "float32": torch.float32, "int32": torch.int32, "uint32": torch.uint32,
}


def as_dtype(dtype) -> torch.dtype:
    """The torch dtype named by ``dtype`` (a torch dtype, a numpy dtype or a
    name); raises ``TypeError`` for anything but the 4-byte field types."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).rsplit(".", 1)[-1]
    else:
        name = np.dtype(dtype).name
    if name not in _DTYPES:
        raise TypeError(f"context fields must be 4-byte dtypes, got {name}")
    return _DTYPES[name]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises ``RuntimeError`` when CUDA is asked for (explicitly or
    by default) and is not available — there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on the GPU by default — "
            "pass device='cpu' to run the plain PyTorch paths")
    return dev


# --------------------------------------------------------------------------- #
# Allocator (§6.6)                                                             #
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class _Chunk:
    offset: int
    size: int


class Allocator:
    """First-fit free-list allocator with merge-on-free (thesis §6.6).

    Offsets/sizes are in words.  ``live_words`` lets the swap engine move only
    allocated bytes, reproducing the PEMS2 "swap only allocated regions"
    optimisation.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._free: List[_Chunk] = [_Chunk(0, self.capacity)]
        self._allocated: Dict[int, int] = {}  # offset -> size

    def alloc(self, size: int) -> int:
        size = int(size)
        if size <= 0:
            raise ValueError(f"allocation size must be positive, got {size}")
        # First fit, scanning from the lowest address (§6.6).
        for i, chunk in enumerate(self._free):
            if chunk.size >= size:
                offset = chunk.offset
                if chunk.size == size:
                    self._free.pop(i)
                else:
                    chunk.offset += size
                    chunk.size -= size
                self._allocated[offset] = size
                return offset
        raise MemoryError(
            f"context exhausted: requested {size} words, "
            f"free={self.free_words} of {self.capacity}"
        )

    def free(self, offset: int) -> None:
        size = self._allocated.pop(offset, None)
        if size is None:
            raise ValueError(f"free of unallocated offset {offset}")
        # Insert sorted and merge with adjacent free chunks.
        new = _Chunk(offset, size)
        idx = 0
        while idx < len(self._free) and self._free[idx].offset < offset:
            idx += 1
        self._free.insert(idx, new)
        self._merge(idx)
        if idx > 0:
            self._merge(idx - 1)

    def _merge(self, i: int) -> None:
        while i + 1 < len(self._free):
            a, b = self._free[i], self._free[i + 1]
            if a.offset + a.size == b.offset:
                a.size += b.size
                self._free.pop(i + 1)
            else:
                break

    @property
    def live_words(self) -> int:
        return sum(self._allocated.values())

    @property
    def free_words(self) -> int:
        return self.capacity - self.live_words

    @property
    def n_free_chunks(self) -> int:
        """Fragmentation indicator."""
        return len(self._free)


# --------------------------------------------------------------------------- #
# Layout                                                                       #
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def words(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1


class ContextLayout:
    """Named fields inside a context, placed by the allocator."""

    def __init__(self, capacity_words: Optional[int] = None):
        self._fields: Dict[str, Tuple[int, Field]] = {}
        self._capacity = capacity_words
        self._alloc: Optional[Allocator] = (
            Allocator(capacity_words) if capacity_words else None
        )
        self._next = 0  # bump fallback when capacity unknown

    def add(self, name: str, shape: Sequence[int],
            dtype=torch.float32) -> "ContextLayout":
        dtype = as_dtype(dtype)
        if name in self._fields:
            raise ValueError(f"duplicate field {name!r}")
        f = Field(name, tuple(int(s) for s in shape), dtype)
        if f.words == 0:
            # A zero-size field would make field_words() == 0 while the
            # allocator hands out >= 1 word, desynchronising the ledger's
            # byte counts from Allocator.live_words.
            raise ValueError(
                f"field {name!r} has zero size (shape {f.shape}); "
                "context fields must occupy at least one word"
            )
        if self._alloc is not None:
            off = self._alloc.alloc(f.words)
        else:
            off = self._next
            self._next += f.words
        self._fields[name] = (off, f)
        return self

    def drop(self, name: str) -> "ContextLayout":
        """Free a field (its words become reusable — §6.6)."""
        off, _ = self._fields.pop(name)
        if self._alloc is not None:
            self._alloc.free(off)
        return self

    def offset(self, name: str) -> int:
        return self._fields[name][0]

    def field(self, name: str) -> Field:
        return self._fields[name][1]

    def field_words(self, name: str) -> int:
        return self._fields[name][1].words

    def field_bytes(self, name: str) -> int:
        return self.field_words(name) * WORD

    @property
    def names(self) -> List[str]:
        return list(self._fields)

    @property
    def words(self) -> int:
        """Context size in words (μ / 4).  With an allocator this is the fixed
        capacity; otherwise the high-water mark of the bump pointer."""
        if self._capacity is not None:
            return self._capacity
        return max(self._next, 1)

    @property
    def live_words(self) -> int:
        if self._alloc is not None:
            return self._alloc.live_words
        return sum(f.words for _, f in self._fields.values())

    @property
    def mu_bytes(self) -> int:
        """μ: the context size in bytes."""
        return self.words * WORD

    @property
    def live_bytes(self) -> int:
        return self.live_words * WORD

    def live_word_index(self) -> Optional[np.ndarray]:
        """Sorted word offsets of every *live* (field-allocated) word, or
        ``None`` when the whole context is live (the common bump-layout
        case)."""
        if self.live_words == self.words:
            return None
        return field_word_index(self, self.names)


def field_word_index(layout_: ContextLayout,
                     names: Sequence[str]) -> np.ndarray:
    """Union of the named fields' word ranges, sorted."""
    ranges = [
        np.arange(layout_.offset(n), layout_.offset(n) + layout_.field_words(n))
        for n in names
    ]
    return np.unique(np.concatenate(ranges)) if ranges else np.arange(0)


def layout(fields: Iterable[Tuple[str, Sequence[int], object]],
           capacity_words: Optional[int] = None) -> ContextLayout:
    """A layout of ``(name, shape, dtype)`` fields, added in order."""
    lo = ContextLayout(capacity_words)
    for name, shape, dtype in fields:
        lo.add(name, shape, dtype)
    return lo


# --------------------------------------------------------------------------- #
# Context view                                                                 #
# --------------------------------------------------------------------------- #

def _to_words(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.int32 else x.view(torch.int32)


def _from_words(w: torch.Tensor, dtype) -> torch.Tensor:
    dtype = as_dtype(dtype)
    return w if dtype == torch.int32 else w.view(dtype)


def _cast(value, dtype: torch.dtype, device) -> torch.Tensor:
    """``value`` as a ``dtype`` tensor on ``device`` (a value conversion,
    like ``jnp.asarray(value, dtype)``)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(value), device=device).to(dtype)


class Ctx:
    """The round's ``k`` swapped-in contexts: a ``[k, words]`` int32 block
    with typed field accessors — the explicit, batched form of the JAX
    package's per-context ``vmap``.

    ``get`` returns a ``[k, *shape]`` typed *view* of the block; ``set``
    writes into the block in place and returns ``self`` (the JAX ``Ctx`` is
    functional).  A stage that reads a field and then sets the same field
    must not use its earlier view afterwards."""

    def __init__(self, layout: ContextLayout, words: torch.Tensor):
        self.layout = layout
        self.words = words

    @property
    def k(self) -> int:
        return self.words.shape[0]

    def get(self, name: str) -> torch.Tensor:
        off = self.layout.offset(name)
        f = self.layout.field(name)
        flat = self.words[:, off:off + f.words]
        return _from_words(flat, f.dtype).reshape((self.k,) + f.shape)

    def set(self, name: str, value) -> "Ctx":
        off = self.layout.offset(name)
        f = self.layout.field(name)
        value = _cast(value, f.dtype, self.words.device)
        self.words[:, off:off + f.words] = _to_words(
            value.reshape(self.k, f.words))
        return self

    def update(self, **kv) -> "Ctx":
        """``set`` of each keyword's field in turn; returns ``self``."""
        for name, value in kv.items():
            self.set(name, value)
        return self


# --------------------------------------------------------------------------- #
# Store                                                                        #
# --------------------------------------------------------------------------- #

class ContextStore:
    """All ``v`` contexts: the external memory.  ``data`` is ``[v, words]``
    int32 on one device.  Every ``with_*`` method writes into ``data`` in
    place and returns a store over the same tensor."""

    def __init__(self, layout: ContextLayout, data: torch.Tensor):
        if data.dtype != torch.int32 or data.dim() != 2:
            raise TypeError(
                f"store data must be [v, words] int32, got {data.dtype} "
                f"{tuple(data.shape)}")
        self.layout = layout
        self.data = data

    @property
    def v(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def mu_bytes(self) -> int:
        return self.layout.mu_bytes

    def field(self, name: str) -> torch.Tensor:
        """A field across all contexts → ``[v, *shape]`` typed view of the
        store (result extraction; not part of the simulated I/O)."""
        off = self.layout.offset(name)
        f = self.layout.field(name)
        flat = self.data[:, off:off + f.words]
        return _from_words(flat, f.dtype).reshape((self.v,) + f.shape)

    def with_field(self, name: str, value) -> "ContextStore":
        """Write ``value`` (``[v, *shape]``, converted to the field's dtype)
        into the field of every context, in place."""
        off = self.layout.offset(name)
        f = self.layout.field(name)
        value = _cast(value, f.dtype, self.device)
        self.data[:, off:off + f.words] = _to_words(
            value.reshape(self.v, f.words))
        return ContextStore(self.layout, self.data)

    # word-level access --------------------------------------------------- #
    # The fused Alltoallv path moves raw context words, skipping the typed
    # bitcast/reshape: a field is just a contiguous word range of every row.

    def field_words_view(self, name: str) -> torch.Tensor:
        """Raw ``[v, field_words]`` int32 view of a field's word range
        across all contexts — no bitcast, no reshape to the field shape."""
        off = self.layout.offset(name)
        n = self.layout.field_words(name)
        return self.data[:, off:off + n]

    def with_field_words(self, name: str,
                         words: torch.Tensor) -> "ContextStore":
        """Write a field's raw word range from a ``[v, field_words]`` int32
        tensor, in place (inverse of :meth:`field_words_view`)."""
        off = self.layout.offset(name)
        n = self.layout.field_words(name)
        if words.dtype != torch.int32:
            raise TypeError(
                f"word-level writes must be int32 words, got {words.dtype}")
        self.data[:, off:off + n] = words.reshape(self.v, n)
        return ContextStore(self.layout, self.data)


def device_scope(device: torch.device):
    """A context in which ``device`` is the current CUDA device (nothing to
    switch for another device): where a stage, kernel wrapper or copy runs
    on one card of a mesh, an allocation it makes without an index lands
    there too."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class MeshStore:
    """All ``v`` contexts over a mesh of cards: ``P`` row blocks ``[v/P,
    words]`` int32, block ``p`` (contexts ``[p·v/P, (p+1)·v/P)``) on card
    ``p`` and nowhere else, each its own allocation — the JAX package's
    store sharded over the ``vp`` axis.

    The methods mirror :class:`ContextStore`'s, block by block: a write
    takes a ``[v, ...]`` value (each block's rows go to its card) or ``P``
    per-block values, and lands in place; ``field(name, p)`` and
    ``field_words_view(name, p)`` are views of block ``p``.  Without ``p``
    they gather the blocks onto the first card, a copy (like a backing
    tier's CPU copy): the explicit call for whoever wants the whole field —
    the result's extraction, tests, :mod:`repro_torch.interop` — never the
    executor's or the collectives' hot path."""

    def __init__(self, layout: ContextLayout, blocks: Sequence[torch.Tensor]):
        blocks = list(blocks)
        if not blocks or any(
                b.dtype != torch.int32 or b.dim() != 2
                or b.shape != blocks[0].shape for b in blocks):
            raise TypeError(
                "a mesh store's blocks must be [v/P, words] int32 tensors of "
                "one shape, got "
                f"{[(b.dtype, tuple(b.shape)) for b in blocks]}")
        self.layout = layout
        self.blocks = blocks

    @property
    def P(self) -> int:
        return len(self.blocks)

    @property
    def m(self) -> int:
        """Contexts a block (``v/P``)."""
        return self.blocks[0].shape[0]

    @property
    def v(self) -> int:
        return self.m * self.P

    @property
    def device(self) -> torch.device:
        """The first card: where a gathered field lands."""
        return self.blocks[0].device

    def _split(self, value) -> List:
        """``P`` per-block values: ``value`` itself when it is a sequence
        of them, else its rows cut into blocks."""
        if isinstance(value, (list, tuple)):
            if len(value) != self.P:
                raise ValueError(f"{len(value)} block values for {self.P} "
                                 "blocks")
            return list(value)
        m = self.m
        return [value[p * m:(p + 1) * m] for p in range(self.P)]

    def field(self, name: str, p: Optional[int] = None) -> torch.Tensor:
        """Block ``p``'s ``[v/P, *shape]`` typed view of a field, or with
        ``p=None`` the ``[v, *shape]`` field gathered onto the first card
        (a copy)."""
        if p is None:
            return torch.cat([self.field(name, q).to(self.device)
                              for q in range(self.P)])
        return ContextStore(self.layout, self.blocks[p]).field(name)

    def with_field(self, name: str, value) -> "MeshStore":
        """Write ``value`` (``[v, *shape]`` or ``P`` blocks, converted to
        the field's dtype) into the field, each block on its card, in
        place."""
        for blk, val in zip(self.blocks, self._split(value)):
            with device_scope(blk.device):
                ContextStore(self.layout, blk).with_field(name, val)
        return MeshStore(self.layout, self.blocks)

    def field_words_view(self, name: str,
                         p: Optional[int] = None) -> torch.Tensor:
        """Block ``p``'s raw ``[v/P, field_words]`` int32 view of a field's
        word range, or with ``p=None`` the ``[v, field_words]`` words
        gathered onto the first card (a copy)."""
        if p is None:
            return torch.cat([self.field_words_view(name, q).to(self.device)
                              for q in range(self.P)])
        return ContextStore(self.layout, self.blocks[p]).field_words_view(
            name)

    def with_field_words(self, name: str, words) -> "MeshStore":
        """Write a field's raw word range from ``[v, field_words]`` int32
        words (or ``P`` blocks of them), each block on its card, in
        place."""
        for blk, w in zip(self.blocks, self._split(words)):
            with device_scope(blk.device):
                ContextStore(self.layout, blk).with_field_words(
                    name, w.to(blk.device))
        return MeshStore(self.layout, self.blocks)

    def gather(self) -> torch.Tensor:
        """The whole ``[v, words]`` population on the first card (a copy)."""
        return torch.cat([b.to(self.device) for b in self.blocks])


def init_store(layout_: ContextLayout, v: int,
               init_fn: Optional[Callable[[torch.Tensor],
                                          Dict[str, torch.Tensor]]] = None,
               device=None) -> ContextStore:
    """Create a zeroed ``[v, words]`` store on ``device`` (CUDA by default).
    ``init_fn(rhos[v]) -> {field: [v, *shape]}`` populates initial contexts,
    batched over the virtual-processor IDs."""
    dev = resolve_device(device)
    data = torch.zeros((v, layout_.words), dtype=torch.int32, device=dev)
    if init_fn is not None:
        ctx = Ctx(layout_, data)
        for name, val in init_fn(
                torch.arange(v, dtype=torch.int32, device=dev)).items():
            ctx.set(name, val)
    return ContextStore(layout_, data)


def init_mesh_store(layout_: ContextLayout, v: int, devices: Sequence,
                    init_fn=None) -> MeshStore:
    """Create a zeroed :class:`MeshStore` of ``v`` contexts over
    ``devices`` (one block a card, ``v/len(devices)`` contexts each).
    ``init_fn`` runs once a block, on its card, over its contexts' IDs."""
    P = len(devices)
    m = v // P
    blocks = []
    for p, dev in enumerate(devices):
        with device_scope(dev):
            blocks.append(init_store(
                layout_, m,
                None if init_fn is None
                else (lambda rhos, p=p: init_fn(rhos + p * m)), dev).data)
    return MeshStore(layout_, blocks)
