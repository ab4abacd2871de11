"""Fault-tolerant checkpointing (the port's copy of the JAX package's
``checkpoint/manager.py``).

* **Atomic commit**: state is written to ``step_N.tmp/`` and renamed to
  ``step_N/`` only after every array file and the manifest are fsynced — a
  torn write is never mistaken for a checkpoint.
* **Crash-safe restore**: ``restore_latest`` scans newest to oldest and
  skips any directory whose manifest is missing or invalid, or whose chunk
  CRCs do not match.
* **Keep-k retention**, the newest always kept.
* **Async save**: the device-to-host copy happens at once (consistency),
  the file write on a background thread.
* **Memmap-aware**: ``np.memmap`` leaves (a memmap-backed context store)
  stream to and from the checkpoint in bounded chunks through the port's
  :class:`~repro_torch.io.IOEngine` over the ``mmap`` adapter, never whole
  in RAM; on restore a memmap leaf of ``like`` is filled in place.  A
  non-blocking ``save`` reads memmap leaves on the writer thread: do not
  mutate them until ``wait()``.
* **Checksummed chunks**: every array is CRC'd per streaming chunk at save
  time and the CRCs live in the manifest (version 2); restore verifies
  each chunk, so a corrupted file raises ``IOError`` and ``restore_latest``
  falls back to an older step.

State is any nest of dicts, lists, tuples and namedtuples over torch
tensors, numpy arrays, ``np.memmap`` arrays and scalars.  A bfloat16 tensor,
which numpy has no type for, is saved as its bits (``uint16``) and restored
as bfloat16 onto a bfloat16 ``like`` leaf (the training state of a bf16
model); such a checkpoint is the port's own.  Its own flatten
gives the manifest the key strings and leaf order of ``jax.tree_util``
(dict keys sorted, ``['key']``, ``[i]`` and ``.field`` paths), so a
checkpoint written by either package restores in the other.  Tensor leaves
restore onto the device of the matching ``like`` leaf.

**Elastic restore** (the JAX package's ``shardings=``): ``placements``, a
nest shaped like ``like``, puts each leaf elsewhere: ``None`` on ``like``'s
device, a ``torch.device`` or device string on that device, a ``(mesh,
[Placement, ...])`` pair as a DTensor by ``distribute_tensor(t, mesh,
placements, src_data_rank=None)``: each rank slices its shard from the
array it read, and no collective runs.  ``like`` may sit on the ``meta``
device, so a rank learns the state's structure without building it.  A
checkpoint saved over one layout restores onto any other.

**Over several processes** (an initialised ``torch.distributed`` process
group): a DTensor leaf is gathered whole (``full_tensor()``, a collective
every rank joins inside ``save``) and written whole; only rank 0 writes, and
no rank returns from a blocking ``save``, from ``wait()`` or from a restore
before the commit's rename.  The ranks that do not write wait for rank 0's
write in a collective, so that write must end within the process group's
timeout (``init_process_group(timeout=)``).  Every rank restores the same
step: the ranks try rank 0's steps newest first and fall back together
when any rank finds one torn or corrupt.  A placement that does not fit
(a card this host lacks, a ``Shard`` dim past the leaf's, a ``meta`` leaf
left without one) raises ValueError on every rank before anything is
read, and one that fails while a leaf is placed (card memory, the mesh)
raises on every rank: neither falls back.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.backing import MmapFile
from ..core.recovery import atomic_write_json, fsync_dir
from ..io.checksum import CHECKSUM_ALGO, crc_bytes
from ..io.engine import IOEngine
from ..io.npyio import (create_npy_memmap, fsync_file, load_npy_mmap,
                        save_npy_durable)
from ..tree import flatten_with_keys as _flatten
from ..tree import is_namedtuple as _is_namedtuple

__all__ = ["CheckpointManager", "PlacementError"]

# What a torn or corrupt step raises while it is read and verified: a
# missing or truncated file, a bad manifest, a chunk CRC that differs.
_UNREADABLE = (OSError, ValueError, KeyError, EOFError)


class PlacementError(RuntimeError):
    """A leaf that was read and verified but could not be placed (card
    memory, the mesh); ``restore_latest`` does not fall back on it."""


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._unsynced = False        # a grouped async save not yet agreed
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, blocking: bool = True) -> str:
        """Snapshot ``state`` at ``step``; returns the checkpoint's
        directory.  Under a process group every rank calls it (DTensor
        leaves are gathered) and rank 0 writes; the others wait for the
        write (here if ``blocking``, else in ``wait()``) no longer than the
        process group's timeout."""
        # Copy now (device to host, or a host copy), so the caller may
        # mutate its buffers after; memmap leaves stay by reference and
        # stream at write time instead of copying v·μ into RAM.  Ranks
        # other than 0 join the gathers and keep nothing.
        writer = _rank() == 0
        host = [(key, _snapshot(leaf, writer))
                for key, leaf in _flatten(state)]
        self.wait()

        def write():
            tmp = os.path.join(self.dir, f"step_{step:012d}.tmp")
            final = os.path.join(self.dir, f"step_{step:012d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            names = []
            for i, (key, arr) in enumerate(host):
                fn = f"arr_{i:05d}.npy"
                path = os.path.join(tmp, fn)
                is_mm = isinstance(arr, np.memmap)
                if is_mm:
                    crcs = _stream_to_npy(arr, path)
                else:
                    crcs = _array_crcs(arr)
                    save_npy_durable(path, arr)
                names.append({"key": key, "file": fn,
                              "shape": list(arr.shape),
                              "dtype": str(arr.dtype),
                              "memmap": is_mm,
                              "chunk_crcs": crcs})
            manifest = {"step": step, "arrays": names,
                        "time": time.time(), "version": 2,
                        "algo": CHECKSUM_ALGO}
            # The manifest is the commit record within the staging dir:
            # temp + fsync + rename (+ the dir's fsync), so even a crash
            # during the final rename below cannot expose a torn manifest.
            atomic_write_json(os.path.join(tmp, "manifest.json"), manifest)
            if os.path.exists(final):
                shutil.rmtree(tmp)       # another writer won the race
            else:
                os.replace(tmp, final)   # atomic commit
                fsync_dir(self.dir)      # persist the rename itself
            self._gc()

        grouped = _grouped()

        def write_noted():
            try:
                write()
            except Exception as e:
                if not grouped:
                    raise
                self._error = e    # raised on every rank by _agree_written

        if writer and blocking:
            write_noted()
        elif writer:
            self._pending = threading.Thread(target=write_noted, daemon=True)
            self._pending.start()
        if blocking:
            self._agree_written()
        else:
            self._unsynced = grouped
        return os.path.join(self.dir, f"step_{step:012d}")

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._unsynced:
            self._unsynced = False
            self._agree_written()

    def _agree_written(self) -> None:
        """Under a process group, hold every rank until rank 0's write
        has committed; a failed write raises on every rank."""
        if not _grouped():
            return
        error, self._error = self._error, None
        if not _all_ranks(error is None):
            raise IOError("checkpoint write failed on rank 0") from error

    # --------------------------------------------------------------- restore
    def restore_latest(self, like: Any = None,
                       placements: Any = None) -> Optional[Tuple[int, Any]]:
        """``(step, state)`` of the newest complete checkpoint, or None.
        ``like`` supplies the structure, the memmap leaves to fill in place
        and the dtypes and devices of tensor leaves; without it the arrays
        come back as a list of numpy arrays.  ``placements`` (a nest shaped
        like ``like``) puts leaves elsewhere (the module's docstring)."""
        self.wait()
        where = _placements_for(like, placements)
        steps = sorted(self._steps(), reverse=True)
        if _grouped():
            steps = _from_rank0(steps)
        for step in steps:
            state, torn = self._load_agreed(step, like, where)
            if torn is None:
                return step, state
        return None                       # every step torn: fall back

    def restore(self, step: int, like: Any = None, placements: Any = None):
        self.wait()
        where = _placements_for(like, placements)
        state, torn = self._load_agreed(step, like, where)
        if torn is not None:
            raise torn
        return state

    def _load_agreed(self, step: int, like, where):
        """``(state, None)`` where ``step`` loaded on every rank, else
        ``(None, error)`` where a rank found it torn or corrupt (an error
        that an older step may not have).  Any other failure, such as a
        leaf that could not be placed, raises on every rank."""
        state = torn = fatal = None
        try:
            state = self._load(step, like, where)
        except _UNREADABLE as e:
            torn = e
        except Exception as e:
            fatal = e
        got = _gathered("fatal" if fatal else "torn" if torn else "ok")
        if fatal is not None:
            raise fatal
        if "fatal" in got:
            raise RuntimeError(f"restoring checkpoint step {step} failed on "
                               f"rank {got.index('fatal')}")
        if "torn" in got:
            return None, torn or IOError(
                f"checkpoint step {step} is torn or corrupt on rank "
                f"{got.index('torn')}")
        return state, None

    # ---------------------------------------------------------------- intern
    def _load(self, step: int, like, where: Optional[List[Any]] = None):
        d = os.path.join(self.dir, f"step_{step:012d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        metas = manifest["arrays"]
        # Version-2 manifests carry per-chunk CRCs, verified when the
        # recorded algorithm is ours; version 1 (or another algorithm) is
        # read without verification.
        verify = manifest.get("algo") == CHECKSUM_ALGO
        if like is None:
            arrays = []
            for meta in metas:
                arr = np.load(os.path.join(d, meta["file"]))
                if list(arr.shape) != meta["shape"]:
                    raise IOError(f"shape mismatch in {meta['file']}")
                _verify(arr, meta, verify)
                arrays.append(arr)
            return arrays
        leaves = [leaf for _, leaf in _flatten(like)]
        if len(leaves) != len(metas):
            raise IOError(
                f"checkpoint has {len(metas)} leaves, state has "
                f"{len(leaves)}")
        arrays = []
        for meta, leaf, place in zip(metas, leaves,
                                     where or [None] * len(leaves)):
            path = os.path.join(d, meta["file"])
            if isinstance(leaf, np.memmap):
                # Out-of-core leaf: stream the checkpoint into the caller's
                # backing store in bounded chunks, filled in place.
                src = load_npy_mmap(path)
                if src.shape != leaf.shape or src.dtype != leaf.dtype:
                    raise IOError(
                        f"memmap leaf mismatch in {meta['file']}: checkpoint "
                        f"{src.shape}/{src.dtype} vs store "
                        f"{leaf.shape}/{leaf.dtype}")
                _chunked_copy(src, leaf,
                              crcs_expect=(meta.get("chunk_crcs")
                                           if verify else None),
                              label=meta["file"])
                leaf.flush()
                arrays.append(leaf)
                continue
            arr = np.load(path)
            if list(arr.shape) != meta["shape"]:
                raise IOError(f"shape mismatch in {meta['file']}")
            _verify(arr, meta, verify)
            if isinstance(leaf, torch.Tensor) or place is not None:
                t = torch.from_numpy(arr)
                if (getattr(leaf, "dtype", None) == torch.bfloat16
                        and arr.dtype == np.uint16):
                    t = torch.from_numpy(arr.view(np.int16)).view(
                        torch.bfloat16)
                try:
                    arrays.append(_place(t, leaf, place))
                except Exception as e:
                    raise PlacementError(
                        f"leaf {meta['key']} of step {step} could not be "
                        f"placed by {place!r}: {e}") from e
            else:
                arrays.append(arr)
        return _unflatten(like, iter(arrays))

    def _steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return out

    def _gc(self) -> None:
        steps = sorted(self._steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:012d}"),
                          ignore_errors=True)


# --------------------------------------------------------------------------- #
# State nests                                                                  #
# --------------------------------------------------------------------------- #

def _unflatten(like, leaves: Iterator):
    """``like``'s structure with its leaves taken from ``leaves`` in
    :func:`_flatten`'s order."""
    if like is None:
        return None
    if isinstance(like, dict):
        got = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: got[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _snapshot(leaf, keep: bool = True):
    """A host copy of ``leaf`` to write (a memmap by reference), or None
    where ``keep`` is false; a DTensor is gathered whole either way."""
    if isinstance(leaf, np.memmap):
        return leaf if keep else None
    if isinstance(leaf, torch.Tensor):
        dtensor = _dtensor_type()
        t = leaf.detach()
        if dtensor is not None and isinstance(t, dtensor):
            t = t.full_tensor()
        if not keep:
            return None
        t = t.to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if not keep:
        return None
    arr = np.asarray(leaf)
    return arr.copy() if arr is leaf else arr


# --------------------------------------------------------------------------- #
# Placements and process groups                                                #
# --------------------------------------------------------------------------- #

def _dtensor_type():
    if not torch.distributed.is_available():
        return None
    from torch.distributed.tensor import DTensor
    return DTensor


def _grouped() -> bool:
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


def _rank() -> int:
    return torch.distributed.get_rank() if _grouped() else 0


def _gathered(obj) -> list:
    """``obj`` of every rank in rank order (``[obj]`` without a process
    group); a collective every rank joins."""
    if not _grouped():
        return [obj]
    got = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(got, obj)
    return got


def _all_ranks(ok: bool) -> bool:
    """Whether ``ok`` holds on every rank."""
    return all(_gathered(bool(ok)))


def _from_rank0(obj):
    box = [obj]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


def _placements_for(like, placements) -> Optional[List[Any]]:
    """``placements`` flattened up to ``like``'s leaves, each checked
    against its leaf (None without ``like``).  A bad placement raises
    ValueError, on every rank of a process group."""
    error, where = None, None
    if like is not None or placements is not None:
        try:
            if like is None:
                raise ValueError("placements need a like state to follow")
            where = [_checked(leaf, p) for (_, leaf), p in
                     zip(_flatten(like), _up_to(like, placements))]
        except (ValueError, TypeError, RuntimeError) as e:
            error = e
    if not _all_ranks(error is None):
        raise ValueError("bad restore placements: "
                         f"{error or 'on another rank'}") from error
    return where


def _up_to(like, placements) -> Iterator:
    """The node of ``placements`` at each leaf of ``like``, in
    :func:`_flatten`'s order (a ``(mesh, [...])`` pair is one node)."""
    if like is None:
        return
    if placements is None:
        yield from (None for _ in _flatten(like))
    elif isinstance(like, dict):
        if not isinstance(placements, dict) or set(placements) != set(like):
            raise ValueError(f"placements {placements!r} do not follow the "
                             f"state's keys {sorted(like)}")
        for k in sorted(like):
            yield from _up_to(like[k], placements[k])
    elif isinstance(like, (list, tuple)):
        if (not isinstance(placements, (list, tuple))
                or len(placements) != len(like)):
            raise ValueError(f"placements {placements!r} do not follow a "
                             f"state node of {len(like)} entries")
        for x, p in zip(like, placements):
            yield from _up_to(x, p)
    else:
        yield placements


def _checked(leaf, place):
    """``place`` (None, a device or device string, or a ``(mesh,
    placements)`` pair) as ``_place`` takes it; ValueError where it names
    no device of this host, shards a dim ``leaf`` lacks, leaves a ``meta``
    leaf on ``meta`` or is no placement."""
    if place is None:
        if isinstance(leaf, torch.Tensor) and leaf.is_meta:
            raise ValueError("a leaf of a meta like needs a placement: "
                             "restored there it would hold no data")
        return None
    if isinstance(place, (str, torch.device)):
        dev = torch.device(place)
        if dev.type == "meta":
            raise ValueError(f"placement {place!r}: a restored leaf on "
                             "meta would hold no data")
        if dev.type == "cuda" and (
                not torch.cuda.is_available()
                or (dev.index or 0) >= torch.cuda.device_count()):
            raise ValueError(f"placement {place!r}: no such CUDA device "
                             f"({torch.cuda.device_count()} visible)")
        return dev
    if (isinstance(place, tuple) and len(place) == 2
            and hasattr(place[0], "device_type")
            and isinstance(place[1], (list, tuple))
            and len(place[1]) == place[0].ndim):
        ndim = len(np.shape(leaf))
        for p in place[1]:
            if p.is_shard() and not -ndim <= p.dim < ndim:
                raise ValueError(f"placement {place!r}: {p} of a leaf of "
                                 f"{ndim} dims")
        return place
    raise ValueError(f"placement {place!r}: neither None, a device nor a "
                     "(DeviceMesh, [Placement, ...]) pair")


def _place(t: torch.Tensor, like_leaf, place) -> torch.Tensor:
    if place is None:
        return t.to(like_leaf.device)
    if isinstance(place, torch.device):
        return t.to(place)
    from torch.distributed.tensor import distribute_tensor
    mesh, placements = place
    return distribute_tensor(t, mesh, list(placements), src_data_rank=None)


# --------------------------------------------------------------------------- #
# Chunk CRCs and streaming                                                     #
# --------------------------------------------------------------------------- #

_STREAM_CHUNK_BYTES = 64 << 20   # bound on resident bytes while streaming
_STREAM_QUEUE_DEPTH = 4          # chunks in flight on the engine


def _chunk_rows(shape, itemsize: int) -> Tuple[int, int]:
    """(row bytes, rows per streaming chunk) for an array of ``shape``."""
    row = max(1, int(np.prod(shape[1:], dtype=np.int64))) * itemsize
    return row, max(1, _STREAM_CHUNK_BYTES // (row * _STREAM_QUEUE_DEPTH))


def _chunk_crc(chunk: np.ndarray) -> int:
    return crc_bytes(np.ascontiguousarray(chunk).reshape(-1).view(np.uint8))


def _array_crcs(arr: np.ndarray) -> List[int]:
    """Per-chunk CRCs of ``arr`` in the streaming chunk geometry (so save
    and restore agree without storing the chunk size)."""
    a = np.asarray(arr)
    if a.ndim == 0:
        return [crc_bytes(a.tobytes())]
    _, step = _chunk_rows(a.shape, a.itemsize)
    return [_chunk_crc(a[i:i + step]) for i in range(0, a.shape[0], step)]


def _verify(arr: np.ndarray, meta: dict, verify: bool) -> None:
    crcs = meta.get("chunk_crcs")
    if not verify or crcs is None:
        return
    got = _array_crcs(arr)
    if got != crcs:
        ci = next((i for i, (a, b) in enumerate(zip(got, crcs)) if a != b),
                  min(len(got), len(crcs)))
        raise _crc_mismatch(meta["file"], ci)


def _crc_mismatch(path: str, ci: int) -> IOError:
    return IOError(
        f"checksum mismatch in {path} (chunk {ci}): the checkpoint file is "
        f"torn or corrupt; restore_latest will fall back to an older step")


def _chunked_copy(src, dst, crcs_out: Optional[List[int]] = None,
                  crcs_expect: Optional[List[int]] = None,
                  label: str = "<array>") -> None:
    """Copy array ``src`` into ``dst`` in chunks along axis 0 (whole for
    0-d), keeping the resident footprint bounded.

    A C-contiguous memmap ``dst`` takes its chunks through an
    :class:`~repro_torch.io.IOEngine` over the mmap adapter, up to
    ``_STREAM_QUEUE_DEPTH`` copies in flight.  ``crcs_out`` (save) collects
    a CRC a chunk, computed in the submitting thread; ``crcs_expect``
    (restore) verifies each chunk of ``src`` before it is copied, raising
    ``IOError`` on a mismatch.
    """
    checking = crcs_out is not None or crcs_expect is not None
    if src.ndim == 0:
        if checking:
            crc = crc_bytes(np.asarray(src).tobytes())
            if crcs_out is not None:
                crcs_out.append(crc)
            if crcs_expect is not None and crc != crcs_expect[0]:
                raise _crc_mismatch(label, 0)
        dst[...] = src
        return
    row, step = _chunk_rows(src.shape, src.itemsize)

    def check(chunk, ci):
        if not checking:
            return chunk
        chunk = np.ascontiguousarray(chunk)
        crc = _chunk_crc(chunk)
        if crcs_out is not None:
            crcs_out.append(crc)
        if crcs_expect is not None and (
                ci >= len(crcs_expect) or crc != crcs_expect[ci]):
            raise _crc_mismatch(label, ci)
        return chunk

    if (not isinstance(dst, np.memmap) or not dst.flags.c_contiguous
            or not src.flags.c_contiguous):
        # Strided leaves: the engine needs C-contiguous chunk buffers and a
        # flat byte view of dst; numpy assignment handles these layouts.
        for ci, i in enumerate(range(0, src.shape[0], step)):
            dst[i:i + step] = check(src[i:i + step], ci)
        return
    flat = dst.reshape(-1).view(np.uint8)
    engine = IOEngine(MmapFile(mm=flat), queue_depth=_STREAM_QUEUE_DEPTH)
    try:
        for ci, i in enumerate(range(0, src.shape[0], step)):
            engine.submit_write(i * row, check(src[i:i + step], ci),
                                auto_reap=True)
        engine.drain()
    finally:
        engine.close()


def _stream_to_npy(arr: np.memmap, path: str) -> List[int]:
    """Write a memmap to ``.npy`` by chunked copy (no whole-array staging in
    RAM), fsynced like the regular save path; returns the chunk CRCs."""
    crcs: List[int] = []
    out = create_npy_memmap(path, arr.dtype, arr.shape)
    try:
        _chunked_copy(arr, out, crcs_out=crcs)
        out.flush()
    finally:
        del out
    fsync_file(path)
    return crcs
