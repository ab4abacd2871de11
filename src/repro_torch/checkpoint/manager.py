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
tensors, numpy arrays, ``np.memmap`` arrays and scalars.  Its own flatten
gives the manifest the key strings and leaf order of ``jax.tree_util``
(dict keys sorted, ``['key']``, ``[i]`` and ``.field`` paths), so a
checkpoint written by either package restores in the other.  Tensor leaves
restore onto the device of the matching ``like`` leaf.
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

__all__ = ["CheckpointManager"]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, blocking: bool = True) -> str:
        """Snapshot ``state`` at ``step``; returns the checkpoint's
        directory."""
        # Copy now (device to host, or a host copy), so the caller may
        # mutate its buffers after; memmap leaves stay by reference and
        # stream at write time instead of copying v·μ into RAM.
        host = [(key, _snapshot(leaf)) for key, leaf in _flatten(state)]
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

        if blocking:
            write()
        else:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()
        return os.path.join(self.dir, f"step_{step:012d}")

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    # --------------------------------------------------------------- restore
    def restore_latest(self, like: Any = None) -> Optional[Tuple[int, Any]]:
        """``(step, state)`` of the newest complete checkpoint, or None.
        ``like`` supplies the structure, the memmap leaves to fill in place
        and the devices of tensor leaves; without it the arrays come back as
        a list of numpy arrays."""
        self.wait()
        for step in sorted(self._steps(), reverse=True):
            try:
                return step, self._load(step, like)
            except Exception:
                continue   # torn/corrupt checkpoint: fall back to older
        return None

    def restore(self, step: int, like: Any = None):
        return self._load(step, like)

    # ---------------------------------------------------------------- intern
    def _load(self, step: int, like):
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
        for meta, leaf in zip(metas, leaves):
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
            if isinstance(leaf, torch.Tensor):
                arrays.append(torch.from_numpy(arr).to(leaf.device))
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

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(key string, leaf)`` pairs in ``jax.tree_util`` order, the key
    strings as ``jax.tree_util.keystr`` writes them; ``None`` holds no
    leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}[{k!r}]")
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _flatten(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _flatten(x, f"{path}[{i}]")
    else:
        yield path, tree


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


def _snapshot(leaf):
    if isinstance(leaf, np.memmap):
        return leaf
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    arr = np.asarray(leaf)
    return arr.copy() if arr is leaf else arr


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
