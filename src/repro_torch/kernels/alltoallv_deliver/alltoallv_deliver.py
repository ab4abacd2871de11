"""Direct message delivery (thesis §6.2) on the GPU.

Replaces the TPU kernel ``deliver_tiles``
(``src/repro/kernels/alltoallv_deliver/alltoallv_deliver.py:79``):
``out[d, s, :] = msgs[s, d, :]``, lanes at or past ``counts[s, d]`` set to
``fill``, and the fused counts transpose ``ct[d, s] = counts_payload[s, d]``.

The CUDA kernel (``csrc/alltoallv_deliver.cu``, entry
``repro_deliver_words``) addresses every operand as raw elements through
``(tensor [rows, row_elements], element offset)``, so :func:`deliver_words`
can deliver straight between the int32 word ranges of the context store —
message ``(s -> d)`` from row ``s`` at ``src_off + d·ww`` into row ``d`` at
``dst_off + s·ww`` — with no ``[v, v, ww]`` temporary.  :func:`deliver_tiles`
is the JAX kernel's array form on top of the same entry, for a payload and a
counts payload of any dtype of 1, 2 or 4 bytes (bool, int8, uint8, int16,
uint16, float16, bfloat16, int32, uint32, float32, ...), moved as the bits of
the signed integer of their width; 8-byte dtypes raise ``TypeError`` (JAX
with x64 off makes none).  Elements of 1 or 2 bytes move as whole words where
the rows allow it, and one at a time where they do not.

:func:`deliver_words_plain` is the plain PyTorch version: the CPU path, and
what ``chip_smoke.py`` holds the kernel against on the card.

The ``P > 1`` mesh staging replaces the TPU kernel ``assemble_proc_tiles``
(``alltoallv_deliver.py:163`` of the JAX package): ``out[p, d, j, :] =
msgs[j, p, d, :]``, lanes at or past ``counts[j, p, d]`` set to ``fill``, and
the fused ``ct[p, d, j] = counts_payload[j, p, d]``.  Its CUDA entry
``repro_assemble_proc_words`` reads the store's send word range directly
(:func:`assemble_words`), one α-chunk for every sending process in one
launch, and writes through a strided destination: the contiguous buffer,
or on a one-card mesh the receivers' recv rows of the same store.
:func:`assemble_proc_tiles` is the JAX kernel's array form (the buffer), for
the same payload dtypes as :func:`deliver_tiles`, and
:func:`assemble_words_plain` the plain version.  Its launches are counted in
``ASSEMBLE_LAUNCHES``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .._build import launch, ptr, require_cuda

LAUNCHES = 0   # calls of deliver_words that launched the CUDA kernel
ASSEMBLE_LAUNCHES = 0   # calls of assemble_words that launched the kernel
# Words of one message that one block of the assemble kernel moves: 8 KiB,
# two 16-byte stores a thread, the fastest span scripts/assemble_sweep.py
# measured on an H100 (4 KiB to 128 KiB).
SPAN_WORDS = 2048
# The signed integer of each element size: a payload of any dtype of that
# size moves as its bits viewed as one of these.
_ELEMS = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def _elems(x: torch.Tensor, what: str) -> torch.Tensor:
    """``x`` viewed as the signed integer of its element size; a dtype of
    another size raises ``TypeError`` naming it."""
    es = x.element_size()
    if es not in _ELEMS:
        raise TypeError(f"{what}: the kernel moves elements of 1, 2 or 4 "
                        f"bytes, got {x.dtype}")
    return x if x.dtype == _ELEMS[es] else x.view(_ELEMS[es])


def _fill_bits(fill, dtype: torch.dtype) -> int:
    """The bits of ``fill`` as an element of ``dtype`` (JAX's
    ``jnp.asarray(fill, dtype)``), as the signed integer of its width."""
    t = torch.tensor(fill, dtype=dtype)
    return int(t.view(_ELEMS[t.element_size()]))


def _require_cuda_counts(what: str, counts, counts_payload) -> None:
    """Raise unless an array form's counts (int32) and counts payload (1, 2
    or 4 bytes, viewed by :func:`_elems`) lie on the card, as its payload
    does."""
    require_cuda(what, counts)
    if counts_payload is not None and not counts_payload.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got "
                         f"{counts_payload.device}")


def deliver_words_plain(src, src_off, dst, dst_off, v, ww, counts=None,
                        cnt_off=0, fill=None, counts_payload=None, cp_off=0,
                        ct_out=None, ct_off=0) -> None:
    """Plain PyTorch version of :func:`deliver_words` (same arguments)."""
    msgs = src[:, src_off:src_off + v * ww].reshape(v, v, ww)
    out = msgs.transpose(0, 1)                          # [d, s, ww]
    if fill is not None:
        cnt = counts[:, cnt_off:cnt_off + v].transpose(0, 1)  # [d, s]
        lane = torch.arange(ww, device=src.device)
        out = torch.where(lane < cnt[..., None], out,
                          torch.tensor(fill, dtype=src.dtype,
                                       device=src.device))
    # reshape copies the transposed view before the write: safe when the
    # source and destination ranges alias.
    dst[:, dst_off:dst_off + v * ww] = out.reshape(v, v * ww)
    if counts_payload is not None:
        ct_out[:, ct_off:ct_off + v] = (
            counts_payload[:, cp_off:cp_off + v].transpose(0, 1))


def deliver_words(src: torch.Tensor, src_off: int, dst: torch.Tensor,
                  dst_off: int, v: int, ww: int,
                  counts: Optional[torch.Tensor] = None, cnt_off: int = 0,
                  fill: Optional[int] = None,
                  counts_payload: Optional[torch.Tensor] = None,
                  cp_off: int = 0, ct_out: Optional[torch.Tensor] = None,
                  ct_off: int = 0) -> None:
    """Deliver the ``v·v`` messages of ``ww`` words, in place into ``dst``.

    Every operand is a ``[rows, row_words]`` int32 word tensor with
    contiguous rows, addressed by a word offset into each row: message
    ``(s -> d)`` is ``src[s, src_off + d·ww : +ww]`` and lands at
    ``dst[d, dst_off + s·ww : +ww]``.  With ``fill`` (an int32 word) lanes at
    or past ``counts[s, cnt_off + d]`` are written as ``fill``.  With
    ``counts_payload`` the word ``counts_payload[s, cp_off + d]`` lands at
    ``ct_out[d, ct_off + s]`` in the same launch.  The source and
    destination ranges must not overlap on the GPU path.

    A CPU ``src`` takes the plain version; a CUDA one launches the kernel.
    """
    if fill is not None and counts is None:
        raise ValueError("fill requires counts")
    if (counts_payload is None) != (ct_out is None):
        raise ValueError("counts_payload and ct_out go together")
    if src.device.type == "cpu":
        deliver_words_plain(src, src_off, dst, dst_off, v, ww, counts,
                            cnt_off, fill, counts_payload, cp_off, ct_out,
                            ct_off)
        return
    require_cuda("deliver_words", src, dst, counts, counts_payload, ct_out)
    _launch_deliver(src, src_off, dst, dst_off, v, ww, counts, cnt_off, fill,
                    counts_payload, cp_off, ct_out, ct_off)


def _launch_deliver(src, src_off, dst, dst_off, v, ww, counts, cnt_off, fill,
                    counts_payload, cp_off, ct_out, ct_off) -> None:
    """Kernel 2 on checked CUDA operands: ``src`` and ``dst`` of one element
    size (offsets and ``ww`` in its elements), ``counts_payload`` and
    ``ct_out`` of another, ``fill`` the element's bits."""
    global LAUNCHES
    masked = fill is not None
    launch("repro_deliver_words", src.device,
           ptr(src), src.stride(0), src_off, ptr(dst), dst.stride(0), dst_off,
           v, ww,
           ptr(counts) if masked else None,
           counts.stride(0) if masked else 0, cnt_off,
           int(fill) if masked else 0,
           ptr(counts_payload),
           0 if counts_payload is None else counts_payload.stride(0), cp_off,
           ptr(ct_out), 0 if ct_out is None else ct_out.stride(0), ct_off,
           src.element_size(),
           4 if counts_payload is None else counts_payload.element_size())
    LAUNCHES += 1


def deliver_tiles(
    msgs: torch.Tensor,                       # [v, v, ω]  (src, dst, payload)
    counts: Optional[torch.Tensor] = None,    # [v, v] int32 valid lengths
    counts_payload: Optional[torch.Tensor] = None,  # [v, v] raw counts words
    *,
    fill=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns ``(out, ct)`` with ``out[d, s] = msgs[s, d]`` (lanes ≥
    ``counts[s, d]`` replaced by ``fill`` when ``fill`` is not ``None``) and
    ``ct[d, s] = counts_payload[s, d]`` (``None`` when no payload given).
    ``msgs`` and ``counts_payload`` may each be any dtype of 1, 2 or 4 bytes
    (bool, int8, uint8, int16, uint16, float16, bfloat16, int32, uint32,
    float32, ...) and keep it, bit for bit; ``fill`` is a value of ``msgs``'
    dtype."""
    v, v2, omega = msgs.shape
    if v != v2:
        raise ValueError(f"msgs must be [v, v, ω], got {tuple(msgs.shape)}")
    if fill is not None and counts is None:
        raise ValueError("fill requires counts")
    elems = _elems(msgs.contiguous(), "deliver_tiles").reshape(v, v * omega)
    out = torch.empty_like(elems)
    fill_bits = None
    if fill is not None:
        fill_bits = _fill_bits(fill, msgs.dtype)
        counts = counts.to(torch.int32).contiguous()
    ct = cp = None
    if counts_payload is not None:
        cp = _elems(counts_payload.contiguous(), "deliver_tiles")
        ct = torch.empty_like(cp)
    if elems.device.type == "cpu":
        deliver_words_plain(elems, 0, out, 0, v, omega, counts, 0, fill_bits,
                            cp, 0, ct, 0)
    else:
        _require_cuda_counts("deliver_tiles", counts, cp)
        _launch_deliver(elems, 0, out, 0, v, omega, counts, 0, fill_bits, cp,
                        0, ct, 0)
    out = out.reshape(v, v, omega).view(msgs.dtype)
    if ct is not None:
        ct = ct.view(counts_payload.dtype)
    return out, ct


# --------------------------------------------------------------------------- #
# Mesh staging (P > 1)                                                         #
# --------------------------------------------------------------------------- #

def _dest(t, shape, name, unit_last):
    """``t`` as a ``shape`` view: a tensor of that shape (with a unit last
    stride when ``unit_last``), or a contiguous one of as many words."""
    if tuple(t.shape) == shape:
        if unit_last and shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"assemble_words: {name} must have a unit last "
                             f"stride, got strides {t.stride()}")
        return t
    n = math.prod(shape)
    if t.numel() != n or not t.is_contiguous():
        raise ValueError(f"assemble_words: {name} must be contiguous with "
                         f"{n} words or a {list(shape)} view, got "
                         f"{tuple(t.shape)}")
    return t.view(shape)


@functools.lru_cache(maxsize=4096)
def _meets(start, shape, strides, run, senders, n, W, lo, hi) -> bool:
    """Whether a run of ``run`` words at any element of a view (its first
    element ``start`` words past a source's ``[0, 0]``, its leading
    ``shape`` and ``strides``) meets words ``[lo, hi)`` of the source rows
    the chunk reads: ``senders = (nq, m, s0, s)`` reads rows ``q·m + s0 + j``
    of the source's ``n`` rows of row stride ``W``.  A run that passes the
    end of its row counts as meeting every later row it reaches.  Pure in
    its integer arguments, so a chunk's geometry is checked once."""
    runs = np.full(1, start, np.int64)
    for size, st in zip(shape, strides):
        runs = (runs[:, None] + np.arange(size, dtype=np.int64) * st)
        runs = runs.reshape(-1)
    nq, m, s0, s = senders
    read = np.zeros(n, bool)
    rows = (np.arange(nq)[:, None] * m + s0 + np.arange(s)).reshape(-1)
    read[rows[rows < n]] = True
    first, col = np.divmod(runs, W)
    inside = (first >= 0) & (first < n)
    meets = inside & read[np.where(inside, first, 0)] & (col < hi) \
        & (col + run > lo)
    if meets.any():
        return True
    spill = col + run > W
    if not spill.any():
        return False
    below = np.concatenate([[0], np.cumsum(read)])   # read rows < i
    last = first + (col + run - 1) // W
    a, b = (np.clip(x[spill] + 1, 0, n) for x in (first, last))
    return bool((below[b] > below[a]).any())


def _check_assemble(src, src_off, m, pn, nq, s0, s, c0, d, ww, out, counts,
                    cnt_off, fill, counts_payload, cp_off, ct_out):
    """Raise on what the kernel cannot take; returns ``(out, ct_out)`` as
    ``[nq, pn, d, s, ww]`` and ``[nq, pn, d, s]`` views."""
    if fill is not None and counts is None:
        raise ValueError("fill requires counts")
    if (counts_payload is None) != (ct_out is None):
        raise ValueError("counts_payload and ct_out go together")
    if min(m, pn, nq, s, d, ww) < 1 or min(s0, c0, src_off) < 0:
        raise ValueError("assemble_words: sizes must be positive and "
                         "offsets non-negative")
    if c0 + d > m:
        raise ValueError(f"destination chunk [{c0}, {c0 + d}) passes m={m}")
    if ww > 2**31 - 8 or nq * pn * d * s >= 2**31 or pn * m * ww >= 2**31:
        raise ValueError("assemble_words: a message's words, the chunk's "
                         "messages and a row's send words must fit in 31 "
                         "bits")
    rows = (nq - 1) * m + s0 + s               # last source row + 1
    reads = []                                 # the ranges the chunk reads
    for name, t, off, words in (("src", src, src_off, pn * m * ww),
                                ("counts", counts, cnt_off, pn * m),
                                ("counts_payload", counts_payload, cp_off,
                                 pn * m)):
        if t is None:
            continue
        if t.dim() != 2 or t.shape[0] < rows or t.shape[1] < off + words:
            raise ValueError(
                f"assemble_words: {name} {tuple(t.shape)} lacks rows "
                f"[0, {rows}) or words [{off}, {off + words})")
        reads.append((t, off, off + words))
    out = _dest(out, (nq, pn, d, s, ww), "out", True)
    if ct_out is not None:
        ct_out = _dest(ct_out, (nq, pn, d, s), "ct_out", False)
    for name, t, run in (("out", out, ww), ("ct_out", ct_out, 1)):
        if t is None:
            continue
        base = t.untyped_storage().data_ptr()
        for r, lo, hi in reads:
            if base == r.untyped_storage().data_ptr() and _meets(
                    (t.data_ptr() - r.data_ptr()) // t.element_size(),
                    tuple(t.shape[:4]),
                    t.stride()[:4], run, (nq, m, s0, s), r.shape[0],
                    r.stride(0), lo, hi):
                raise ValueError(f"assemble_words: {name} overlaps the "
                                 "words the chunk reads")
    return out, ct_out


def assemble_words_plain(src, src_off, m, pn, nq, s0, s, c0, d, ww, out,
                         counts=None, cnt_off=0, fill=None,
                         counts_payload=None, cp_off=0, ct_out=None) -> None:
    """Plain PyTorch version of :func:`assemble_words` (same arguments)."""
    if out.dim() != 5:
        out = out.view(nq, pn, d, s, ww)
    if ct_out is not None and ct_out.dim() != 4:
        ct_out = ct_out.view(nq, pn, d, s)
    lane = torch.arange(ww, device=src.device)
    for q in range(nq):
        r0 = q * m + s0                        # sender q's first source row
        msgs = src[r0:r0 + s, src_off:src_off + pn * m * ww]
        msgs = msgs.reshape(s, pn, m, ww)[:, :, c0:c0 + d]
        staged = msgs.permute(1, 2, 0, 3)      # [pn, d, s, ww]
        if fill is not None:
            cnt = counts[r0:r0 + s, cnt_off:cnt_off + pn * m]
            cnt = cnt.reshape(s, pn, m)[:, :, c0:c0 + d].permute(1, 2, 0)
            staged = torch.where(
                lane < cnt[..., None], staged,
                torch.tensor(fill, dtype=src.dtype, device=src.device))
        out[q] = staged
        if counts_payload is not None:
            cp = counts_payload[r0:r0 + s, cp_off:cp_off + pn * m]
            ct_out[q] = cp.reshape(s, pn, m)[:, :, c0:c0 + d].permute(1, 2, 0)


def assemble_words(src: torch.Tensor, src_off: int, m: int, pn: int,
                   nq: int, s0: int, s: int, c0: int, d: int, ww: int,
                   out: torch.Tensor, counts: Optional[torch.Tensor] = None,
                   cnt_off: int = 0, fill: Optional[int] = None,
                   counts_payload: Optional[torch.Tensor] = None,
                   cp_off: int = 0,
                   ct_out: Optional[torch.Tensor] = None) -> None:
    """Stage one chunk of the ``P > 1`` exchange for ``nq`` senders into
    ``out``: a ``[nq, pn, d, s, ww]`` int32 view whose last axis is
    contiguous (any strides on the others), or a contiguous tensor of as
    many words (the communication buffer).

    ``src`` is a ``[rows, row_words]`` int32 word tensor with contiguous rows
    (the context store).  Sender ``q``'s local source ``j < s`` is row
    ``q·m + s0 + j``; its message for destination process ``p``'s local
    context ``c0 + dl`` (``dl < d``) is the ``ww`` words at ``src_off +
    (p·m + c0 + dl)·ww`` of that row, and lands at ``out[q, p, dl, j]``.
    With ``fill`` (an int32 word) lanes at or past ``counts[row, cnt_off +
    p·m + c0 + dl]`` are written as ``fill``; with ``counts_payload`` the
    word at the same place of ``counts_payload`` lands at ``ct_out[q, p, dl,
    j]`` (``ct_out``: a ``[nq, pn, d, s]`` view or a contiguous tensor of as
    many words) in the same launch.  On a one-card mesh ``out`` and
    ``ct_out`` may view the receivers' recv rows of the same store, so each
    message lands where it is read; neither may overlap the words the chunk
    reads.

    A CPU ``src`` takes the plain version; a CUDA one launches the kernel.
    """
    out, ct_out = _check_assemble(src, src_off, m, pn, nq, s0, s, c0, d, ww,
                                  out, counts, cnt_off, fill, counts_payload,
                                  cp_off, ct_out)
    if src.device.type == "cpu":
        assemble_words_plain(src, src_off, m, pn, nq, s0, s, c0, d, ww, out,
                             counts, cnt_off, fill, counts_payload, cp_off,
                             ct_out)
        return
    require_cuda("assemble_words", src, counts, counts_payload)
    for t in (out, ct_out):
        if t is not None and (not t.is_cuda or t.dtype != torch.int32):
            raise ValueError("assemble_words: out and ct_out must be int32 "
                             f"CUDA tensors, got {t.dtype} on {t.device}")
    _launch_assemble(src, src_off, m, pn, nq, s0, s, c0, d, ww, out, counts,
                     cnt_off, fill, counts_payload, cp_off, ct_out)


def _launch_assemble(src, src_off, m, pn, nq, s0, s, c0, d, ww, out, counts,
                     cnt_off, fill, counts_payload, cp_off, ct_out) -> None:
    """Kernel 4 on checked CUDA operands (:func:`_check_assemble`'s views):
    ``src`` and ``out`` of one element size (offsets, strides and ``ww`` in
    its elements), ``counts_payload`` and ``ct_out`` of another, ``fill`` the
    element's bits."""
    global ASSEMBLE_LAUNCHES
    masked = fill is not None
    launch("repro_assemble_proc_words", src.device,
           ptr(src), src.stride(0), src_off, m, pn, nq, s0, s, c0, d, ww,
           ptr(out), *out.stride()[:4],
           ptr(counts) if masked else None,
           counts.stride(0) if masked else 0, cnt_off,
           int(fill) if masked else 0,
           ptr(counts_payload),
           0 if counts_payload is None else counts_payload.stride(0), cp_off,
           ptr(ct_out), *(ct_out.stride() if ct_out is not None else (0,) * 4),
           SPAN_WORDS, src.element_size(),
           4 if counts_payload is None else counts_payload.element_size())
    ASSEMBLE_LAUNCHES += 1


def assemble_proc_tiles(
    msgs: torch.Tensor,                       # [s, P, d, ω]
    counts: Optional[torch.Tensor] = None,    # [s, P, d] int32 valid lengths
    counts_payload: Optional[torch.Tensor] = None,  # [s, P, d] raw counts words
    *,
    fill=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns ``(out, ct)`` with ``out[p, d, j] = msgs[j, p, d]`` (lanes ≥
    ``counts[j, p, d]`` replaced by ``fill`` when ``fill`` is not ``None``)
    and ``ct[p, d, j] = counts_payload[j, p, d]`` (``None`` when no payload
    given): one real processor's chunk — axes (source local, destination
    process, destination local, payload) — staged in destination order.
    ``msgs`` and ``counts_payload`` may each be any dtype of 1, 2 or 4 bytes,
    as :func:`deliver_tiles` takes them, and keep it; ``fill`` is a value of
    ``msgs``' dtype."""
    s, pn, d, omega = msgs.shape
    if fill is not None and counts is None:
        raise ValueError("fill requires counts")
    elems = _elems(msgs.contiguous(), "assemble_proc_tiles")
    elems = elems.reshape(s, pn * d * omega)
    out = torch.empty((pn, d, s, omega), dtype=elems.dtype,
                      device=msgs.device)
    fill_bits = cnt = None
    if fill is not None:
        fill_bits = _fill_bits(fill, msgs.dtype)
        cnt = counts.to(torch.int32).reshape(s, pn * d).contiguous()
    ct = cp = None
    if counts_payload is not None:
        cp = _elems(counts_payload.contiguous(), "assemble_proc_tiles")
        cp = cp.reshape(s, pn * d)
        ct = torch.empty((pn, d, s), dtype=cp.dtype, device=msgs.device)
    # One sender (nq = 1) whose destination processes are d contexts apart.
    chunk = (elems, 0, d, pn, 1, 0, s, 0, d, omega)
    out_v, ct_v = _check_assemble(*chunk, out, cnt, 0, fill_bits, cp, 0, ct)
    if elems.device.type == "cpu":
        run = assemble_words_plain
    else:
        _require_cuda_counts("assemble_proc_tiles", cnt, cp)
        run = _launch_assemble
    run(*chunk, out_v, cnt, 0, fill_bits, cp, 0, ct_v)
    out = out.view(msgs.dtype)
    if ct is not None:
        ct = ct.view(counts_payload.dtype)
    return out, ct
