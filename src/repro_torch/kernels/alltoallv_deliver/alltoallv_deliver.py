"""Direct message delivery (thesis §6.2) on the GPU.

Replaces the TPU kernel ``deliver_tiles``
(``src/repro/kernels/alltoallv_deliver/alltoallv_deliver.py:79``):
``out[d, s, :] = msgs[s, d, :]``, lanes at or past ``counts[s, d]`` set to
``fill``, and the fused counts transpose ``ct[d, s] = counts_payload[s, d]``.

The CUDA kernel (``csrc/alltoallv_deliver.cu``, entry
``repro_deliver_words``) addresses every operand as raw int32 words through
``(tensor [rows, row_words], word offset)``, so :func:`deliver_words` can
deliver straight between the word ranges of the context store — message
``(s -> d)`` from row ``s`` at ``src_off + d·ww`` into row ``d`` at
``dst_off + s·ww`` — with no ``[v, v, ww]`` temporary.  :func:`deliver_tiles`
is the JAX kernel's array form on top of it.

:func:`deliver_words_plain` is the plain PyTorch version: the CPU path, and
what ``chip_smoke.py`` holds the kernel against on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._build import launch, ptr, require_cuda

LAUNCHES = 0   # calls of deliver_words that launched the CUDA kernel


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
                          torch.tensor(fill, dtype=torch.int32,
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
    global LAUNCHES
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
    masked = fill is not None
    launch("repro_deliver_words", src.device,
           ptr(src), src.stride(0), src_off, ptr(dst), dst.stride(0), dst_off,
           v, ww,
           ptr(counts) if masked else None,
           counts.stride(0) if masked else 0, cnt_off,
           int(fill) if masked else 0,
           ptr(counts_payload),
           0 if counts_payload is None else counts_payload.stride(0), cp_off,
           ptr(ct_out), 0 if ct_out is None else ct_out.stride(0), ct_off)
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
    ``msgs`` and ``counts_payload`` may be any 4-byte dtype; ``fill`` is a
    value of ``msgs``' dtype."""
    v, v2, omega = msgs.shape
    if v != v2:
        raise ValueError(f"msgs must be [v, v, ω], got {tuple(msgs.shape)}")
    if fill is not None and counts is None:
        raise ValueError("fill requires counts")
    words = _words(msgs.contiguous()).reshape(v, v * omega)
    out = torch.empty_like(words)
    fill_word = None
    if fill is not None:
        fill_word = int(torch.tensor(fill, dtype=msgs.dtype)
                        .view(torch.int32))
        counts = counts.to(torch.int32).contiguous()
    ct = cp = None
    if counts_payload is not None:
        cp = _words(counts_payload.contiguous())
        ct = torch.empty_like(cp)
    deliver_words(words, 0, out, 0, v, omega, counts, 0, fill_word, cp, 0,
                  ct, 0)
    out = out.reshape(v, v, omega).view(msgs.dtype)
    if ct is not None:
        ct = ct.view(counts_payload.dtype)
    return out, ct


def _words(x: torch.Tensor) -> torch.Tensor:
    if x.element_size() != 4:
        raise TypeError(f"delivery moves 4-byte words, got {x.dtype}")
    return x if x.dtype == torch.int32 else x.view(torch.int32)
