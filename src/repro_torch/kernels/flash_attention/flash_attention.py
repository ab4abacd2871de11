"""Flash attention on the GPU: online softmax over KV tiles, GQA, causal
skip, sliding window, length mask.

Replaces the TPU kernel ``flash_attention_bh``
(``src/repro/kernels/flash_attention/flash_attention.py:78``), which is also
the function of the JAX model's ``layers.attention`` ("the XLA twin of the
Pallas flash kernel").  The CUDA entry ``repro_flash_attention``
(``csrc/flash_attention.cu``) gives one block a (batch, KV head, tile of query
rows); the tile packs the KV head's whole group of query heads, so each K/V
tile is read once per KV head.  A loop inside the block streams the K/V tiles
with the running (m, l, acc) in registers, and stops at the last tile any of
its rows may see, so wholly masked causal tiles and keys at or past
``sk_valid`` are never loaded; with a ``window`` it starts at the first tile
its first row may see, so tiles wholly before the window are never loaded
either.  It reads every tensor through its strides, so the model's ``[B, S,
H, d]`` KV cache is attended in place.  When the row tiles alone give too few
blocks to fill the card, as in decode, the live keys are cut into ranges, one
block each, and a second launch merges their partial results (:func:`_plan`
decides; flash-decoding's split).  Head dims 16, 32, 64, 128 and 256 are
built.  Inputs are float32 or bfloat16; the sums are float32 and the output
has the input type, as on the TPU.  What bounds it and why it is far from
that bound is in the source's note.

:func:`attend` is the entry: ``[B, Sq, Hq, d]`` queries over ``[B, Sk, Hkv,
d]`` keys and values, with ``q_offset`` (the absolute position of query row
0), ``sk_valid`` and ``window`` (the JAX model's local mask: a query at
position ``p`` sees the keys ``k > p - window``; 0 is none).  The model's
decode step (``Sq = 1``, ``q_offset = pos``, ``sk_valid = pos + 1``) is thus
the same call as its prefill.  :func:`attend_plain` is its plain PyTorch
version (the masked softmax of ``ref.attention_ref`` extended to
``q_offset``, ``sk_valid``, ``window`` and any strides), which a CPU tensor
takes.  :func:`flash_attention_bh` keeps the TPU kernel's ``[B·H, S, d]``
signature for the parity tests only.
"""

from __future__ import annotations

import math

import torch

from .._build import launch, ptr

LAUNCHES = 0   # calls of attend that launched the CUDA kernel
HEAD_DIMS = (16, 32, 64, 128, 256)   # head dims the CUDA kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BK = 32   # keys per KV tile of the CUDA kernel


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, sk_valid: int | None = None, q_offset: int = 0,
                 scale: float | None = None, window: int = 0) -> torch.Tensor:
    """Masked-softmax attention of q ``[B, Sq, Hq, d]`` over k, v ``[B, Sk,
    Hkv, d]``: query row ``i`` sits at position ``q_offset + i``; keys at or
    past ``sk_valid``, if ``causal`` after the row's position, and with a
    ``window`` at or before the row's position minus ``window`` are masked;
    a row with no key left gives zeros."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    group = hq // hkv
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    sk_valid = sk if sk_valid is None else sk_valid
    qh = q.reshape(b, sq, hkv, group, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float()) * scale
    col = torch.arange(sk, device=q.device)
    row = q_offset + torch.arange(sq, device=q.device)
    mask = (col < sk_valid)[None, :]
    if causal:
        mask = mask & (col[None, :] <= row[:, None])
    if window > 0:
        mask = mask & (col[None, :] > row[:, None] - window)
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0.0, 1.0, denom)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, sk_valid: int | None = None, q_offset: int = 0,
           scale: float | None = None, window: int = 0) -> torch.Tensor:
    """Attention of q ``[B, Sq, Hq, d]`` over k, v ``[B, Sk, Hkv, d]`` (any
    strides, ``d`` contiguous on the GPU) → ``[B, Sq, Hq, d]``.  A CPU tensor
    takes :func:`attend_plain`; a CUDA tensor launches the kernel or
    raises."""
    global LAUNCHES
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or hkv == 0 or hq % hkv):
        raise ValueError(f"attend: q {tuple(q.shape)} with k {tuple(k.shape)}"
                         f" and v {tuple(v.shape)}: need [B, Sk, Hkv, d] "
                         "keys and values with Hq a multiple of Hkv")
    window, q_offset = int(window), int(q_offset)
    if window < 0:
        raise ValueError(f"attend: window must be 0 (none) or positive, got "
                         f"{window}")
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    sk_valid = sk if sk_valid is None else int(sk_valid)
    if q.device.type == "cpu":
        return attend_plain(q, k, v, causal=causal, sk_valid=sk_valid,
                            q_offset=q_offset, scale=scale, window=window)
    for t in (q, k, v):
        if not t.is_cuda or t.dtype != q.dtype:
            raise ValueError(f"attend: q, k and v must be CUDA tensors of one "
                             f"dtype, got {t.device} {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError("attend: the head dim must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"attend: the kernel takes {list(_DTYPES)}, got "
                        f"{q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"attend: the kernel is built for head dims "
                         f"{HEAD_DIMS}, got {d}")
    # The live keys: from the tile holding the first key row 0 may see
    # (the kernel's k_base) to the last valid key.
    lo = _BK * (max(0, q_offset - window + 1) // _BK) if window else 0
    bq, splits, split_len = _plan(q.device, b, sq * (hq // hkv), hkv, d,
                                  max(0, min(max(sk_valid, 0), sk) - lo))
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    part = (torch.empty((splits, b, hkv, sq * (hq // hkv), d + 2),
                        dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    launch("repro_flash_attention", q.device,
           ptr(q), *q.stride()[:3], ptr(k), *k.stride()[:3],
           ptr(v), *v.stride()[:3], ptr(out), *out.stride()[:3], ptr(part),
           b, sq, sk, hq, hkv, d, sk_valid, q_offset, int(bool(causal)),
           window, _DTYPES[q.dtype], bq, splits, split_len, scale)
    LAUNCHES += 1
    return out


def _plan(device: torch.device, b: int, rows: int, hkv: int, d: int,
          keys: int) -> tuple[int, int, int]:
    """The kernel's launch plan: query-row tile ``bq`` (16 when a (batch, KV
    head) has no more rows, as in decode, else 64, or 32 at head dim 256),
    and the ``keys`` live keys cut into ``splits`` ranges of ``split_len`` (a
    multiple of the 32-key tile) so that there are about two blocks per SM
    when the row tiles alone are too few."""
    bq = 16 if rows <= 16 else (32 if d == 256 else 64)
    blocks = -(-rows // bq) * hkv * b
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    kv_tiles = -(-keys // _BK)
    if blocks >= sms or kv_tiles <= 1:
        return bq, 1, 0
    per = -(-kv_tiles // min(kv_tiles, -(-2 * sms // blocks)))
    return bq, -(-kv_tiles // per), per * _BK


def flash_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       h_q: int, h_kv: int, causal: bool,
                       scale: float | None = None,
                       sk_valid: int | None = None) -> torch.Tensor:
    """The TPU kernel's signature: q ``[B·Hq, Sq, d]``, k/v ``[B·Hkv, Sk,
    d]`` → ``[B·Hq, Sq, d]``, kept only so the parity tests can call both
    packages alike; no code of the port calls it.  No padding is needed: the
    kernel masks its own ragged edges, so there are no block sizes to give."""
    bhq, sq, d = q.shape
    _, sk, _ = k.shape
    b = bhq // h_q
    out = attend(q.view(b, h_q, sq, d).transpose(1, 2),
                 k.view(b, h_kv, sk, d).transpose(1, 2),
                 v.view(b, h_kv, sk, d).transpose(1, 2),
                 causal=causal, sk_valid=sk_valid, scale=scale)
    return out.transpose(1, 2).reshape(bhq, sq, d)
