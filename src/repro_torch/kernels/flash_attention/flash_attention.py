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
built.

bfloat16, what the model serves in, runs on the tensor cores: ``mma.sync``
products of bf16 fragments summed in float32, 64 query rows (4 warps of 16)
over 64-key tiles (32 at head dim 256, :data:`D256_PREFILL_BK`), K/V tiles
copied asynchronously two stages ahead, and in decode one 16-row tile whose
4 warps take a quarter of each key tile.  The probabilities go into P·V as
two bf16 parts, ``hi = bf16(p)`` and ``lo = bf16(p - hi)``, so the output
still differs from :func:`attend_plain` by its rounding to bf16 alone.  The
kernel's 16-byte copies need bf16 tensors that start on 16 bytes with
strides in multiples of 8 elements; anything else raises.  float32 keeps an
FMA kernel whose sums are float32 too.  The output has the input type, as on
the TPU.  What bounds each and what its design does about it is in the
source's note.

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

import functools
import math

import torch

from .._build import launch, ptr

LAUNCHES = 0   # calls of attend that launched the CUDA kernel
HEAD_DIMS = (16, 32, 64, 128, 256)   # head dims the CUDA kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Keys per K/V tile of the bf16 prefill kernel at head dim 256; the kernel is
# built for 32 and 64 (``scripts/flash_d256_tiles.py`` compares them).
D256_PREFILL_BK = 32


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
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_aligned(name, t)
    bq, bk, splits, split_len = _plan(
        _sms(q.device), q.dtype, b, sq * (hq // hkv), hkv, d, sk=sk,
        sk_valid=sk_valid, q_offset=q_offset, window=window)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    part = (torch.empty((splits, b, hkv, sq * (hq // hkv), d + 2),
                        dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    launch("repro_flash_attention", q.device,
           ptr(q), *q.stride()[:3], ptr(k), *k.stride()[:3],
           ptr(v), *v.stride()[:3], ptr(out), *out.stride()[:3], ptr(part),
           b, sq, sk, hq, hkv, d, sk_valid, q_offset, int(bool(causal)),
           window, _DTYPES[q.dtype], bq, bk, splits, split_len, scale)
    LAUNCHES += 1
    return out


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """Raise unless bf16 ``t`` suits the kernel's 16-byte asynchronous
    copies: its data 16-byte aligned and its batch, position and head strides
    (of the dims longer than 1) multiples of 8 elements."""
    strides = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
    if t.data_ptr() % 16 or any(st % 8 for st in strides):
        raise ValueError(
            f"attend: bf16 {name} must start on a 16-byte boundary with its "
            f"batch, position and head strides multiples of 8 elements, got "
            f"an address {t.data_ptr() % 16} bytes past one and strides "
            f"{tuple(t.stride())}")


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _tiles(dtype: torch.dtype, d: int, rows: int) -> tuple[int, int]:
    """The kernel's tile of query rows and keys, ``(bq, bk)``, for ``rows``
    query rows per (batch, KV head).  bf16 (tensor cores): 16 rows when
    there are no more (decode) over 64-key tiles, else 64 rows over 64-key
    tiles (:data:`D256_PREFILL_BK` at head dim 256).  float32 (FMA): 32-key
    tiles, 16 rows, else 64, or 32 at head dim 256."""
    if dtype == torch.bfloat16:
        if rows <= 16:
            return 16, 64
        return 64, (D256_PREFILL_BK if d == 256 else 64)
    return (16 if rows <= 16 else (32 if d == 256 else 64)), 32


def _key_base(q_offset: int, window: int, bk: int) -> int:
    """The first key the kernel's splits start from: the ``bk``-key tile
    holding the first key query row 0 may see (0 without a window)."""
    return bk * (max(0, q_offset - window + 1) // bk) if window else 0


def _plan(sms: int, dtype: torch.dtype, b: int, rows: int, hkv: int, d: int,
          *, sk: int, sk_valid: int, q_offset: int = 0,
          window: int = 0) -> tuple[int, int, int, int]:
    """The kernel's launch plan on a card of ``sms`` SMs: its tile
    ``(bq, bk)`` (:func:`_tiles`), and the live keys, from
    :func:`_key_base` to the last valid one, cut into ``splits`` ranges of
    ``split_len`` keys (a multiple of ``bk``) when the row tiles alone give
    fewer than ``sms`` blocks: the longest ranges of whole tiles that still
    give at least ``sms`` blocks, where there are key tiles enough (fewer
    ranges, fewer partial results for the merge to read).  One range
    (``splits`` 1, ``split_len`` 0) takes every key."""
    bq, bk = _tiles(dtype, d, rows)
    keys = max(0, min(max(sk_valid, 0), sk) - _key_base(q_offset, window, bk))
    blocks = -(-rows // bq) * hkv * b
    kv_tiles = -(-keys // bk)
    if blocks >= sms or kv_tiles <= 1:
        return bq, bk, 1, 0
    # ceil(kv_tiles / per) >= want  <=>  per <= (kv_tiles - 1) // (want - 1)
    want = -(-sms // blocks)
    per = max(1, (kv_tiles - 1) // (want - 1))
    return bq, bk, -(-kv_tiles // per), per * bk


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
