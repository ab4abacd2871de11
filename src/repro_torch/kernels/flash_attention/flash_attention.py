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
decides; flash-decoding's split).  Head dims 16, 32, 64, 80, 128 and 256
are built.

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
0), ``sk_valid``, ``window`` (the JAX model's local mask: a query at
position ``p`` sees the keys ``k > p - window``; 0 is none) and ``prefix``
(the JAX model's prefix-LM mask under ``causal``, ``(k <= p) | (k <
prefix)``, for the patches frontend's prefill: a row's causal limit becomes
``max(p, prefix - 1)``, and the window still applies after it).  The model's
decode step (``Sq = 1``, ``q_offset = pos``, ``sk_valid = pos + 1``) is thus
the same call as its prefill.  :func:`attend_plain` is its plain PyTorch
version (the masked softmax of ``ref.attention_ref`` extended to
``q_offset``, ``sk_valid``, ``window``, ``prefix`` and any strides), which a
CPU tensor
takes.  :func:`flash_attention_bh` keeps the TPU kernel's ``[B·H, S, d]``
signature for the parity tests only.

Training: when autograd needs a gradient of ``attend``'s inputs, the call
goes through :class:`_Attend`.  On a CUDA tensor its forward launches the
kernel with the per-row log-sum-exp ``lse`` (:func:`attend_with_lse`) and its
backward launches kernel 5b, the hand-written backward
(``csrc/flash_attention_bwd.cu``, :func:`attend_backward`), or raises; on a
CPU tensor it takes :func:`attend_plain` and :func:`attend_backward_plain`,
the explicit gradient formula.  Kernel 5b's bf16 passes run on the tensor
cores at every head dim, P and dS entering their products as bf16 hi + lo
as the forward's P does; at head dim 256 they are passes of their own (warp
pairs on each 16 keys, and the dK/dV pass's rows cut into slices when its
key tiles are too few for the card, :func:`_bwd_slices`).  fp32 takes FMA
kernels with fp32 sums.  The JAX package has no backward kernel: its
gradient is XLA's autodiff of ``layers.attention``
(``src/repro/models/layers.py:99-174``), what the tests hold both against.

The launches are PyTorch ops, ``repro_torch::flash_attention``,
``flash_attention_lse`` and ``flash_attention_bwd`` (:data:`FLASH`,
:data:`FLASH_LSE`, :data:`FLASH_BWD`), each with a fake
implementation (shapes and dtypes only), a flop formula
(:func:`attention_flops`) and a DTensor sharding rule
(:func:`register_sharding_rules`), so a trace under ``FakeTensorMode``
(``repro_torch.launch.dryrun``) runs the card's path without a card."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from .._build import define_op, launch, library, ptr

LAUNCHES = 0   # calls that launched the CUDA kernel (the forward)
BWD_LAUNCHES = 0   # calls of attend_backward that launched kernel 5b
HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # head dims the CUDA kernels take
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Keys per K/V tile of the bf16 prefill kernel at head dim 256; the kernel is
# built for 32 and 64 (``scripts/flash_d256_tiles.py`` compares them).
D256_PREFILL_BK = 32
# Kernel 5b's passes at head dim 256 (bf16): the dK/dV pass's keys a block
# and its Q and dO ring rows, and the dQ pass's keys a ring tile, as the
# kernel has them (``Tile256``; :func:`_check_bwd256_tiles` holds the two
# equal); and the fewest query rows (of a KV head's group) a row slice of
# the dK/dV pass is planned for.
BWD256_BK = 64
BWD256_SUB = 32
BWD256_QBK = 32
BWD256_SLICE_ROWS = 256


def _probs_plain(q, k, *, causal: bool, sk_valid: int | None, q_offset: int,
                 scale: float | None, window: int, prefix: int):
    """``(p, lse)``: the masked softmax ``p [B, Hkv, group, Sq, Sk]`` (fp32,
    zero rows where no key is left) of q ``[B, Sq, Hq, d]`` over k ``[B, Sk,
    Hkv, d]``, and each row's natural log-sum-exp of its scaled, masked
    scores ``lse [B, Hq, Sq]`` (+inf where no key is left)."""
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
        mask = mask & ((col[None, :] <= row[:, None]) | (col < prefix)[None, :])
    if window > 0:
        mask = mask & (col[None, :] > row[:, None] - window)
    s = torch.where(mask, s, -1e30)
    top = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - top), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0.0, 1.0, denom)
    lse = torch.where(denom == 0.0, math.inf, top + torch.log(denom))
    return p, lse.reshape(b, hq, sq)


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, sk_valid: int | None = None, q_offset: int = 0,
                 scale: float | None = None, window: int = 0,
                 prefix: int = 0) -> torch.Tensor:
    """Masked-softmax attention of q ``[B, Sq, Hq, d]`` over k, v ``[B, Sk,
    Hkv, d]``: query row ``i`` sits at position ``q_offset + i``; keys at or
    past ``sk_valid``, if ``causal`` after the row's position and not before
    ``prefix``, and with a ``window`` at or before the row's position minus
    ``window`` are masked; a row with no key left gives zeros."""
    return attend_plain_with_lse(q, k, v, causal=causal, sk_valid=sk_valid,
                                 q_offset=q_offset, scale=scale, window=window,
                                 prefix=prefix)[0]


def attend_plain_with_lse(q, k, v, *, causal: bool,
                          sk_valid: int | None = None, q_offset: int = 0,
                          scale: float | None = None, window: int = 0,
                          prefix: int = 0):
    """:func:`attend_plain` and each row's log-sum-exp ``lse [B, Hq, Sq]``
    (fp32; +inf for a row with no key): the plain version of
    :func:`attend_with_lse`."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    p, lse = _probs_plain(q, k, causal=causal, sk_valid=sk_valid,
                          q_offset=q_offset, scale=scale, window=window,
                          prefix=prefix)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype), lse


def attend_backward_plain(q, k, v, out, dout, *, causal: bool,
                          sk_valid: int | None = None, q_offset: int = 0,
                          scale: float | None = None, window: int = 0,
                          prefix: int = 0):
    """The gradients ``(dq, dk, dv)`` of :func:`attend_plain` at ``(q, k,
    v)`` given its output ``out`` and the output's gradient ``dout``, by the
    explicit formula in fp32: ``dV = Pᵀ dO``, ``dP = dO Vᵀ``, ``D = rowsum(dO
    ∘ O)``, ``dS = P ∘ (dP − D)``, ``dQ = dS K · scale``, ``dK = dSᵀ Q ·
    scale``, a KV head's dK and dV summed over its group's query heads; each
    in its input's dtype.  ``P`` is the masked softmax, recomputed here."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    p, _ = _probs_plain(q, k, causal=causal, sk_valid=sk_valid,
                        q_offset=q_offset, scale=scale, window=window,
                        prefix=prefix)
    do = dout.reshape(b, sq, hkv, group, d).float()
    dsum = (do * out.reshape(b, sq, hkv, group, d).float()).sum(-1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, v.float())
    ds = p * (dp - dsum.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds,
                      q.reshape(b, sq, hkv, group, d).float()) * scale
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, sk_valid: int | None = None, q_offset: int = 0,
           scale: float | None = None, window: int = 0,
           prefix: int = 0) -> torch.Tensor:
    """Attention of q ``[B, Sq, Hq, d]`` over k, v ``[B, Sk, Hkv, d]`` (any
    strides, ``d`` contiguous on the GPU) → ``[B, Sq, Hq, d]``.  A CPU tensor
    takes :func:`attend_plain`; a CUDA tensor launches the kernel or
    raises.  When autograd needs a gradient of q, k or v, the call goes
    through :class:`_Attend` (kernel 5b backward on the card)."""
    kw = _options(q, k, v, causal=causal, sk_valid=sk_valid,
                  q_offset=q_offset, scale=scale, window=window,
                  prefix=prefix)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attend.apply(q, k, v, kw)
    if q.device.type == "cpu":
        return attend_plain(q, k, v, **kw)
    return FLASH(q, k, v, *_attention_args(kw))


def attend_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, sk_valid: int | None = None,
                    q_offset: int = 0, scale: float | None = None,
                    window: int = 0, prefix: int = 0):
    """:func:`attend`'s output and each query row's natural log-sum-exp of
    its scaled, masked scores, ``lse [B, Hq, Sq]`` fp32 (+inf for a row that
    sees no key), what the backward rebuilds the probabilities from.  A CPU
    tensor takes :func:`attend_plain_with_lse`; a CUDA tensor launches the
    kernel (and, when the keys are split, the merge writes ``lse``)."""
    kw = _options(q, k, v, causal=causal, sk_valid=sk_valid,
                  q_offset=q_offset, scale=scale, window=window,
                  prefix=prefix)
    if q.device.type == "cpu":
        return attend_plain_with_lse(q, k, v, **kw)
    return FLASH_LSE(q, k, v, *_attention_args(kw))


def _options(q, k, v, *, causal, sk_valid, q_offset, scale, window,
             prefix) -> dict:
    """Check the shapes and masks of an attention call; its keywords with
    every default filled in."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or hkv == 0 or hq % hkv):
        raise ValueError(f"attend: q {tuple(q.shape)} with k {tuple(k.shape)}"
                         f" and v {tuple(v.shape)}: need [B, Sk, Hkv, d] "
                         "keys and values with Hq a multiple of Hkv")
    window, q_offset, prefix = int(window), int(q_offset), int(prefix)
    if window < 0:
        raise ValueError(f"attend: window must be 0 (none) or positive, got "
                         f"{window}")
    if prefix < 0:
        raise ValueError(f"attend: prefix must be 0 (none) or positive, got "
                         f"{prefix}")
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    sk_valid = sk if sk_valid is None else int(sk_valid)
    return dict(causal=bool(causal), sk_valid=sk_valid, q_offset=q_offset,
                scale=scale, window=window, prefix=prefix)


def _check_cuda(what: str, q: torch.Tensor, *tensors) -> None:
    """Raise unless q and ``tensors`` are CUDA tensors of q's dtype, which
    the kernels take, with the head dim contiguous (bf16: aligned for the
    16-byte copies) and a head dim the kernels are built for."""
    d = q.shape[-1]
    for t in (q, *tensors):
        if not t.is_cuda or t.dtype != q.dtype:
            raise ValueError(f"{what}: q, k and v must be CUDA tensors of one "
                             f"dtype, got {t.device} {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: the head dim must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: the kernel takes {list(_DTYPES)}, got "
                        f"{q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: the kernel is built for head dims "
                         f"{HEAD_DIMS}, got {d}")
    if q.dtype == torch.bfloat16:
        for name, t in zip(("q", "k", "v", "out", "dout"), (q, *tensors)):
            _check_aligned(name, t)


def _attention_args(kw: dict) -> tuple:
    """The mask keywords of :func:`_options` in the ops' schema order."""
    return (kw["causal"], kw["sk_valid"], kw["q_offset"], kw["scale"],
            kw["window"], kw["prefix"])


_MASK = ("bool causal, int sk_valid, int q_offset, float scale, int window, "
         "int prefix")


def _flash(q, k, v, causal, sk_valid, q_offset, scale, window, prefix):
    """Kernel 5: the output ``[B, Sq, Hq, d]``."""
    return _launch(q, k, v, causal, sk_valid, q_offset, scale, window,
                   prefix, with_lse=False)[0]


def _flash_fake(q, k, v, causal, sk_valid, q_offset, scale, window, prefix):
    return q.new_empty(q.shape)


def _flash_lse(q, k, v, causal, sk_valid, q_offset, scale, window, prefix):
    """Kernel 5 with each row's log-sum-exp: ``(out, lse [B, Hq, Sq])``."""
    return _launch(q, k, v, causal, sk_valid, q_offset, scale, window,
                   prefix, with_lse=True)


def _flash_lse_fake(q, k, v, causal, sk_valid, q_offset, scale, window,
                    prefix):
    b, sq, hq, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, hq, sq), dtype=torch.float32))


def _flash_bwd(q, k, v, out, dout, lse, causal, sk_valid, q_offset, scale,
               window, prefix):
    """Kernel 5b: ``(dq, dk, dv)``, contiguous, in q's, k's and v's
    shapes."""
    return _launch_bwd(q, k, v, out, dout, lse, causal, sk_valid, q_offset,
                       scale, window, prefix)


def _flash_bwd_fake(q, k, v, out, dout, lse, causal, sk_valid, q_offset,
                    scale, window, prefix):
    return (q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape))


FLASH = define_op(
    f"flash_attention(Tensor q, Tensor k, Tensor v, {_MASK}) -> Tensor",
    _flash, _flash_fake)
FLASH_LSE = define_op(
    f"flash_attention_lse(Tensor q, Tensor k, Tensor v, {_MASK}) "
    "-> (Tensor, Tensor)", _flash_lse, _flash_lse_fake)
FLASH_BWD = define_op(
    "flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, "
    f"Tensor dout, Tensor lse, {_MASK}) -> (Tensor, Tensor, Tensor)",
    _flash_bwd, _flash_bwd_fake)


def visible_pairs(sq: int, sk: int, *, causal: bool, sk_valid: int,
                  q_offset: int, window: int, prefix: int) -> int:
    """The (query row, key) pairs an attention call's mask leaves, for one
    head: row ``i`` at position ``p = q_offset + i`` sees the keys ``k <
    min(sk, sk_valid)``, with ``causal`` those ``k <= max(p, prefix - 1)``,
    and with a ``window`` those ``k > p - window``."""
    p = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.full(sq, max(0, min(sk, sk_valid)), dtype=np.int64)
    if causal:
        hi = np.minimum(hi, np.maximum(p, prefix - 1) + 1)
    lo = np.maximum(p - window + 1, 0) if window else np.zeros_like(p)
    return int(np.maximum(hi - lo, 0).sum())


def attention_flops(q_shape, k_shape, *, causal: bool, sk_valid: int,
                    q_offset: int, window: int, prefix: int,
                    backward: bool = False) -> int:
    """The floating-point operations of the function kernels 5 and 5b
    compute, from the shapes and the mask, whatever their passes: with ``n``
    the :func:`visible_pairs` of a head, the forward's two products ``S =
    Q·Kᵀ`` and ``O = P·V`` take ``2·n·d`` each, ``4·n·d·Hq·B`` in all; the
    backward's five (``S`` again, ``dP = dO·Vᵀ``, ``dV = Pᵀ·dO``, ``dQ =
    dS·K``, ``dK = dSᵀ·Q``) take ``10·n·d·Hq·B``.  The softmax's elementwise
    work is not counted, as ``torch.utils.flop_counter`` counts none for
    ``scaled_dot_product_attention``."""
    b, sq, hq, d = q_shape
    n = visible_pairs(sq, k_shape[1], causal=causal, sk_valid=sk_valid,
                      q_offset=q_offset, window=window, prefix=prefix)
    return (10 if backward else 4) * n * d * hq * b


@register_flop_formula([torch.ops.repro_torch.flash_attention,
                        torch.ops.repro_torch.flash_attention_lse])
def _(q_shape, k_shape, v_shape, causal, sk_valid, q_offset, scale, window,
      prefix, *args, out_shape=None, **kwargs) -> int:
    return attention_flops(q_shape, k_shape, causal=causal,
                           sk_valid=sk_valid, q_offset=q_offset,
                           window=window, prefix=prefix)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _(q_shape, k_shape, v_shape, out_shape_, dout_shape, lse_shape, causal,
      sk_valid, q_offset, scale, window, prefix, *args, out_shape=None,
      **kwargs) -> int:
    return attention_flops(q_shape, k_shape, causal=causal,
                           sk_valid=sk_valid, q_offset=q_offset,
                           window=window, prefix=prefix, backward=True)


def register_sharding_rules() -> None:
    """Kernels 5 and 5b with DTensor operands: local on the batch and on the
    heads (of q and of k and v alike, so each device keeps whole groups)."""
    from .._sharding import register
    ops = torch.ops.repro_torch
    register(ops.flash_attention.default,
             {"batch": ((0, 0, 0), (0,)), "heads": ((2, 2, 2), (2,))})
    register(ops.flash_attention_lse.default,
             {"batch": ((0, 0, 0), (0, 0)), "heads": ((2, 2, 2), (2, 1))})
    register(ops.flash_attention_bwd.default,
             {"batch": ((0,) * 6, (0, 0, 0)),
              "heads": ((2, 2, 2, 2, 2, 1), (2, 2, 2))})


def _launch(q, k, v, causal, sk_valid, q_offset, scale, window, prefix, *,
            with_lse: bool):
    """Kernel 5 on CUDA tensors: ``(out, lse or None)``."""
    global LAUNCHES
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    _check_cuda("attend", q, k, v)
    bq, bk, splits, split_len = _plan(
        _sms(q.device), q.dtype, b, sq * (hq // hkv), hkv, d, sk=sk,
        sk_valid=sk_valid, q_offset=q_offset, window=window)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    part = (torch.empty((splits, b, hkv, sq * (hq // hkv), d + 2),
                        dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    launch("repro_flash_attention", q.device,
           ptr(q), *q.stride()[:3], ptr(k), *k.stride()[:3],
           ptr(v), *v.stride()[:3], ptr(out), *out.stride()[:3], ptr(part),
           ptr(lse), b, sq, sk, hq, hkv, d, sk_valid, q_offset,
           int(causal), window, prefix, _DTYPES[q.dtype], bq, bk, splits,
           split_len, scale)
    LAUNCHES += 1
    return out, lse


def _launch_bwd(q, k, v, out, dout, lse, causal, sk_valid, q_offset, scale,
                window, prefix):
    """Kernel 5b on CUDA tensors (checked by :func:`attend_backward`):
    ``(dq, dk, dv)``."""
    global BWD_LAUNCHES
    _check_cuda("attend_backward", q, k, v, out, dout)
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if sq == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if q.dtype == torch.bfloat16 and d == 256:
        _check_bwd256_tiles()
    dsum = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    slices = _bwd_slices(_sms(q.device), q.dtype, b, sq * (hq // hkv), hkv,
                         d, sk)
    part = (torch.empty((2, slices, b, sk, hkv, d), dtype=torch.float32,
                        device=q.device) if slices > 1 else None)
    launch("repro_flash_attention_bwd", q.device,
           ptr(q), *q.stride()[:3], ptr(k), *k.stride()[:3],
           ptr(v), *v.stride()[:3], ptr(out), *out.stride()[:3],
           ptr(dout), *dout.stride()[:3], ptr(lse), ptr(dsum),
           ptr(dq), *dq.stride()[:3], ptr(dk), *dk.stride()[:3],
           ptr(dv), *dv.stride()[:3], ptr(part), slices, b, sq, sk, hq, hkv,
           d, sk_valid, q_offset, int(causal), window, prefix,
           _DTYPES[q.dtype], scale)
    BWD_LAUNCHES += 1
    return dq, dk, dv


def attend_backward(q, k, v, out, dout, lse, *, causal: bool,
                    sk_valid: int | None = None, q_offset: int = 0,
                    scale: float | None = None, window: int = 0,
                    prefix: int = 0):
    """Kernel 5b: the gradients ``(dq, dk, dv)`` of :func:`attend` at ``(q,
    k, v)`` given its output ``out``, the output's gradient ``dout`` and the
    forward's ``lse`` (:func:`attend_with_lse`), on CUDA tensors (the
    forward's dtypes, layouts and alignment; ``dout`` is made contiguous, as
    autograd may hand in a strided one).  A CPU tensor takes
    :func:`attend_backward_plain` (which recomputes the probabilities and
    needs no ``lse``)."""
    kw = _options(q, k, v, causal=causal, sk_valid=sk_valid,
                  q_offset=q_offset, scale=scale, window=window,
                  prefix=prefix)
    if q.device.type == "cpu":
        return attend_backward_plain(q, k, v, out, dout, **kw)
    dout = dout.contiguous()
    b, sq, hq, d = q.shape
    if (tuple(out.shape) != tuple(q.shape) or dout.shape != out.shape
            or lse is None or tuple(lse.shape) != (b, hq, sq)
            or lse.dtype != torch.float32 or not lse.is_contiguous()):
        raise ValueError("attend_backward: out and dout must be [B, Sq, Hq, "
                         "d] and lse the forward's fp32 [B, Hq, Sq]")
    return FLASH_BWD(q, k, v, out, dout, lse, *_attention_args(kw))


class _Attend(torch.autograd.Function):
    """:func:`attend` with its gradient: on CUDA kernel 5 with ``lse``, then
    kernel 5b; on the CPU the plain versions.  No ``try`` falls back."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = attend_with_lse(q, k, v, **kw)
        ctx.kw = kw
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*attend_backward(q, k, v, out, dout, lse, **ctx.kw), None)


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
    (``splits`` 1, ``split_len`` 0) takes every key.  A ``prefix`` changes
    nothing here: the live keys end at ``sk_valid`` with or without it (a
    split past a block's causal limit gives it no key, ``l = 0`` in the
    merge)."""
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


@functools.cache
def _check_bwd256_tiles() -> None:
    """Raise unless the built kernel's head-dim-256 tiles are
    :data:`BWD256_BK`, :data:`BWD256_SUB` and :data:`BWD256_QBK`, which the
    slice plan and the tests' model of the kernel take."""
    lib = library()
    got = tuple(lib.repro_flash_attention_bwd256_tile(i) for i in range(3))
    if got != (BWD256_BK, BWD256_SUB, BWD256_QBK):
        raise RuntimeError(f"kernel 5b's head-dim-256 tiles (BK, SUB, QBK) "
                           f"are {got}, the wrapper's "
                           f"{(BWD256_BK, BWD256_SUB, BWD256_QBK)}")


def _bwd_slices(sms: int, dtype: torch.dtype, b: int, rows: int, hkv: int,
                d: int, sk: int) -> int:
    """The row slices of kernel 5b's dK/dV pass on a card of ``sms`` SMs:
    bf16 at head dim 256 takes one block (8 warps, one an SM) a
    :data:`BWD256_BK`-key tile, batch and KV head, too few to fill the card
    at recurrentgemma's call (96), so each tile's rows are cut into the
    fewest slices that give at least ``sms`` blocks, each slice at least
    :data:`BWD256_SLICE_ROWS` of the ``rows`` query rows of a KV head's
    group; every other dtype and head dim takes 1.  A slice takes a
    contiguous run of the tile's 32-row ring tiles, and a last launch adds
    the slices' fp32 partial dK and dV in slice order."""
    if dtype != torch.bfloat16 or d != 256:
        return 1
    blocks = -(-sk // BWD256_BK) * b * hkv
    return max(1, min(-(-sms // blocks), rows // BWD256_SLICE_ROWS))


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
