"""RG-LRU linear recurrence on the GPU.

Replaces the TPU kernel ``lru_scan_chunked``
(``src/repro/kernels/lru_scan/lru_scan.py:57``), which is also the function
of the JAX model's prefill twin ``_lru_chunked_jnp``
(``src/repro/models/blocks.py:397``)::

    h_t = a_t ⊙ h_{t−1} + b_t        over [B, S, D], h_{−1} = 0

The CUDA entry ``repro_lru_scan`` (``csrc/lru_scan.cu``) scans in chunks of
``CHUNK`` steps across blocks (each chunk's local scan, the carries between
chunks, each chunk again from its carry), or, where batch × width reaches
``ONE_PASS_CHANNELS`` and so fills the card, runs one thread per (batch,
channel) over the whole sequence.  It writes the final state ``h_fin [B,
D]`` beside ``h``: the model's prefill keeps it in its cache.  Inputs are
float32 and read through their strides (the width contiguous).  What bounds
it is in the source's note.

:func:`lru_chunked_plain` is the plain PyTorch version (``_lru_chunked_jnp``'s
chunked doubling scan, with the final state), which a CPU tensor takes.  The
chunk length changes only the order of the float operations, not the
function: the kernel's chunks are ``CHUNK`` steps whatever ``chunk`` says.

Training: when autograd needs a gradient of ``a`` or ``b``,
:func:`lru_scan_chunked` goes through :class:`_LruScan`, whose forward runs
the scan above and saves ``a`` and ``h``, and whose backward is the reverse
recurrence (:func:`lru_scan_backward`): on a CUDA tensor kernel 7b
(``repro_lru_scan_bwd``, ``csrc/lru_scan_bwd.cu``, counted in
``BWD_LAUNCHES``), on a CPU tensor :func:`lru_backward_plain`.  No kernel of
the JAX package computes it: it replaces XLA's autodiff of
``_lru_chunked_jnp``.

The launches are PyTorch ops, ``repro_torch::lru_scan`` and
``lru_scan_bwd`` (:data:`LRU`, :data:`LRU_BWD`), each with a fake implementation (shapes and dtypes only),
a flop formula (:func:`lru_flops`) and a DTensor sharding rule
(:func:`register_sharding_rules`), so a trace under ``FakeTensorMode``
(``repro_torch.launch.dryrun``) runs the card's path without a card."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from .._build import define_op, launch, ptr

LAUNCHES = 0       # forward scans that launched kernel 7
BWD_LAUNCHES = 0   # calls of lru_scan_backward that launched kernel 7b
CHUNK = 32         # kernel 7's chunk of steps (kChunk in lru_scan.cu)
BWD_CHUNK = 32     # kernel 7b's chunk of steps (kChunk in lru_scan_bwd.cu)
# From this many (batch, channel) pairs up kernel 7 runs its one-pass kernel
# (one thread a channel over the whole sequence), below it the chunked scan.
ONE_PASS_CHANNELS = 16384


def lru_chunked_plain(a, b, chunk: int):
    """a, b [B, S, D] → (h [B, S, D] float32, h_fin [B, D] float32), scanning
    chunks of ``chunk`` steps by doubling, the carry ``h`` between chunks (the
    last chunk padded with the identity ``a = 1, b = 0``)."""
    bsz, s, d = a.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s
    a = F.pad(a.float(), (0, 0, 0, pad), value=1.0)
    b = F.pad(b.float(), (0, 0, 0, pad))
    h = torch.zeros((bsz, d), dtype=torch.float32, device=a.device)
    hs = []
    for c in range(nc):
        av, bv = a[:, c * chunk:(c + 1) * chunk], b[:, c * chunk:(c + 1) * chunk]
        sft = 1
        while sft < chunk:
            # (a, b) composed with its predecessor ``sft`` steps back; the
            # first ``sft`` steps compose with the identity, which leaves
            # them as they are.
            a_prev = torch.cat([torch.ones_like(av[:, :sft]), av[:, :-sft]], 1)
            b_prev = torch.cat([torch.zeros_like(bv[:, :sft]), bv[:, :-sft]], 1)
            av, bv = a_prev * av, b_prev * av + bv
            sft *= 2
        hc = av * h[:, None] + bv
        h = hc[:, -1]
        hs.append(hc)
    out = torch.cat(hs, dim=1) if hs else a
    return out[:, :s], h


def lru_scan_chunked(a, b, *, chunk: int = 256):
    """The recurrence with its final state: → ``(h [B, S, D], h_fin [B,
    D])``, both float32.  A CPU tensor takes :func:`lru_chunked_plain` with
    ``chunk``; a CUDA tensor launches the kernel or raises.  When autograd
    needs a gradient of ``a`` or ``b`` the call goes through
    :class:`_LruScan` (kernel 7b backward on the card)."""
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"lru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)}: need two [B, S, D] tensors")
    if a.dtype != b.dtype or not a.is_floating_point():
        raise TypeError(f"lru_scan: a and b must be floats of one dtype, got "
                        f"{a.dtype} and {b.dtype}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _LruScan.apply(a, b, chunk)
    return _forward(a, b, chunk)


def _require_kernel_operand(t, what: str) -> None:
    if not t.is_cuda or t.dtype != torch.float32:
        raise ValueError(f"{what}: the kernel takes float32 CUDA tensors, "
                         f"got {t.device} {t.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{what}: the width must be contiguous")


def _forward(a, b, chunk: int):
    """:func:`lru_scan_chunked` without autograd."""
    if a.device.type == "cpu":
        return lru_chunked_plain(a, b, chunk)
    return LRU(a, b)


def _lru_scan(a, b):
    """Kernel 7: ``(h [B, S, D], h_fin [B, D])``, float32."""
    return _launch(a, b)


def _lru_scan_fake(a, b):
    bsz, s, d = a.shape
    return (a.new_empty((bsz, s, d), dtype=torch.float32),
            a.new_empty((bsz, d), dtype=torch.float32))


LRU = define_op("lru_scan(Tensor a, Tensor b) -> (Tensor, Tensor)",
                _lru_scan, _lru_scan_fake)


def _launch(a, b):
    global LAUNCHES
    for t in (a, b):
        _require_kernel_operand(t, "lru_scan")
    bsz, s, d = a.shape
    h = torch.empty((bsz, s, d), dtype=torch.float32, device=a.device)
    h_fin = torch.empty((bsz, d), dtype=torch.float32, device=a.device)
    carry = prod = None
    if bsz * d < ONE_PASS_CHANNELS:
        carry = torch.empty((bsz, -(-s // CHUNK), d), dtype=torch.float32,
                            device=a.device)
        prod = torch.empty_like(carry)
    launch("repro_lru_scan", a.device, ptr(a), a.stride(0), a.stride(1),
           ptr(b), b.stride(0), b.stride(1), ptr(h), ptr(h_fin), ptr(carry),
           ptr(prod), bsz, s, d)
    LAUNCHES += 1
    return h, h_fin


def register_sharding_rules() -> None:
    """Kernels 7 and 7b with DTensor operands: local on the batch and on
    the channels."""
    from .._sharding import register
    ops = torch.ops.repro_torch
    register(ops.lru_scan.default,
             {"batch": ((0, 0), (0, 0)), "channels": ((2, 2), (2, 1))})
    register(ops.lru_scan_bwd.default,
             {"batch": ((0, 0, 0, 0), (0, 0)),
              "channels": ((2, 2, 2, 1), (2, 2))})


def lru_flops(shape, *, backward: bool = False) -> int:
    """The floating-point operations of the function kernels 7 and 7b
    compute over ``[B, S, D]``: the forward's ``h_t = a_t·h_{t-1} + b_t``,
    a product and a sum, ``2·B·S·D``; the backward's ``g_t = dh_t +
    a_{t+1}·g_{t+1}`` and ``da_t = g_t·h_{t-1}``, ``3·B·S·D``."""
    bsz, s, d = shape
    return (3 if backward else 2) * bsz * s * d


@register_flop_formula(torch.ops.repro_torch.lru_scan)
def _(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return lru_flops(a_shape)


def lru_backward_plain(a, h, dh, dh_fin=None, chunk: int = 256):
    """The recurrence's gradient, written out: with ``g_t`` the gradient of
    ``h_t`` (its own ``dh_t`` and all it feeds),

        g_t = dh_t + a_{t+1}·g_{t+1},   g_{S−1} = dh_{S−1} + dh_fin,
        db_t = g_t,   da_t = g_t·h_{t−1}   (h_{−1} = 0).

    a, h, dh ``[B, S, D]``, dh_fin ``[B, D]`` or None (zero) → ``(da, db)``
    float32.  The reverse scan is :func:`lru_chunked_plain` on the reversed
    steps with ``a`` shifted by one (``a_S = 1``), in chunks of ``chunk``."""
    a, h, dh = a.float(), h.float(), dh.float()
    rhs = dh.clone()
    if dh_fin is not None and rhs.shape[1]:
        rhs[:, -1] += dh_fin.float()
    a_next = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
    g = lru_chunked_plain(a_next.flip(1), rhs.flip(1), chunk)[0].flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return g * h_prev, g


def lru_scan_backward(a, h, dh, dh_fin=None, *, chunk: int = 256):
    """The gradients ``(da, db)`` of the recurrence from the forward's ``a``
    and ``h`` and the gradients ``dh [B, S, D]`` and ``dh_fin [B, D]`` (None:
    zero), float32.  A CPU tensor takes :func:`lru_backward_plain` with
    ``chunk``; a CUDA tensor launches kernel 7b or raises (``dh`` is made
    width-contiguous first: autograd may hand in a strided one)."""
    if a.dim() != 3 or h.shape != a.shape or dh.shape != a.shape or (
            dh_fin is not None and dh_fin.shape != (a.shape[0], a.shape[2])):
        raise ValueError(f"lru_scan_backward: a {tuple(a.shape)}, h "
                         f"{tuple(h.shape)}, dh {tuple(dh.shape)}: need "
                         "[B, S, D] and dh_fin [B, D] or None")
    if a.device.type == "cpu":
        return lru_backward_plain(a, h, dh, dh_fin, chunk)
    if dh.stride(-1) != 1:
        dh = dh.contiguous()
    if dh_fin is not None:
        dh_fin = dh_fin.contiguous()
    return LRU_BWD(a, h, dh, dh_fin)


def _lru_scan_bwd(a, h, dh, dh_fin):
    """Kernel 7b: ``(da, db)``, float32 ``[B, S, D]``."""
    return _launch_bwd(a, h, dh, dh_fin)


def _lru_scan_bwd_fake(a, h, dh, dh_fin):
    return (a.new_empty(a.shape, dtype=torch.float32),
            a.new_empty(a.shape, dtype=torch.float32))


LRU_BWD = define_op("lru_scan_bwd(Tensor a, Tensor h, Tensor dh, "
                    "Tensor? dh_fin) -> (Tensor, Tensor)", _lru_scan_bwd,
                    _lru_scan_bwd_fake)


def _launch_bwd(a, h, dh, dh_fin):
    global BWD_LAUNCHES
    if dh_fin is not None:
        _require_kernel_operand(dh_fin, "lru_scan_backward")
    for t in (a, h, dh):
        _require_kernel_operand(t, "lru_scan_backward")
    bsz, s, d = a.shape
    da = torch.empty((bsz, s, d), dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    nc = -(-s // BWD_CHUNK)
    carry = torch.empty((bsz, nc, d), dtype=torch.float32, device=a.device)
    prod = torch.empty_like(carry)
    launch("repro_lru_scan_bwd", a.device, ptr(a), a.stride(0), a.stride(1),
           ptr(h), h.stride(0), h.stride(1), ptr(dh), dh.stride(0),
           dh.stride(1), ptr(dh_fin), ptr(da), ptr(db), ptr(carry),
           ptr(prod), bsz, s, d)
    BWD_LAUNCHES += 1
    return da, db


@register_flop_formula(torch.ops.repro_torch.lru_scan_bwd)
def _(a_shape, *args, out_shape=None, **kwargs) -> int:
    return lru_flops(a_shape, backward=True)


class _LruScan(torch.autograd.Function):
    """:func:`lru_scan_chunked` with its gradient: kernel 7 then kernel 7b
    on CUDA, the plain versions on the CPU.  No ``try`` falls back."""

    @staticmethod
    def forward(ctx, a, b, chunk):
        h, h_fin = _forward(a, b, chunk)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(a, h)
        return h, h_fin

    @staticmethod
    def backward(ctx, dh, dh_fin):
        a, h = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(h)
        da, db = lru_scan_backward(a, h, dh, dh_fin, chunk=ctx.chunk)
        return da, db, None
