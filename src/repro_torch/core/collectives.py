"""EM collective communication (thesis §2.2, §6.2, §7), device tier.

Message model: a sending context holds a field of shape ``[v, ω]`` (one padded
message per destination, ω the thesis' per-message bound) plus a ``[v]`` count
field; after Alltoallv the receiving context's ``[v, ω]`` field holds message
``recv[s] = send_of_s[ρ]``.  The destination slot offsets are static layout
offsets — the thesis' shared offset table ``T`` (§6.2).

Two Alltoallv implementations:

* ``mode="direct"``, ``use_kernel=True`` — PEMS2 (Alg 7.1.1/7.1.2) at the
  word level: the delivery kernel (:mod:`repro_torch.kernels.
  alltoallv_deliver`) reads each message from the send field's word range of
  its source context and writes it straight into the recv word range of its
  destination context in the store — no ``[v, v, ω]`` temporary — with the
  receiver's boundary mask (``fill``) and the counts transpose fused into the
  same launch.
* ``mode="indirect"`` or ``use_kernel=False`` — the dense path: the PEMS1
  baseline (Alg 2.2.1) stages every message through a materialised
  "indirect area" copy first; the direct dense route is the seed reference.

With ``P > 1`` on a one-device :class:`~.mesh.Mesh` the direct kernel
route runs per real processor (``_alltoallv_fused_mesh``): the mesh staging
kernel moves each chunk straight from the send word ranges into the
receivers' recv rows (boundary mask and counts transpose fused), so each
message moves once, as at ``P == 1``.  ``alpha=None`` moves everything in
one launch; with ``alpha`` the network phase is α-chunked (Alg 7.1.3): one
launch per (source round of ``k``, destination α-chunk), ≤ α·k·ω words per
process pair.  Over a mesh of cards (a :class:`~.context.MeshStore`,
``_alltoallv_fused_cards``) each sender stages its chunk on its own card
with the same kernel (``nq = 1``, in destination order, mask and counts
transpose fused: the JAX package's ``assemble_proc_tiles`` then
``lax.all_to_all``), ships each ``(q, p)`` slab to card ``p`` and lands it in
``p``'s recv rows there.  The dense route transposes through the mesh's
exchange, :meth:`~.mesh.Mesh.all_to_all` (``_global_transpose``).

On a backing tier (:class:`~.backing.TieredStore`) every collective is
host-side data movement over the (possibly sharded) backing, in numpy, bit
for bit the JAX package's: the Alltoallv stages each destination process's
recv rows through a bounded host buffer, α-chunked and clamped under
``device_cap_bytes`` (``_alltoallv_host``), and writes that shard only.

Both are bit-identical.  The I/O ledger is updated with the thesis' event
counts, independent of the implementation; it equals the JAX package's.

``allgather``/``reduce``/``allreduce`` are one in-place write into the store
on the device tier (at ``P > 1`` on a one-device mesh only the ledger's
network terms differ); on a backing tier they stage host-side as the JAX
package does, and a reduction runs on the executor's device, the same torch
op as the device tier's, so both tiers give the same bits.  Over a mesh of
cards every collective copies between the blocks' cards, and a reduction
gathers its ``[v, n]`` operand onto one card and runs the same op there.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..kernels.alltoallv_deliver import assemble_words, check_fill_range, \
    deliver_words
from .backing import TieredStore, _field_words, np_dtype
from .context import WORD, ContextStore, MeshStore, _from_words, _to_words, \
    device_scope


# --------------------------------------------------------------------------- #
# Alltoallv                                                                    #
# --------------------------------------------------------------------------- #

def alltoallv(
    self,
    store: ContextStore,
    send: str,
    recv: str,
    send_counts: Optional[str] = None,
    recv_counts: Optional[str] = None,
    mode: str = "direct",
    fill=None,
    use_kernel: bool = True,
    procs: Optional[list] = None,
) -> ContextStore:
    """Every VP ρ sends message ``send[d]`` to VP d; after the call VP ρ holds
    ``recv[s] =`` (s's message to ρ) and transposed counts.

    ``send``/``recv`` name ``[v, ω]`` layout fields (``ω`` the per-message
    payload; all byte math below is ``ω`` words × 4 bytes).  ``fill``
    (optional, requires counts) fuses the receiver's boundary mask into
    delivery: lanes past ``send_counts[ρ][d]`` arrive as ``fill`` instead of
    whatever padding the sender left.  ``use_kernel=False`` keeps the seed's
    dense-transpose implementation (bit-identical, for equivalence testing);
    the ledger is unaffected by either knob.  The store is updated in place.

    On a backing tier the collective is host-side data movement over the
    (possibly sharded) backing: each destination shard's recv rows are
    staged through a bounded host buffer and written back to that shard
    only, with measured disk bytes billed to the owning shard's ledger.
    ``procs`` (tiered stores only) restricts the *destination* side to the
    listed processes' shards; on the device tier it raises ``ValueError``,
    as in the JAX package.

    Raises ``ValueError`` for unknown ``mode``, mismatched field shapes,
    ``fill`` without counts or out of the payload dtype's range, ``procs``
    on a device store, or a staging chunk that cannot fit
    ``device_cap_bytes``.
    """
    if mode not in ("direct", "indirect"):
        raise ValueError(f"unknown mode {mode!r}")
    tiered = isinstance(store, TieredStore)
    if procs is not None and not tiered:
        raise ValueError("procs= requires a backing-tier store")
    cfg = self.cfg
    f = store.layout.field(send)
    if store.layout.field(recv).shape != f.shape:
        raise ValueError("send/recv field shapes must match")
    if f.shape[0] != cfg.v:
        raise ValueError(f"alltoallv fields must be [v, ω]; got {f.shape}")
    if fill is not None and (send_counts is None or recv_counts is None):
        raise ValueError("fill requires send_counts/recv_counts")
    if fill is not None:
        check_fill_range(fill, f.dtype)
    omega_b = (int(np.prod(f.shape[1:], dtype=np.int64)) * WORD
               if len(f.shape) > 1 else WORD)

    if tiered:
        store = _alltoallv_host(self, store, send, recv,
                                send_counts, recv_counts, fill, procs)
    elif isinstance(store, MeshStore) and mode == "direct" and use_kernel:
        store = _alltoallv_fused_cards(self, store, send, recv, send_counts,
                                       recv_counts, fill)
    elif isinstance(store, MeshStore):
        store = _alltoallv_dense_cards(self, store, send, recv, send_counts,
                                       recv_counts, mode, fill)
    elif mode == "direct" and use_kernel:
        fused = _alltoallv_fused if cfg.P == 1 else _alltoallv_fused_mesh
        store = fused(self, store, send, recv, send_counts, recv_counts, fill)
    else:
        store = _alltoallv_dense(self, store, send, recv,
                                 send_counts, recv_counts, mode, fill)

    _ledger_alltoallv(self, omega_b, mode)
    return store


def _fill_word(fill, dtype) -> int:
    """The word-level masking convention, in one place: the bit pattern of
    ``fill`` in the payload field's dtype, as a (signed) int32 store word."""
    t = torch.tensor(fill).to(dtype)
    return int(t.view(torch.int32))


def _alltoallv_fused(self, store, send, recv, send_counts, recv_counts, fill):
    """PEMS2 word-level direct delivery (Alg 7.1.1/7.1.2): one kernel launch
    moves every message from the send word range of its source context into
    the recv word range of its destination context, masks lanes past the
    counts with ``fill`` and transposes the counts words."""
    v = self.cfg.v
    lo = store.layout
    data = store.data
    ww = lo.field_words(send) // v             # ω in store words
    off_s, off_r = lo.offset(send), lo.offset(recv)

    src, src_off = data, off_s
    if send == recv:
        # Delivering in place would overwrite messages not yet read: go
        # through a copy of the field (the JAX row loop guards the same).
        src, src_off = store.field_words_view(send).clone(), 0

    has_counts = send_counts is not None and recv_counts is not None
    cnt, cnt_off = None, 0
    fill_word = None
    if fill is not None:
        fill_word = _fill_word(fill, lo.field(send).dtype)
        cs = lo.field(send_counts).dtype
        if cs in (torch.int32, torch.uint32):
            # int32 mask lengths are the counts words themselves.
            cnt, cnt_off = data, lo.offset(send_counts)
        else:
            cnt = store.field(send_counts).reshape(v, v).to(torch.int32)
    cp = ct = None
    cp_off = ct_off = 0
    ct_tmp = False
    if has_counts:
        cs = lo.field(send_counts).dtype
        cr = lo.field(recv_counts).dtype
        cp, cp_off = data, lo.offset(send_counts)
        # The transposed counts land straight in the recv counts words,
        # unless they need a dtype conversion or would overwrite their own
        # source.
        ct_tmp = cs != cr or send_counts == recv_counts
        if ct_tmp:
            ct = torch.empty((v, v), dtype=torch.int32, device=data.device)
        else:
            ct, ct_off = data, lo.offset(recv_counts)
    deliver_words(src, src_off, data, off_r, v, ww, cnt, cnt_off, fill_word,
                  cp, cp_off, ct, ct_off)
    if ct_tmp:
        if cs == cr:
            store = store.with_field_words(recv_counts, ct)
        else:
            store = store.with_field(recv_counts, _from_words(ct, cs).to(cr))
    return store


def _alltoallv_fused_mesh(self, store, send, recv, send_counts, recv_counts,
                          fill):
    """PEMS2 word-level direct delivery over ``P > 1`` real processors of a
    one-device mesh, in Alg 7.1.3's chunks.

    For each chunk one launch of the mesh staging kernel reads every
    sender's messages from the store's send word range and lands each in its
    receiver's recv rows (mask and counts transpose fused): message ``(q, p,
    dl, j)``, sender ``q``'s local source ``s0 + j`` to process ``p``'s
    context ``c0 + dl``, at words ``off_r + (q·m + s0 + j)·ω`` of row ``p·m
    + c0 + dl``, its counts word at ``off_rc + q·m + s0 + j``.  Unchunked
    (``alpha=None``) one chunk covers everything; with ``alpha`` each
    (source round of ``k``, destination α-chunk) is one chunk, ≤ α·k·ω words
    per process pair (Lemma 7.1.9).  A mesh of cards stages each chunk in
    destination order on the sender's card and ships it
    (:func:`_alltoallv_fused_cards`)."""
    cfg = self.cfg
    lo = store.layout
    data = store.data
    v, Pn, m, k = cfg.v, cfg.P, cfg.v_local, cfg.k
    ww = lo.field_words(send) // v             # ω in store words
    off_r = lo.offset(recv)

    # A chunk's landing overwrites words that a later chunk still reads
    # when the fields alias: read those from a copy (the JAX mesh path
    # slices the send words functionally before any landing).
    src, src_off = data, lo.offset(send)
    if send == recv:
        src, src_off = store.field_words_view(send).clone(), 0

    has_counts = send_counts is not None and recv_counts is not None
    cp = cnt = fill_word = None
    cp_off = cnt_off = 0
    if has_counts:
        cs = lo.field(send_counts).dtype
        cr = lo.field(recv_counts).dtype
        cp, cp_off = data, lo.offset(send_counts)
        if send_counts == recv_counts:
            cp, cp_off = store.field_words_view(send_counts).clone(), 0
        # The landed counts view, [P(dst), m, P(src), m] words.
        rc = data[:, lo.offset(recv_counts):lo.offset(recv_counts) + v]
        rc = rc.view(Pn, m, Pn, m)
    if fill is not None:
        fill_word = _fill_word(fill, lo.field(send).dtype)
        if cs in (torch.int32, torch.uint32):
            # int32 mask lengths are the counts words themselves.
            cnt, cnt_off = cp, cp_off
        else:
            cnt = store.field(send_counts).reshape(v, v).to(torch.int32)

    # The recv rows as [P(dst), m (row), P(src), m (slot), ω] words.
    rows = data[:, off_r:off_r + v * ww].view(Pn, m, Pn, m, ww)
    for s0, s, c0, d in _chunks(cfg):
        # Message (q, p, dl, j) lands at rows[p, c0 + dl, q, s0 + j].
        out = rows[:, c0:c0 + d, :, s0:s0 + s].permute(2, 0, 1, 3, 4)
        ct = None
        if has_counts:
            landed = rc[:, c0:c0 + d, :, s0:s0 + s].permute(2, 0, 1, 3)
            ct = landed if cs == cr else torch.empty(
                landed.shape, dtype=torch.int32, device=data.device)
        assemble_words(src, src_off, m, Pn, Pn, s0, s, c0, d, ww, out,
                       cnt, cnt_off, fill_word, cp, cp_off, ct)
        if has_counts and cs != cr:
            landed.copy_(_to_words(_from_words(ct, cs).to(cr)))
    return store


def _chunks(cfg):
    """The network phase's chunks ``(s0, s, c0, d)``: senders' local
    sources ``[s0, s0 + s)`` to each process's local contexts ``[c0, c0 +
    d)`` — one chunk unchunked, else one per (source round of ``k``,
    destination α-chunk) (Alg 7.1.3)."""
    m, k = cfg.v_local, cfg.k
    if cfg.alpha is None:
        return [(0, m, 0, m)]
    return [(s0, k, c0, min(cfg.alpha, m - c0))
            for s0 in range(0, m, k) for c0 in range(0, m, cfg.alpha)]


def _alltoallv_fused_cards(self, store, send, recv, send_counts, recv_counts,
                           fill):
    """PEMS2 word-level direct delivery over a mesh of cards, in Alg
    7.1.3's chunks (:func:`_chunks`), each in three steps:

    1. **stage** — every sender ``q`` runs kernel 4 once on its own card
       (``nq = 1``): its chunk's messages read from its block's send words,
       in destination order, into a contiguous wire buffer ``[P, d, s, ω]``
       (lanes past the counts masked with ``fill``, the counts words
       transposed beside it, converted to the recv counts' dtype there);
    2. **ship** — :meth:`~.mesh.Mesh.all_to_all` copies slab ``(q, p)``
       to card ``p``, ``P − 1`` of each sender's ``P`` off its card, each
       of its ``d`` destinations' ``[s, ω]`` words one contiguous copy, the
       senders' copies overlapping;
    3. **land** — the copy writes straight into ``p``'s recv rows (message
       ``(q, p, dl, j)`` at slot ``q·m + s0 + j`` of context ``c0 + dl``),
       ordered behind ``p``'s queued work, and ``p``'s later work waits for
       it.

    Everything is queued without a host synchronisation.  Aliased fields
    (``send == recv``, ``send_counts == recv_counts``) are read from a copy
    on each sender's card, taken before any landing."""
    cfg = self.cfg
    lo = store.layout
    v, Pn = cfg.v, cfg.P
    ww = lo.field_words(send) // v             # ω in store words
    off_r = lo.offset(recv)
    blocks = store.blocks

    src = [(b, lo.offset(send)) for b in blocks]
    if send == recv:
        src = [(store.field_words_view(send, p).clone(), 0)
               for p in range(Pn)]
    has_counts = send_counts is not None and recv_counts is not None
    cp = [(None, 0)] * Pn
    cnt = [(None, 0)] * Pn
    fill_word = None
    if has_counts:
        cs = lo.field(send_counts).dtype
        cr = lo.field(recv_counts).dtype
        cp = [(b, lo.offset(send_counts)) for b in blocks]
        if send_counts == recv_counts:
            cp = [(store.field_words_view(send_counts, p).clone(), 0)
                  for p in range(Pn)]
        off_rc = lo.offset(recv_counts)
        # Process p's landed counts, [m (row), P (src), m (slot)] words.
        rc = [b[:, off_rc:off_rc + v].view(-1, Pn, v // Pn) for b in blocks]
    if fill is not None:
        fill_word = _fill_word(fill, lo.field(send).dtype)
        # int32 mask lengths are the counts words themselves.
        cnt = cp if cs in (torch.int32, torch.uint32) else [
            (store.field(send_counts, p).reshape(-1, v).to(torch.int32), 0)
            for p in range(Pn)]
    # Process p's recv rows, [m (row), P (src), m (slot), ω] words.
    rows = [b[:, off_r:off_r + v * ww].view(-1, Pn, v // Pn, ww)
            for b in blocks]
    for s0, s, c0, d in _chunks(cfg):
        wires = []
        for q, blk in enumerate(blocks):
            with device_scope(blk.device):
                wire = torch.empty((Pn, d, s, ww), dtype=torch.int32,
                                   device=blk.device)
                ct = None if not has_counts else torch.empty(
                    (Pn, d, s), dtype=torch.int32, device=blk.device)
                assemble_words(src[q][0], src[q][1], cfg.v_local, Pn, 1, s0,
                               s, c0, d, ww, wire, cnt[q][0], cnt[q][1],
                               fill_word, cp[q][0], cp[q][1], ct)
                if has_counts and cs != cr:
                    ct = _to_words(_from_words(ct, cs).to(cr))
            wires.append((wire, ct))

        self.mesh.all_to_all(
            [w for w, _ in wires],
            [[rows[p][c0:c0 + d, q, s0:s0 + s] for q in range(Pn)]
             for p in range(Pn)])
        if has_counts:
            self.mesh.all_to_all(
                [ct for _, ct in wires],
                [[rc[p][c0:c0 + d, q, s0:s0 + s] for q in range(Pn)]
                 for p in range(Pn)])
    return store


def _global_transpose(self, M: torch.Tensor) -> torch.Tensor:
    """``[v(src), v(dst), w] → [v(dst), v(src), w]``; at ``P > 1`` through
    the mesh's exchange, α-chunked over the destination contexts
    (Alg 7.1.3), as the JAX package's dense route ships it."""
    cfg = self.cfg
    if cfg.P == 1:
        return M.transpose(0, 1).contiguous()
    Pn, m = cfg.P, cfg.v_local
    alpha = m if cfg.alpha is None else cfg.alpha
    w = M.shape[-1]
    # x: (src proc, src local, dst proc, dst local, w);
    # y: (dst proc, dst local, src proc, src local, w).
    x = M.reshape(Pn, m, Pn, m, w)
    y = torch.empty_like(x)
    for c0 in range(0, m, alpha):
        c1 = min(c0 + alpha, m)
        self.mesh.all_to_all(x[:, :, :, c0:c1].permute(0, 2, 1, 3, 4),
                             y[:, c0:c1].permute(0, 2, 3, 1, 4))
    return y.reshape(cfg.v, cfg.v, w)


def _global_transpose_cards(self, M: list) -> list:
    """:func:`_global_transpose` over a mesh of cards: ``M[q]`` is ``[v/P
    (src), v (dst), w]`` on card ``q``; returns ``[v/P (dst), v (src), w]``
    on each card ``p``, shipped through :meth:`~.mesh.Mesh.all_to_all`'s
    per-card blocks, α-chunked over the destination contexts."""
    cfg = self.cfg
    Pn, m = cfg.P, cfg.v_local
    alpha = m if cfg.alpha is None else cfg.alpha
    w = M[0].shape[-1]
    # x[q]: (src local, dst proc, dst local, w);
    # y[p]: (dst local, src proc, src local, w).
    x = [Mq.reshape(m, Pn, m, w) for Mq in M]
    y = [torch.empty((m, Pn, m, w), dtype=Mq.dtype, device=Mq.device)
         for Mq in M]
    for c0 in range(0, m, alpha):
        c1 = min(c0 + alpha, m)
        self.mesh.all_to_all(
            [[xq[:, p, c0:c1].transpose(0, 1) for p in range(Pn)]
             for xq in x],
            [[yp[c0:c1, q] for q in range(Pn)] for yp in y])
    return [yp.reshape(m, cfg.v, w) for yp in y]


def _alltoallv_dense_cards(self, store, send, recv, send_counts, recv_counts,
                           mode, fill):
    """:func:`_alltoallv_dense` over a mesh of cards, block by block: the
    transposes ship through :func:`_global_transpose_cards`, and each
    receiver masks and writes its own block on its card."""
    cfg = self.cfg
    f = store.layout.field(send)
    Pn, m, v = cfg.P, cfg.v_local, cfg.v
    M = [store.field(send, p).reshape(m, v, -1) for p in range(Pn)]
    if mode == "indirect":
        M = [x.clone() for x in M]
    Mt = _global_transpose_cards(self, M)      # [m, v, ω] axes (dst, src)
    Ct = None
    if send_counts is not None and recv_counts is not None:
        C = [store.field(send_counts, p).reshape(m, v, 1) for p in range(Pn)]
        if mode == "indirect":
            C = [c.clone() for c in C]
        Ct = _global_transpose_cards(self, C)
    out, cts = [], []
    for p, mt in enumerate(Mt):
        with device_scope(mt.device):
            if fill is not None:
                lane = torch.arange(mt.shape[2], device=mt.device)
                mt = torch.where(lane < Ct[p].to(torch.int32), mt,
                                 torch.tensor(fill, device=mt.device).to(
                                     mt.dtype))
            out.append(mt.reshape((m,) + f.shape))
            if Ct is not None:
                cts.append(Ct[p].reshape(m, v).to(
                    store.layout.field(recv_counts).dtype))
    store = store.with_field(recv, out)
    if Ct is not None:
        store = store.with_field(recv_counts, cts)
    return store


def _alltoallv_dense(self, store, send, recv, send_counts, recv_counts,
                     mode, fill):
    """Dense-transpose data path: the PEMS1 indirect baseline and the
    ``use_kernel=False`` reference."""
    cfg = self.cfg
    f = store.layout.field(send)

    M = store.field(send).reshape(cfg.v, cfg.v, -1)
    if mode == "indirect":
        # PEMS1: stage every message in the indirect area first.
        M = M.clone()
    Mt = _global_transpose(self, M)            # [v, v, ω] axes (dst, src)
    Ct = None
    if send_counts is not None and recv_counts is not None:
        C = store.field(send_counts).reshape(cfg.v, cfg.v, 1)
        if mode == "indirect":
            C = C.clone()
        Ct = _global_transpose(self, C)
    if fill is not None:
        lane = torch.arange(Mt.shape[2], device=Mt.device)
        Mt = torch.where(lane < Ct.to(torch.int32),
                         Mt, torch.tensor(fill, device=Mt.device).to(Mt.dtype))
    store = store.with_field(recv, Mt.reshape((cfg.v,) + f.shape))
    if Ct is not None:
        store = store.with_field(
            recv_counts, Ct.reshape(cfg.v, cfg.v).to(
                store.layout.field(recv_counts).dtype))
    return store


def _alltoallv_host(self, store, send, recv, send_counts, recv_counts, fill,
                    procs=None):
    """Backing-tier Alltoallv: host-side data movement over the backing —
    messages move straight between context rows of the host or disk
    population, copies only, bit-identical to the device paths.

    The staging is chunked per destination process, then by α (Alg 7.1.3
    applied host-side): each chunk stages ``[αd, v, ω]`` — every source's
    messages for αd of process p's destination contexts — masks it in
    place, and writes it straight into those destinations' recv word
    ranges, which live entirely in shard p.  Sources are read from every
    shard (and billed to each source shard's ledger); each chunk writes one
    destination shard only, so a ``procs`` subset touches no other shard.
    ``device_cap_bytes`` bounds the staging buffer per process: αd is
    clamped so the chunk fits.  An in-place shuffle (``send == recv``)
    snapshots the whole field first — a chunked in-place transpose would
    read rows it has already overwritten — and raises when snapshot + chunk
    cannot fit the cap."""
    cfg = self.cfg
    v, m = cfg.v, cfg.v_local
    lo = store.layout
    bk = store.backing
    # Array-addressable backings (host/memmap) stage straight from a view;
    # the engine-backed file tier and the sharded backing read their chunks
    # through the block API.
    arr = getattr(bk, "arr", None)
    disk = store.on_disk
    ww = lo.field_words(send) // v                 # ω in store words
    off_s, off_r = lo.offset(send), lo.offset(recv)
    procs = list(range(cfg.P)) if procs is None else list(procs)

    Ct = None
    if send_counts is not None and recv_counts is not None:
        Ct = store.field(send_counts).reshape(v, v).T.numpy().copy()
    fill_word = None
    if fill is not None:
        fill_word = np.asarray(fill, np_dtype(lo.field(send).dtype)).view(
            np.uint32)

    alpha = m if cfg.alpha is None else cfg.alpha
    # The file tier's read_block returns a *copy* the size of the staging
    # buffer, so a chunk there holds 2x its column bytes resident (copy +
    # blk); host/memmap chunks and the in-place path slice views.
    chunk_copies = 1 if (arr is not None or send == recv) else 2
    if cfg.device_cap_bytes is not None:
        per_dst = chunk_copies * v * ww * WORD     # one destination column
        if per_dst > cfg.device_cap_bytes:
            raise ValueError(
                f"alltoallv staging needs {per_dst:,} bytes per destination "
                f"([v, ω] = [{v}, {ww * WORD}B] x{chunk_copies}) but "
                f"device_cap_bytes={cfg.device_cap_bytes:,}; raise the cap "
                "or shrink ω"
            )
        alpha = min(alpha, cfg.device_cap_bytes // per_dst)
    full = None
    if send == recv:
        full_bytes = v * v * ww * WORD
        if (cfg.device_cap_bytes is not None
                and full_bytes + alpha * v * ww * WORD
                > cfg.device_cap_bytes):
            raise ValueError(
                f"in-place tiered alltoallv (send == recv) must snapshot "
                f"the whole field ({full_bytes:,} B) on top of the "
                f"{alpha * v * ww * WORD:,} B chunk, exceeding "
                f"device_cap_bytes={cfg.device_cap_bytes:,}; use distinct "
                "send/recv fields or raise the cap"
            )
        full = bk.read_block(0, v, cols=slice(off_s, off_s + v * ww))
        if disk:
            self._account_disk(0, v, v * ww * WORD, write=False)

    for p in procs:
        # One span per destination process's network phase, one per α-chunk
        # inside it (Alg 7.1.3 made visible): the trace shows which chunk of
        # which shard's delivery the run spent its time in.
        with self.tracer.span(f"alltoallv.p{p}", tid="collective",
                              cat="collective", alpha=alpha):
            _alltoallv_proc_chunks(
                self, p, m, v, ww, alpha, arr, full, disk, off_s, off_r,
                fill_word, Ct, bk, self.shard_stats[p], chunk_copies)
    if Ct is not None:
        ct = torch.from_numpy(Ct).to(lo.field(recv_counts).dtype)
        for p in procs:
            store.with_field_rows(recv_counts, p * m, ct[p * m:(p + 1) * m])
    return store


def _alltoallv_proc_chunks(self, p, m, v, ww, alpha, arr, full, disk,
                           off_s, off_r, fill_word, Ct, bk, stats,
                           chunk_copies):
    """The α-chunk loop of :func:`_alltoallv_host` for one destination
    process ``p``, each chunk under its own trace span."""
    for c0 in range(p * m, (p + 1) * m, alpha):
        with self.tracer.span("chunk", tid="collective", cat="collective",
                              dst=p, c0=c0):
            c1 = min(c0 + alpha, (p + 1) * m)
            if full is not None:
                cols = full[:, c0 * ww:c1 * ww]
            elif arr is not None:
                cols = arr[:, off_s + c0 * ww:off_s + c1 * ww]
            else:
                cols = bk.read_block(
                    0, v, cols=slice(off_s + c0 * ww, off_s + c1 * ww))
            blk = np.empty((c1 - c0, v, ww), np.uint32)  # staging buffer
            blk[...] = np.swapaxes(cols.reshape(v, c1 - c0, ww), 0, 1)
            if disk and full is None:
                # The chunk reads (c1-c0)·ω columns of every source row —
                # split across the source shards' ledgers.
                self._account_disk(0, v, (c1 - c0) * ww * WORD, write=False)
            stats.peak_stage_bytes = max(
                stats.peak_stage_bytes,
                chunk_copies * blk.nbytes
                + (full.nbytes if full is not None else 0),
            )
            if fill_word is not None:
                # Lanes at or past each message's count arrive as the fill:
                # a slice fill a message (the JAX package's broadcast mask,
                # without its [αd, v, ω] boolean temporary).
                cnt = np.clip(Ct[c0:c1].astype(np.int64), 0, ww)
                for d in range(c1 - c0):
                    for src in range(v):
                        blk[d, src, cnt[d, src]:] = fill_word
            bk.write_block(c0, c1, blk.reshape(c1 - c0, v * ww),
                           cols=slice(off_r, off_r + v * ww))
            if disk:
                # The writes land entirely in destination shard p.
                self._account_disk(c0, c1, v * ww * WORD, write=True)


def _ledger_alltoallv(self, omega_b: int, mode: str) -> None:
    cfg = self.cfg
    B = cfg.block_bytes
    v, k, Pn = cfg.v, cfg.k, cfg.P
    m = cfg.v_local
    mu = self.layout.live_bytes
    led = self.ledger

    if mode == "direct":
        # Alg 7.1.1 / 7.1.2 event counts (Lemma 7.1.3).
        delta = (m * m + m * k) // 2           # ID-ordered rounds, per proc
        led.add_swap_out(v * max(mu - v * omega_b, 0), B)
        led.add_msg_direct(Pn * delta * omega_b, B)
        led.add_msg_indirect(Pn * 2 * (m * m - delta) * omega_b, B)
        if Pn > 1:
            led.add_network(v * (v - m) * omega_b)
            led.add_msg_direct(v * (v - m) * omega_b, B)
            # Network launches: one bulk exchange when unchunked, else one
            # per (source round of k, destination α-chunk) — Alg 7.1.3,
            # analysis.pems2_alltoallv_par_network_rounds.
            if cfg.alpha is None:
                led.add_network_rounds(1)
            else:
                led.add_network_rounds((m // k) * -(-m // cfg.alpha))
        led.add_boundary(2 * v * v * B, B)
        led.add_barrier(3)
    else:
        # Alg 2.2.1 event counts (Lemma 2.2.1: 4vμ + 2v²ω).
        led.add_msg_indirect(v * v * omega_b, B)      # write to indirect area
        led.add_swap_out(v * mu, B)
        led.add_swap_in(v * mu, B)
        led.add_msg_indirect(v * v * omega_b, B)      # read back for delivery
        led.add_swap_out(v * mu, B)
        led.add_swap_in(v * mu, B)
        if Pn > 1:
            # §2.3.3 indirect routing: each remote message crosses twice.
            led.add_network(2 * v * (v - m) * omega_b)
        led.require_disk(v * mu // Pn + v * v * omega_b)
        led.add_barrier(2)


# --------------------------------------------------------------------------- #
# Rooted collectives (§7.2–7.3)                                                #
# --------------------------------------------------------------------------- #

def bcast(self, store: ContextStore, field: str, root: int = 0,
          procs=None) -> ContextStore:
    """EM-Bcast (Alg 7.2.1): root's field value lands in every context
    (in place).

    On a tiered store ``procs`` restricts the write side to the listed
    processes' shards (the root row is read wherever it lives)."""
    cfg = self.cfg
    tiered = isinstance(store, TieredStore)
    if procs is not None and not tiered:
        raise ValueError("procs= requires a backing-tier store")
    if tiered:
        # Read only the root context's field range off the backing store.
        m = cfg.v_local
        off = store.layout.offset(field)
        nw = store.layout.field_words(field)
        row = store.backing.read_block(root, root + 1,
                                       cols=slice(off, off + nw))
        if store.on_disk:
            self._account_disk(root, root + 1, row.nbytes, write=False)
        for p in (range(cfg.P) if procs is None else procs):
            store.backing.write_block(p * m, (p + 1) * m, row,  # every row
                                      cols=slice(off, off + nw))
            if store.on_disk:
                self._account_disk(p * m, (p + 1) * m, row.nbytes,
                                   write=True)
    elif isinstance(store, MeshStore):
        m = cfg.v_local
        row = store.field(field, root // m)[root % m].clone()
        for p in range(cfg.P):
            vals = store.field(field, p)       # [v/P, ...] on card p
            vals.copy_(row.to(vals.device).expand_as(vals))
    else:
        vals = store.field(field)              # [v, ...]
        vals.copy_(vals[root].clone().expand_as(vals))

    B = cfg.block_bytes
    mu = self.layout.live_bytes
    omega_b = self.layout.field_bytes(field)
    # Lemma 7.2.1: root-partition sharers swap out and back in; every VP
    # delivers ω to its context.
    self.ledger.add_swap_out(cfg.v * mu // (cfg.P * cfg.k), B)
    self.ledger.add_swap_in(cfg.v * mu // (cfg.P * cfg.k), B)
    self.ledger.add_msg_direct(cfg.v * omega_b, B)
    if cfg.P > 1:
        self.ledger.add_network((cfg.P - 1) * omega_b)
    self.ledger.add_barrier()
    return store


def gather(self, store: ContextStore, send: str, recv: str, root: int = 0,
           procs=None) -> ContextStore:
    """EM-Gather (Alg 7.3.1): every VP's ``send`` ([ω]) lands in the root's
    ``recv`` ([v, ω]), in place.  Non-root recv fields are left untouched.

    On a tiered store ``procs`` restricts the write side: the root row is
    only written when its shard (``root // (v/P)``) is listed."""
    cfg = self.cfg
    fs = store.layout.field(send)
    fr = store.layout.field(recv)
    if fr.shape != (cfg.v,) + fs.shape:
        raise ValueError(f"recv must be [v, *send.shape]; got {fr.shape}")
    tiered = isinstance(store, TieredStore)
    if procs is not None and not tiered:
        raise ValueError("procs= requires a backing-tier store")
    if tiered:
        A = store.field(send)                  # CPU copy [v, ...]
        w = A.to(fr.dtype).reshape(-1).view(torch.int32).numpy().view(
            np.uint32)
        off = store.layout.offset(recv)
        # Only the root context's recv range is touched on the backing.
        if procs is None or root // cfg.v_local in procs:
            store.backing.write_block(root, root + 1, w[None],
                                      cols=slice(off, off + w.size))
            if store.on_disk:
                self._account_disk(root, root + 1, w.nbytes, write=True)
    elif isinstance(store, MeshStore):
        m = cfg.v_local
        R = store.field(recv, root // m)[root % m]   # [v, ...] root's card
        for p in range(cfg.P):
            R[p * m:(p + 1) * m] = store.field(send, p).to(fr.dtype).to(
                R.device)
    else:
        A = store.field(send).to(fr.dtype)     # [v, ...] gathered result
        store.field(recv)[root] = A

    B = cfg.block_bytes
    omega_b = self.layout.field_bytes(send)
    # Lemma 7.3.1 (exact form): the root may swap out (μ) and the gathered
    # v·ω result is written to its context on disk.
    self.ledger.add_swap_out(self.layout.live_bytes, B)
    self.ledger.add_msg_direct(cfg.v * omega_b, B)
    if cfg.P > 1:
        self.ledger.add_network((cfg.v - cfg.v_local) * omega_b)
    self.ledger.add_barrier()
    return store


def allgather(self, store: ContextStore, send: str, recv: str,
              procs=None) -> ContextStore:
    """Every VP receives every VP's ``send`` into ``recv`` ([v, ω]), in
    place.

    On a tiered store ``procs`` restricts the write side to the listed
    processes' shards (sources are read from every shard)."""
    cfg = self.cfg
    tiered = isinstance(store, TieredStore)
    if procs is not None and not tiered:
        raise ValueError("procs= requires a backing-tier store")
    if tiered:
        # Stage only the gathered [v, ω] row (every receiver gets the same
        # bytes) and write it per destination shard — never the dense
        # [v, v·ω] broadcast the tier cannot afford.
        m = cfg.v_local
        w = _field_words(store.field(send), store.layout.field(recv))
        off = store.layout.offset(recv)
        for p in (range(cfg.P) if procs is None else procs):
            store.backing.write_block(p * m, (p + 1) * m, w[None],
                                      cols=slice(off, off + w.size))
            if store.on_disk:
                self._account_disk(p * m, (p + 1) * m, w.nbytes, write=True)
            st = self.shard_stats[p]
            st.peak_stage_bytes = max(st.peak_stage_bytes, w.nbytes)
    elif isinstance(store, MeshStore):
        for p in range(cfg.P):
            R = store.field(recv, p)           # [v/P, v, ...] on card p
            A = torch.cat([store.field(send, q).to(R.dtype).to(R.device)
                           for q in range(cfg.P)])
            R.copy_(A[None].expand_as(R))
    else:
        A = store.field(send)                  # [v, ...]
        R = store.field(recv)                  # [v, v, ...]
        R.copy_(A.to(R.dtype)[None].expand_as(R))
    # An allgather is an Alltoallv with equal messages — same ledger shape.
    _ledger_alltoallv(self, self.layout.field_bytes(send), "direct")
    return store


def reduce(self, store: ContextStore, field: str, out_field: str,
           op: str = "add", root: int = 0, procs=None) -> ContextStore:
    """EM-Reduce (Alg 7.4.1): vectorised reduction of each VP's ``field``
    ([n]) into the root's ``out_field`` ([n]), in place.  ``op`` is
    ``add`` (wrapping for the integer types), ``max`` or ``min``.

    On a tiered store ``procs`` gates the root write like :func:`gather`.
    Raises ``ValueError`` for any other ``op``."""
    if procs is not None and not isinstance(store, TieredStore):
        raise ValueError("procs= requires a backing-tier store")
    if isinstance(store, TieredStore):
        red = _tiered_reduce(self, store, field, op)
        w = _field_words(red, store.layout.field(out_field))
        off = store.layout.offset(out_field)
        if procs is None or root // self.cfg.v_local in procs:
            store.backing.write_block(root, root + 1, w[None],
                                      cols=slice(off, off + w.size))
            if store.on_disk:
                self._account_disk(root, root + 1, w.nbytes, write=True)
    elif isinstance(store, MeshStore):
        m = self.cfg.v_local
        R = store.field(out_field, root // m)
        red = _cards_reduce(store, field, op, R.device)
        R[root % m] = red.to(R.dtype).reshape(R.shape[1:])
    else:
        red = _reduce_op(op)(store.field(field))
        R = store.field(out_field)
        R[root] = red.to(R.dtype).reshape(R.shape[1:])
    _ledger_reduce(self, self.layout.field_bytes(out_field))
    return store


def allreduce(self, store: ContextStore, field: str, out_field: str,
              op: str = "add", procs=None) -> ContextStore:
    """:func:`reduce`, then the result lands in every VP's ``out_field``
    (in place).  On a tiered store ``procs`` restricts the write side to
    the listed processes' shards."""
    if procs is not None and not isinstance(store, TieredStore):
        raise ValueError("procs= requires a backing-tier store")
    if isinstance(store, TieredStore):
        m = self.cfg.v_local
        red = _tiered_reduce(self, store, field, op)
        out = red[None].expand((m,) + red.shape)
        for p in (range(self.cfg.P) if procs is None else procs):
            store.with_field_rows(out_field, p * m, out)
    elif isinstance(store, MeshStore):
        red = _cards_reduce(store, field, op, store.device)
        for p in range(self.cfg.P):
            R = store.field(out_field, p)
            R.copy_(red.to(R.dtype).reshape(R.shape[1:]).to(R.device)[
                None].expand_as(R))
    else:
        red = _reduce_op(op)(store.field(field))
        R = store.field(out_field)
        R.copy_(red.to(R.dtype).reshape(R.shape[1:])[None].expand_as(R))
    _ledger_reduce(self, self.layout.field_bytes(out_field))
    # The rebroadcast delivers n·ω to every context.
    self.ledger.add_msg_direct(
        (self.cfg.v - 1) * self.layout.field_bytes(out_field),
        self.cfg.block_bytes,
    )
    return store


def _tiered_reduce(self, store, field: str, op: str) -> torch.Tensor:
    """Reduce a backing-tier field.  The reduction itself runs on the
    executor's device (the device tier's torch op, on a contiguous ``[v,
    n]`` operand as there) so the result is bit-identical to the device
    tier even for float32 fields; the field matrix is assumed to fit the
    device budget (reduce operands are collective-sized, not data-sized).
    Returns a CPU tensor."""
    vals = store.field(field)
    red = _reduce_op(op)(vals.to(self.device)).cpu()
    self.ledger.add_tier_in(vals.numel() * vals.element_size(), disk=False)
    self.ledger.add_tier_out(red.numel() * red.element_size(), disk=False)
    return red


def _cards_reduce(store, field: str, op: str, device) -> torch.Tensor:
    """Reduce a :class:`~.context.MeshStore`'s field on ``device``: the
    blocks gathered there into the contiguous ``[v, n]`` operand the
    one-device store reduces, so the float32 sums add in the same order and
    give the same bits."""
    x = torch.cat([store.field(field, p).to(device) for p in range(store.P)])
    with device_scope(device):
        return _reduce_op(op)(x)


_SIGN = -2**31   # the int32 word 0x80000000


def _reduce_op(op: str):
    """The reduction over axis 0 as ``jnp.sum``/``max``/``min`` compute it,
    in the operand's dtype: integer sums wrap at 32 bits (torch sums int32
    into int64; the cast back keeps the low word, and a uint32 sum is the
    int32 sum of its words), and uint32 max/min compare the words with the
    sign bit flipped (torch has no uint32 max on the CPU).  The operand is
    made contiguous, so a strided store view and a staged copy reduce in
    the same order."""
    def add(x):
        if x.dtype == torch.float32:
            return x.contiguous().sum(dim=0)
        w = x.contiguous().view(torch.int32)
        return w.sum(dim=0).to(torch.int32).view(x.dtype)

    def extreme(fn):
        def red(x):
            x = x.contiguous()
            if x.dtype != torch.uint32:
                return fn(x, dim=0)
            flip = x.view(torch.int32) ^ _SIGN
            return (fn(flip, dim=0) ^ _SIGN).view(torch.uint32)
        return red

    ops = {"add": add, "max": extreme(torch.amax),
           "min": extreme(torch.amin)}
    if op not in ops:
        raise ValueError(f"unsupported reduce op {op!r} (PEMS requires "
                         "commutative+associative operators, §7.4)")
    return ops[op]


def _ledger_reduce(self, n_bytes: int) -> None:
    cfg = self.cfg
    # Lemma 7.4.2: the root delivers the n-vector result to its context; the
    # network phase is a logarithmic tree (Lemma 7.4.3).
    self.ledger.add_msg_direct(n_bytes, cfg.block_bytes)
    if cfg.P > 1:
        self.ledger.add_network(n_bytes * math.ceil(math.log2(cfg.P)))
    self.ledger.add_barrier(2)
