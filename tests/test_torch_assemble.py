"""Kernel 4, the ``P > 1`` mesh staging: the port's plain version against the
JAX package's ``assemble_proc_tiles`` run in interpret mode and against both
oracles (``assemble_proc_ref``), at the edge shapes ``chip_smoke.py`` holds
the CUDA kernel to on the card.  Every path copies words, so outputs compare
bit for bit.

The CUDA kernel itself is held against the same plain version on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _jax_ref import deliver as jdeliver, jax, jnp, np_out
from repro.kernels.alltoallv_deliver.ref import assemble_proc_ref as \
    jax_assemble_ref
from repro_torch.core import make_mesh
from repro_torch.kernels import alltoallv_deliver as tdeliver
from repro_torch.kernels.alltoallv_deliver import ref as deliver_ref

INT_MIN, INT_MAX = -2**31, 2**31 - 1

_j_assemble = jax.jit(
    lambda x, c, cp, fill: jdeliver.assemble_proc_tiles(
        x, c, cp, fill=fill, interpret=True),
    static_argnames=("fill",))


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _case(s, P, d, omega, seed, dtype=np.int32):
    """A chunk with counts of 0, of ω, past ω and negative."""
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        msgs = rng.standard_normal((s, P, d, omega)).astype(np.float32)
    else:
        msgs = rng.integers(INT_MIN, INT_MAX, size=(s, P, d, omega),
                            endpoint=True, dtype=np.int64).astype(np.int32)
    counts = rng.integers(-1, omega + 2, size=(s, P, d)).astype(np.int32)
    edges = np.array([0, omega, omega + 5, -3], np.int32)
    counts.reshape(-1)[:4] = edges[:min(4, counts.size)]
    payload = rng.integers(0, 1000, size=(s, P, d)).astype(np.int32)
    return msgs, counts, payload


# [s, P, d, ω]: P of 1, 2 and 4; ω of 1, 127, 300 and past one block's
# 1024-word chunk.
_SHAPES = [(1, 1, 1, 1), (2, 2, 3, 127), (2, 4, 3, 300), (3, 4, 1, 1),
           (1, 2, 2, 1030)]


@pytest.mark.parametrize("s, P, d, omega", _SHAPES)
@pytest.mark.parametrize("fill", [None, -7, INT_MAX])
@pytest.mark.parametrize("with_payload", [False, True])
def test_assemble_proc_tiles_match_pallas_interpret(s, P, d, omega, fill,
                                                    with_payload):
    msgs, counts, payload = _case(s, P, d, omega, s * P * d + omega)
    cp = payload if with_payload else None
    want_out, want_ct = np_out(_j_assemble(
        jnp.asarray(msgs), jnp.asarray(counts),
        None if cp is None else jnp.asarray(cp), fill=fill))
    got_out, got_ct = tdeliver.assemble_proc_tiles(
        _t(msgs), _t(counts), _t(cp), fill=fill)
    _eq(got_out, want_out)
    assert (got_ct is None) == (want_ct is None)
    if want_ct is not None:
        _eq(got_ct, want_ct)
    j_out, j_ct = np_out(jax_assemble_ref(
        jnp.asarray(msgs), jnp.asarray(counts),
        None if cp is None else jnp.asarray(cp), fill=fill))
    _eq(j_out, want_out)
    for use_kernel in (True, False):
        out, ct = tdeliver.assemble_proc_fused(
            _t(msgs), _t(counts), _t(cp), fill=fill, use_kernel=use_kernel)
        _eq(out, want_out)
        if want_ct is not None:
            _eq(ct, want_ct)
    ref_out, _ = deliver_ref.assemble_proc_ref(
        _t(msgs), _t(counts), _t(cp), fill=fill)
    _eq(ref_out, want_out)


def test_assemble_float32_payload_with_float_fill_matches_jax():
    msgs, counts, payload = _case(2, 4, 3, 130, 5, np.float32)
    fcp = payload.astype(np.float32)                 # float counts payload
    want_out, want_ct = np_out(jdeliver.assemble_proc_fused(
        jnp.asarray(msgs), jnp.asarray(counts), jnp.asarray(fcp),
        fill=-1.5, interpret=True))
    for use_kernel in (True, False):
        out, ct = tdeliver.assemble_proc_fused(
            _t(msgs), _t(counts), _t(fcp), fill=-1.5, use_kernel=use_kernel)
        _eq(out, want_out)
        _eq(ct, want_ct)
    with pytest.raises(ValueError, match="fill requires counts"):
        tdeliver.assemble_proc_fused(_t(msgs), fill=-1.5)
    with pytest.raises(ValueError, match="overflows"):
        tdeliver.assemble_proc_fused(_t(msgs), _t(counts), fill=1e39)


@pytest.mark.parametrize("nq, s0, s, c0, d", [
    (4, 0, 4, 0, 4),        # unchunked: every sender's whole send range
    (4, 2, 2, 1, 1),        # an α = 1 chunk of the second source round
    (2, 1, 3, 2, 2),        # fewer senders, a ragged last chunk
])
@pytest.mark.parametrize("with_counts", [False, True])
def test_assemble_words_reads_the_store_word_ranges(nq, s0, s, c0, d,
                                                    with_counts):
    """The store form the collective passes: sender q's local source j is
    row q·m + s0 + j, its message for (p, c0 + dl) sits at
    ``src_off + (p·m + c0 + dl)·ww`` and lands at ``out[q, p, dl, j]``; the
    mask and counts words at ``cnt_off + p·m + c0 + dl``."""
    rng = np.random.default_rng(nq * 10 + s0)
    m, P, ww, src_off, cnt_off = 4, 4, 5, 7, 3
    v = m * P
    store = rng.integers(INT_MIN, INT_MAX, size=(v, src_off + v * ww + 4),
                         endpoint=True, dtype=np.int64).astype(np.int32)
    store[:, cnt_off:cnt_off + v] = rng.integers(-1, ww + 2, size=(v, v))
    want = np.empty((nq, P, d, s, ww), np.int32)
    want_ct = np.empty((nq, P, d, s), np.int32)
    for q in range(nq):
        for p in range(P):
            for dl in range(d):
                for j in range(s):
                    row, col = q * m + s0 + j, p * m + c0 + dl
                    msg = store[row, src_off + col * ww:
                                src_off + (col + 1) * ww].copy()
                    if with_counts:
                        msg[max(store[row, cnt_off + col], 0):] = -9
                    want[q, p, dl, j] = msg
                    want_ct[q, p, dl, j] = store[row, cnt_off + col]
    src = _t(store)
    out = torch.empty(want.shape, dtype=torch.int32)
    ct = torch.empty(want_ct.shape, dtype=torch.int32)
    kw = dict(counts=src, cnt_off=cnt_off, fill=-9, counts_payload=src,
              cp_off=cnt_off, ct_out=ct) if with_counts else {}
    tdeliver.assemble_words(src, src_off, m, P, nq, s0, s, c0, d, ww, out,
                            **kw)
    _eq(out, want)
    if with_counts:
        _eq(ct, want_ct)


def test_assemble_words_rejects_what_the_kernel_cannot_take():
    src = torch.zeros((8, 40), dtype=torch.int32)
    out = torch.empty(2 * 2 * 2 * 2 * 4, dtype=torch.int32)
    args = (src, 0, 4, 2, 2, 0, 2, 0, 2, 4)
    tdeliver.assemble_words(*args, out)
    with pytest.raises(ValueError, match="fill requires counts"):
        tdeliver.assemble_words(*args, out, fill=0)
    with pytest.raises(ValueError, match="go together"):
        tdeliver.assemble_words(*args, out, counts_payload=src)
    with pytest.raises(ValueError, match="passes m"):
        tdeliver.assemble_words(src, 0, 4, 2, 2, 0, 2, 3, 2, 4, out)
    with pytest.raises(ValueError, match="lacks rows"):
        tdeliver.assemble_words(src, 0, 4, 2, 3, 0, 2, 0, 2, 4,
                                torch.empty(96, dtype=torch.int32))
    with pytest.raises(ValueError, match="lacks rows"):
        tdeliver.assemble_words(src, 9, 4, 2, 2, 0, 2, 0, 2, 4, out)
    with pytest.raises(ValueError, match="out must be contiguous"):
        tdeliver.assemble_words(*args, out[:-1])
    with pytest.raises(ValueError, match="positive"):
        tdeliver.assemble_words(src, 0, 4, 2, 2, 0, 0, 0, 2, 4, out)


# The recv-rows layout of a one-card mesh: (m, P, s0, s, c0, d) chunks —
# unchunked, α = 1, and α = 3's first and ragged last chunk at P = 4; the
# unchunked and ragged α = 2 chunks at P = 2 with m = 3.
_ROW_CHUNKS = [(4, 4, 0, 4, 0, 4), (4, 4, 2, 2, 1, 1), (4, 4, 2, 2, 0, 3),
               (4, 4, 0, 2, 3, 1), (3, 2, 0, 3, 0, 3), (3, 2, 1, 2, 2, 1)]
# (send offset, recv offset, row stride) mod 4: every phase of each.
_PHASES = [(0, 0, 1), (1, 2, 2), (2, 3, 3), (3, 1, 2), (1, 1, 3), (2, 0, 1)]


def _rows_store(m, P, ww, phases, seed):
    """A ``[v, W]`` store with send words at ``off_s``, recv words at
    ``off_r``, send counts at ``off_c`` and recv counts at ``off_rc``, each
    offset and ``W`` in the given phases mod 4; the counts hold -1, 0, ω
    and ω + 2 besides random lengths."""
    ps, pr, pw = phases
    v = m * P
    off_s = 4 + ps
    off_r = off_s + v * ww + (pr - ps - v * ww) % 4 + 4
    off_c = off_r + v * ww + 1
    off_rc = off_c + v + 2
    W = off_rc + v + 3
    W += (pw - W) % 4
    rng = np.random.default_rng(seed)
    store = rng.integers(INT_MIN, INT_MAX, size=(v, W), endpoint=True,
                         dtype=np.int64).astype(np.int32)
    cnt = rng.integers(-1, ww + 3, size=(v, v)).astype(np.int32)
    cnt.reshape(-1)[rng.permutation(v * v)[:4]] = [-1, 0, ww, ww + 2]
    store[:, off_c:off_c + v] = cnt
    assert (off_s % 4, off_r % 4, W % 4) == phases
    return torch.from_numpy(store), off_s, off_r, off_c, off_rc


@pytest.mark.parametrize("m, P, s0, s, c0, d", _ROW_CHUNKS)
@pytest.mark.parametrize("phases", _PHASES)
@pytest.mark.parametrize("fill, with_payload", [(None, False), (-9, False),
                                                (-9, True), (None, True)])
def test_assemble_words_lands_in_the_recv_rows_as_the_exchange_did(
        m, P, s0, s, c0, d, phases, fill, with_payload):
    """Into a strided destination, the receivers' recv rows of the store it
    reads, the staging equals the buffer layout followed by the transpose
    copy the exchange made (``Mesh.all_to_all``), word for word."""
    ww = 5
    v = m * P
    store, off_s, off_r, off_c, off_rc = _rows_store(
        m, P, ww, phases, hash((m, s0, c0, phases)) % 2**32)
    mesh = make_mesh(P, device="cpu")

    def views(st):
        rows = st[:, off_r:off_r + v * ww].view(P, m, P, m, ww)
        rc = st[:, off_rc:off_rc + v].view(P, m, P, m)
        return (rows[:, c0:c0 + d, :, s0:s0 + s],
                rc[:, c0:c0 + d, :, s0:s0 + s])

    def kw(st, ct):
        out = {}
        if fill is not None:
            out.update(counts=st, cnt_off=off_c, fill=fill)
        if with_payload:
            out.update(counts_payload=st, cp_off=off_c, ct_out=ct)
        return out

    # Through the buffer and the exchange.
    want = store.clone()
    buf = torch.empty((P, P, d, s, ww), dtype=torch.int32)
    ctbuf = torch.empty((P, P, d, s), dtype=torch.int32)
    tdeliver.assemble_words(want, off_s, m, P, P, s0, s, c0, d, ww, buf,
                            **kw(want, ctbuf))
    rows, rc = views(want)
    mesh.all_to_all(buf, rows.permute(0, 2, 1, 3, 4))
    if with_payload:
        mesh.all_to_all(ctbuf, rc.permute(0, 2, 1, 3))
    # Straight into the recv rows.
    got = store.clone()
    rows, rc = views(got)
    tdeliver.assemble_words(got, off_s, m, P, P, s0, s, c0, d, ww,
                            rows.permute(2, 0, 1, 3, 4),
                            **kw(got, rc.permute(2, 0, 1, 3)))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not torch.equal(got, store)


def test_assemble_words_rejects_a_strided_last_axis_or_an_overlap():
    m, P, ww = 4, 2, 6
    store, off_s, off_r, off_c, off_rc = _rows_store(m, P, ww, (1, 2, 2), 3)
    v = m * P
    rows = store[:, off_r:off_r + v * ww].view(P, m, P, m, ww)
    args = (store, off_s, m, P, P, 0, 2, 1, 2, ww)
    land = rows[:, 1:3, :, 0:2].permute(2, 0, 1, 3, 4)
    tdeliver.assemble_words(*args, land)
    wide = torch.zeros((P, P, 2, 2, 2 * ww), dtype=torch.int32)
    with pytest.raises(ValueError, match="unit last stride"):
        tdeliver.assemble_words(*args, wide[..., ::2])
    # The send words of the rows the chunk reads, as the destination.
    sent = store[:, off_s:off_s + v * ww].view(P, m, P, m, ww)
    with pytest.raises(ValueError, match="out overlaps"):
        tdeliver.assemble_words(*args, sent[:, 1:3, :, 0:2].permute(
            2, 0, 1, 3, 4))
    # A run that passes the end of row 0 into row 1, which the chunk reads.
    W = store.shape[1]
    past = store.view(-1)[W - ww // 2:].as_strided(
        (P, P, 2, 2, ww), (0, 0, 0, 0, 1))
    with pytest.raises(ValueError, match="out overlaps"):
        tdeliver.assemble_words(*args, past)
    # The transposed counts over the counts words they are read from.
    rc = store[:, off_c:off_c + v].view(P, m, P, m)
    with pytest.raises(ValueError, match="ct_out overlaps"):
        tdeliver.assemble_words(*args, land, counts_payload=store,
                                cp_off=off_c,
                                ct_out=rc[:, 1:3, :, 0:2].permute(2, 0, 1, 3))
    # Send words of rows the chunk does not read may take the landing: one
    # sender reads rows 0 and 1, the messages land in rows 2, 3, 6 and 7.
    tdeliver.assemble_words(store, off_s, m, P, 1, 0, 2, 1, 2, ww,
                            sent[:, 2:4, 1:2, 0:2].permute(2, 0, 1, 3, 4))
