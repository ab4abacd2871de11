"""Kernels 1, 6 and 7 in every dtype their JAX counterparts take, against the
JAX package on the CPU (kernel 3's uint32 buckets are in
``tests/test_torch_kway_merge.py``).

Inputs are made with numpy from a seed and handed to both packages.

* **Sort** (kernel 1, ``ops.sort``): bool, int8, uint8, int16, uint16,
  int32, uint32, float16, bfloat16 and float32, bit for bit against JAX's
  default ``sort`` (``jnp.sort`` on the CPU), bits compared as integers
  (NaN != NaN).  Its order: the two zeros tie in input order, and every NaN
  ties after ``+inf`` in input order.  Against the Pallas route
  (``interpret=True``) only where that route keeps its own contract
  ("bit-identical on total orders (ints; NaN-free floats)"): integers, and
  floats without NaN, a zero of either sign, or ``+inf`` in a padded row
  (that route pads float rows with ``finfo.max``, which sorts before
  ``+inf``); bool there raises inside the JAX package (``finfo`` of bool).
  XLA's CPU sort compares float32 and bfloat16 subnormals as zero (it
  flushes them), and returns a bfloat16 NaN as the quiet NaN of its sign
  (its payload dropped), so JAX is met without those (``_keys``'s
  ``xla_cpu``); with them the port holds to ``torch.sort(stable=True)``,
  which orders subnormals by value and moves every key's own bits.
* **SSD and RG-LRU scans** (kernels 6 and 7) in bfloat16 and float16: the
  output dtype equals JAX's (``x``'s, ``a``'s), values within the JAX
  package's own tolerance for bf16 (``tests/test_kernels.py``: atol 5e-2 on
  values of order one), and for fp16 that tolerance scaled by the two
  types' epsilons (2^-10 / 2^-7: 6.25e-3).  Both sides compute in float32
  and round once, so they differ by an output ulp or two.
* **Direct delivery** (kernels 2 and 4: ``deliver_tiles``, ``deliver``,
  ``deliver_fused``, ``assemble_proc_tiles``, ``assemble_proc_fused``) on
  payloads and counts payloads of bool, int8, uint8, int16, uint16, float16
  and bfloat16, ω of 1, 3, 130 and 257, counts of 0, of ω, past ω and
  negative, fills of None, a value and the type's extremes (for floats ±inf
  and NaN too): bit for bit against the Pallas kernels in interpret mode,
  compared as integer bits, each output in its input's dtype.  XLA's CPU
  moves a bfloat16 NaN as the quiet NaN of its sign and flushes bfloat16
  subnormals to zero in these kernels too (as their fused operations
  have it), so JAX is met without those (``_keys``'s ``xla_cpu``); with
  them the port moves every element's own bits, held against the
  transposition of the bits in numpy.  8-byte payloads raise
  ``TypeError`` naming the dtype.
* **Gradients** through ``_SsdScan`` and ``_LruScan`` in narrow dtypes
  against autograd of the plain version: each gradient in its operand's
  dtype, within ``k·eps·|w| + 1e-4·max|w|`` (eps the dtype's, k = 1 for
  SSD: one rounding of float32 values that differ by their sums' order; k =
  2 for the LRU scan, whose backward reads the forward's ``h`` as stored,
  rounded once more).
"""

from __future__ import annotations

import ml_dtypes
import numpy as np
import pytest
import torch

from _jax_ref import bitonic_ops, deliver as jdeliver, jax, jnp, np_out
from repro.kernels.lru_scan.ops import lru_scan as j_lru
from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd
from repro_torch.kernels import alltoallv_deliver as tdeliver
from repro_torch.kernels.bitonic_sort import bitonic_sort, bitonic_sort_rows
from repro_torch.kernels.bitonic_sort.bitonic_sort import (key_width,
                                                          radix_key,
                                                          radix_sort_plain)
from repro_torch.kernels.lru_scan import (lru_chunked_plain, lru_scan,
                                          lru_scan_chunked)
from repro_torch.kernels.ssd_scan import (ssd_chunked_plain, ssd_scan,
                                          ssd_scan_chunked)

# torch dtype → (numpy dtype, the signed integer view of its width).
DTYPES = {
    torch.bool: (np.bool_, np.uint8),
    torch.int8: (np.int8, np.int8),
    torch.uint8: (np.uint8, np.int8),
    torch.int16: (np.int16, np.int16),
    torch.uint16: (np.uint16, np.int16),
    torch.int32: (np.int32, np.int32),
    torch.uint32: (np.uint32, np.int32),
    torch.float16: (np.float16, np.int16),
    torch.bfloat16: (ml_dtypes.bfloat16, np.int16),
    torch.float32: (np.float32, np.int32),
}
FLOATS = [torch.float16, torch.bfloat16, torch.float32]
INTS = [d for d in DTYPES if d not in FLOATS]
NARROW = [torch.bfloat16, torch.float16]
# JAX's bf16 tolerance (tests/test_kernels.py), and fp16's by the epsilons.
SCAN_TOL = {torch.bfloat16: 5e-2, torch.float16: 5e-2 * 2**-3}
EPS = {torch.bfloat16: 2**-7, torch.float16: 2**-10}

_j_sort = jax.jit(bitonic_ops.sort, static_argnames=("interpret",
                                                     "use_kernel"))
_j_ssd = jax.jit(j_ssd, static_argnames=("chunk", "interpret"))
_j_lru = jax.jit(j_lru, static_argnames=("chunk", "interpret"))


def _name(d):
    return str(d).replace("torch.", "")


def _to_torch(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """numpy keys (``DTYPES[dtype][0]``) as a torch tensor of ``dtype``,
    through their bits (torch has no numpy bfloat16)."""
    npd, view = DTYPES[dtype]
    bits = torch.from_numpy(np.ascontiguousarray(x).view(view))
    return bits.view(dtype) if dtype != torch.bool else bits.bool()


def _bits(x) -> np.ndarray:
    """The keys' bits as signed integers of their width (NaN compares)."""
    if isinstance(x, torch.Tensor):
        view = DTYPES[x.dtype][1]
        if x.dtype == torch.bool:
            return x.numpy().view(view)
        return x.view({1: torch.int8, 2: torch.int16,
                       4: torch.int32}[x.element_size()]).numpy().view(view)
    x = np.asarray(x)
    return x.view({1: np.uint8 if x.dtype == np.bool_ else np.int8,
                   2: np.int16, 4: np.int32}[x.dtype.itemsize])


def _keys(dtype, shape, kind, seed, xla_cpu=False):
    """numpy keys of ``dtype``: uniform random bits, or the type's special
    values (extremes; for floats ±0, NaNs of both signs and several
    payloads, ±inf, subnormals, the largest and smallest normals) mixed
    with a few ordinary ones, or one value repeated.  ``xla_cpu``: none of
    what XLA's CPU sort changes (float32 and bfloat16 subnormals; bfloat16
    NaN payloads, the quiet NaN of each sign kept)."""
    rng = np.random.default_rng(seed)
    npd, view = DTYPES[dtype]
    n = int(np.prod(shape))
    if dtype == torch.bool:
        return rng.integers(0, 2, size=shape).astype(np.bool_)
    width = np.dtype(view).itemsize
    if kind == "equal":
        pool = np.array([3], dtype=npd)
    elif kind == "random":
        if dtype in FLOATS:             # random finite values, no NaN
            return (rng.standard_normal(shape) * 8).astype(npd)
        raw = rng.integers(0, 1 << (8 * width), size=shape, dtype=np.uint64)
        return raw.astype({1: np.uint8, 2: np.uint16,
                           4: np.uint32}[width]).view(npd)
    elif dtype in FLOATS:
        fi = (ml_dtypes.finfo(npd) if dtype == torch.bfloat16
              else np.finfo(npd))
        sign = 1 << (8 * width - 1)
        exp_all = {torch.float32: 0x7F800000, torch.float16: 0x7C00,
                   torch.bfloat16: 0x7F80}[dtype]
        utype = {2: np.uint16, 4: np.uint32}[width]
        quiet = exp_all | (exp_all >> 1) & ~exp_all
        nans = [quiet, sign | quiet]
        if not (xla_cpu and dtype == torch.bfloat16):
            nans += [exp_all | 1, sign | exp_all | 3, sign | exp_all | 1]
        nans = np.array(nans, dtype=np.uint64).astype(utype).view(npd)
        subnormals = not (xla_cpu and dtype != torch.float16)
        pool = np.concatenate([
            np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 0.5,
                      float(fi.max), -float(fi.max),
                      float(fi.tiny), -float(fi.tiny)], dtype=npd),
            nans,
            np.array([1, sign | 1, 3] if subnormals else [],
                     dtype=np.uint64).astype(utype).view(npd)])
    else:
        ii = np.iinfo(npd)
        pool = np.array([ii.min, ii.min + 1, 0, 1, ii.max - 1, ii.max,
                         ii.max // 2], dtype=npd)
    return pool[rng.integers(0, len(pool), size=n)].reshape(shape)


def _jax_sort(x: np.ndarray, **kw) -> np.ndarray:
    return np_out(_j_sort(jnp.asarray(x), **kw))


# (shape, kind): a row of one key, ragged 1-D and 2-D rows (padded by
# ops.sort), a power of two (no pad), and one value repeated.
SORT_CASES = [((1,), "special"), ((37,), "random"), ((37,), "special"),
              ((3, 100), "random"), ((3, 100), "special"),
              ((2, 64), "special"), ((2, 256), "equal")]


@pytest.mark.parametrize("shape, kind", SORT_CASES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=_name)
def test_sort_matches_jnp_sort_bit_for_bit(dtype, shape, kind):
    x = _keys(dtype, shape, kind, 16 * SORT_CASES.index((shape, kind))
              + list(DTYPES).index(dtype), xla_cpu=True)
    want = _bits(_jax_sort(x))
    t = _to_torch(x, dtype)
    for use_kernel in (True, False):
        got = bitonic_sort(t, use_kernel=use_kernel)
        assert got.dtype == dtype and got.shape == t.shape
        np.testing.assert_array_equal(_bits(got), want)
    if len(shape) == 2 and shape[1] & (shape[1] - 1) == 0:
        np.testing.assert_array_equal(_bits(bitonic_sort_rows(t)), want)
        np.testing.assert_array_equal(_bits(radix_sort_plain(t)), want)


@pytest.mark.parametrize("shape", [(37,), (3, 100), (2, 64)], ids=str)
@pytest.mark.parametrize("dtype", FLOATS, ids=_name)
def test_sort_keeps_subnormals_and_nan_payloads_as_torch_sort(dtype, shape):
    """Floats with subnormals and NaN payloads among the special values:
    the port's every route gives ``torch.sort(stable=True)``'s bits."""
    t = _to_torch(_keys(dtype, shape, "special", 11 + len(shape)), dtype)
    want = _bits(torch.sort(t, dim=-1, stable=True).values)
    for use_kernel in (True, False):
        np.testing.assert_array_equal(
            _bits(bitonic_sort(t, use_kernel=use_kernel)), want)
    if len(shape) == 2 and shape[1] & (shape[1] - 1) == 0:
        np.testing.assert_array_equal(_bits(bitonic_sort_rows(t)), want)


@pytest.mark.parametrize("shape", [(1, 1), (37,), (3, 100), (2, 64)],
                         ids=str)
@pytest.mark.parametrize("dtype", [d for d in DTYPES if d != torch.bool],
                         ids=_name)
def test_sort_matches_the_pallas_route_where_it_keeps_its_contract(dtype,
                                                                   shape):
    """Integers of every kind, special values included; floats random and
    finite, no zero and no NaN: the Pallas network (interpret mode) is a
    sort there, and both routes give the same bits."""
    kind = "random" if dtype in FLOATS else "special"
    x = _keys(dtype, shape, kind, 7 + len(shape))
    if dtype in FLOATS:
        x = np.where(x == 0, np.ones_like(x), x)
    want = _bits(_jax_sort(x, interpret=True))
    np.testing.assert_array_equal(want, _bits(_jax_sort(x)))
    np.testing.assert_array_equal(_bits(bitonic_sort(_to_torch(x, dtype))),
                                  want)


@pytest.mark.parametrize("dtype", FLOATS, ids=_name)
def test_sort_orders_signed_zeros_and_nans_as_jnp_sort(dtype):
    """±0 tie and keep their input order; every NaN, either sign, ties
    after -inf .. +inf in input order (the repair of float keys' order)."""
    npd = DTYPES[dtype][0]
    x = np.array([0, -0.0, np.nan, -np.nan, 1, -0.0, 0, -np.inf], npd)
    want = _jax_sort(x)
    np.testing.assert_array_equal(
        _bits(want), _bits(np.array([-np.inf, 0, -0.0, -0.0, 0, 1, np.nan,
                                     -np.nan], npd)))
    for t in (_to_torch(x, dtype), _to_torch(np.tile(x, (3, 1)), dtype)):
        got = bitonic_sort(t)
        np.testing.assert_array_equal(_bits(got),
                                      _bits(_jax_sort(_to_numpy(t))))
    np.testing.assert_array_equal(
        _bits(torch.sort(_to_torch(x, dtype), stable=True).values),
        _bits(want))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    npd, view = DTYPES[t.dtype]
    return _bits(t).view(npd)


@pytest.mark.parametrize("dtype", FLOATS, ids=_name)
def test_sort_keeps_inf_in_a_padded_row(dtype):
    """A row padded to a power of two keeps its +inf (and its NaNs after
    it): the pad sorts after every real key (the repair of the padding)."""
    npd = DTYPES[dtype][0]
    for x in (np.array([np.inf, 1, 2], npd),
              np.array([np.nan, np.inf, 3, -np.inf, 5], npd)):
        want = _jax_sort(x)
        got = bitonic_sort(_to_torch(x, dtype))
        np.testing.assert_array_equal(_bits(got), _bits(want))
        assert np.isposinf(np.asarray(want, np.float32)).sum() == 1


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64, torch.uint64],
                         ids=_name)
def test_sort_raises_on_8_byte_keys(dtype):
    x = torch.zeros((2, 8), dtype=dtype)
    for fn in (bitonic_sort, bitonic_sort_rows, radix_sort_plain):
        with pytest.raises(TypeError, match="8-byte keys"):
            fn(x)


@pytest.mark.parametrize("dtype", list(DTYPES), ids=_name)
def test_radix_key_orders_every_dtype_as_the_stable_sort(dtype):
    """The image's stable order is ``torch.sort(stable=True)``'s, and it
    fits the key's width: one digit pass a byte."""
    x = _to_torch(_keys(dtype, (300,), "special", 3), dtype)
    key = radix_key(x)
    assert int(key.min()) >= 0 and int(key.max()) < 1 << 8 * key_width(dtype)
    order = torch.argsort(key, stable=True)
    want = torch.sort(x, stable=True).values
    np.testing.assert_array_equal(_bits(x[order]), _bits(want))


# --------------------------------------------------------------------------- #
# The scans in narrow dtypes                                                  #
# --------------------------------------------------------------------------- #

def _ssd_inputs(seed, b, h, s, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, s, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, h, s)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    Bm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    Cm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _narrow(xs, dtype):
    """float32 numpy arrays rounded to ``dtype``: (torch tensors, the same
    values as JAX arrays of that dtype)."""
    ts = [torch.from_numpy(x).to(dtype) for x in xs]
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    return ts, [jnp.asarray(t.float().numpy(), jd) for t in ts]


def _assert_close(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("b, h, s, p, n", [(1, 1, 1, 16, 16),
                                           (2, 3, 37, 16, 16),
                                           (1, 2, 70, 64, 128)], ids=str)
@pytest.mark.parametrize("dtype", NARROW, ids=_name)
def test_ssd_scan_narrow_dtypes_match_jax(dtype, b, h, s, p, n):
    (x, dt, A, Bm, Cm), js = _narrow(_ssd_inputs(s, b, h, s, p, n), dtype)
    want = np_out(_j_ssd(*js, chunk=32, interpret=True))
    got = ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    assert got.dtype == dtype and str(want.dtype) == _name(dtype)
    _assert_close(got, want, SCAN_TOL[dtype])
    y, s_fin = ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=32)
    assert y.dtype == dtype and s_fin.dtype == torch.float32
    plain_y, plain_fin = ssd_chunked_plain(x, dt, A, Bm, Cm, 32)
    assert torch.equal(y, plain_y.to(dtype)) and torch.equal(s_fin,
                                                            plain_fin)


@pytest.mark.parametrize("b, s, d", [(1, 1, 1), (2, 37, 64), (1, 300, 100)],
                         ids=str)
@pytest.mark.parametrize("dtype", NARROW, ids=_name)
def test_lru_scan_narrow_dtypes_match_jax(dtype, b, s, d):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.2, 0.999, (b, s, d)).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    (ta, tx), (ja, jx) = _narrow((a, x), dtype)
    want = np_out(_j_lru(ja, jx, chunk=32, interpret=True))
    got = lru_scan(ta, tx, chunk=32)
    assert got.dtype == dtype and str(want.dtype) == _name(dtype)
    _assert_close(got, want, SCAN_TOL[dtype])
    h, h_fin = lru_scan_chunked(ta, tx, chunk=32)
    assert h.dtype == dtype and h_fin.dtype == torch.float32
    plain_h, plain_fin = lru_chunked_plain(ta, tx, 32)
    assert torch.equal(h, plain_h.to(dtype)) and torch.equal(h_fin,
                                                            plain_fin)


def _assert_grads(got, want, dtypes, k: int) -> None:
    for g, w, dt in zip(got, want, dtypes):
        assert g.dtype == dt and w.dtype == dt
        g, w = g.float(), w.float()
        bound = k * EPS[dt] * w.abs() + 1e-4 * float(w.abs().max())
        assert bool(((g - w).abs() <= bound).all()), float((g - w).abs().max())


@pytest.mark.parametrize("dtype", NARROW, ids=_name)
def test_ssd_scan_narrow_gradients_match_plain_autograd(dtype):
    ts, _ = _narrow(_ssd_inputs(5, 2, 3, 45, 16, 16), dtype)
    dy = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 3, 45, 16), dtype=np.float32)).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in ts]
    y, s_fin = ssd_scan_chunked(*leaves, chunk=16)
    got = torch.autograd.grad((y * dy).float().sum() + s_fin.sum(), leaves)
    ref = [t.clone().requires_grad_(True) for t in ts]
    y_p, fin_p = ssd_chunked_plain(*ref, 16)
    want = torch.autograd.grad((y_p.to(dtype) * dy).float().sum()
                               + fin_p.sum(), ref)
    _assert_grads(got, want, [dtype] * 5, 1)


@pytest.mark.parametrize("dtype", NARROW, ids=_name)
def test_lru_scan_narrow_gradients_match_plain_autograd(dtype):
    rng = np.random.default_rng(8)
    (ta, tx), _ = _narrow((rng.uniform(0.2, 0.999, (2, 45, 32)),
                           rng.standard_normal((2, 45, 32))), dtype)
    dh = torch.from_numpy(rng.standard_normal((2, 45, 32))).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (ta, tx)]
    h, h_fin = lru_scan_chunked(*leaves, chunk=16)
    got = torch.autograd.grad((h * dh).float().sum() + h_fin.sum(), leaves)
    ref = [t.clone().requires_grad_(True) for t in (ta, tx)]
    h_p, fin_p = lru_chunked_plain(*ref, 16)
    want = torch.autograd.grad((h_p.to(dtype) * dh).float().sum()
                               + fin_p.sum(), ref)
    _assert_grads(got, want, [dtype] * 2, 2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32], ids=_name)
def test_narrow_scans_keep_the_plain_dtype_rules_on_the_cpu(dtype):
    """The CPU path takes what the plain version takes (float64 included)
    and returns y and h in the operand's dtype; integers are refused."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.uniform(0.2, 0.9, (1, 5, 4)))
    if dtype == torch.int32:
        with pytest.raises(TypeError, match="floats"):
            lru_scan_chunked(a.to(dtype), a.to(dtype))
        return
    h, h_fin = lru_scan_chunked(a.to(dtype), a.to(dtype))
    assert h.dtype == dtype and h_fin.dtype == torch.float32
    x, dt, A, Bm, Cm = (torch.from_numpy(t).to(dtype)
                        for t in _ssd_inputs(2, 1, 2, 9, 16, 16))
    y, s_fin = ssd_scan_chunked(x, dt, A, Bm, Cm)
    assert y.dtype == dtype and s_fin.dtype == torch.float32


# --------------------------------------------------------------------------- #
# Kernels 2 and 4 on payloads of 1 and 2 bytes                                 #
# --------------------------------------------------------------------------- #

PAYLOADS = [torch.bool, torch.int8, torch.uint8, torch.int16, torch.uint16,
            torch.float16, torch.bfloat16]
OMEGAS = [1, 3, 130, 257]


def _fills(dtype):
    """None, a value and the type's extremes (floats: ±inf and NaN too)."""
    if dtype == torch.bool:
        return [None, True, False]
    if dtype in FLOATS:
        fi = torch.finfo(dtype)
        return [None, -1.5, float(fi.min), float(fi.max), -np.inf, np.nan]
    ii = torch.iinfo(dtype)
    return [None, 5, ii.min, ii.max]


def _counts_payload(dtype, shape, seed):
    """A counts payload of the payload's own dtype, of another width, or
    none, in turn with the fills."""
    other = torch.uint16 if dtype in (torch.bool, torch.int8,
                                      torch.uint8) else torch.int8
    return [None, dtype, other][seed % 3]


def _counts(rng, shape, omega):
    c = rng.integers(-2, omega + 3, size=shape).astype(np.int32)
    c.reshape(-1)[:4] = [0, omega, omega + 5, -3]   # empty, full, past, < 0
    return c


def _same_bits(got, want, what):
    assert got.dtype == _to_torch(np.asarray(want)[:0], got.dtype).dtype
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)),
                                  err_msg=what)


@pytest.mark.parametrize("omega", OMEGAS)
@pytest.mark.parametrize("dtype", PAYLOADS, ids=_name)
def test_deliver_narrow_payloads_match_pallas_interpret(dtype, omega):
    """``deliver_tiles`` and the ``deliver``/``deliver_fused`` wrappers on a
    1- or 2-byte payload: bit for bit against the Pallas kernel in interpret
    mode, the output and the transposed counts payload each in its input's
    dtype."""
    v = 3
    rng = np.random.default_rng(omega)
    msgs = _keys(dtype, (v, v, omega), "special", omega, xla_cpu=True)
    counts = _counts(rng, (v, v), omega)
    tm, tc = _to_torch(msgs, dtype), torch.from_numpy(counts)
    for i, fill in enumerate(_fills(dtype)):
        cpd = _counts_payload(dtype, (v, v), i)
        cp = None if cpd is None else _keys(cpd, (v, v), "special", i,
                                            xla_cpu=True)
        want = np_out(jdeliver.deliver_tiles(
            jnp.asarray(msgs), jnp.asarray(counts),
            None if cp is None else jnp.asarray(cp), fill=fill,
            interpret=True))
        got = tdeliver.deliver_tiles(
            tm, tc, None if cp is None else _to_torch(cp, cpd), fill=fill)
        what = f"{dtype} ω={omega} fill={fill} ct={cpd}"
        _same_bits(got[0], want[0], what)
        assert (got[1] is None) == (cp is None)
        if cp is not None:
            _same_bits(got[1], want[1], what + " counts")
        fused = tdeliver.deliver_fused(
            tm, tc, None if cp is None else _to_torch(cp, cpd), fill=fill)
        _same_bits(fused[0], want[0], what + " deliver_fused")
    fill = _fills(dtype)[1]
    want = np_out(jdeliver.deliver(jnp.asarray(msgs), jnp.asarray(counts),
                                   fill=fill, interpret=True))
    _same_bits(tdeliver.deliver(tm, tc, fill=fill), want, "deliver")
    want = np_out(jdeliver.deliver(jnp.asarray(msgs), jnp.asarray(counts),
                                   interpret=True))
    _same_bits(tdeliver.deliver(tm, tc), want, "deliver, fill 0")


@pytest.mark.parametrize("omega", OMEGAS)
@pytest.mark.parametrize("dtype", PAYLOADS, ids=_name)
def test_assemble_narrow_payloads_match_pallas_interpret(dtype, omega):
    """``assemble_proc_tiles`` and ``assemble_proc_fused`` on a 1- or 2-byte
    chunk ``[s, P, d, ω]``: bit for bit against the Pallas kernel in
    interpret mode."""
    shape = (3, 2, 2)                          # s, P, d
    rng = np.random.default_rng(omega + 1)
    msgs = _keys(dtype, (*shape, omega), "special", omega + 1, xla_cpu=True)
    counts = _counts(rng, shape, omega)
    tm, tc = _to_torch(msgs, dtype), torch.from_numpy(counts)
    for i, fill in enumerate(_fills(dtype)):
        cpd = _counts_payload(dtype, shape, i + 1)
        cp = None if cpd is None else _keys(cpd, shape, "special", i,
                                            xla_cpu=True)
        want = np_out(jdeliver.assemble_proc_tiles(
            jnp.asarray(msgs), jnp.asarray(counts),
            None if cp is None else jnp.asarray(cp), fill=fill,
            interpret=True))
        what = f"{dtype} ω={omega} fill={fill} ct={cpd}"
        for fn in (tdeliver.assemble_proc_tiles,
                   tdeliver.assemble_proc_fused):
            got = fn(tm, tc, None if cp is None else _to_torch(cp, cpd),
                     fill=fill)
            _same_bits(got[0], want[0], f"{what} {fn.__name__}")
            assert (got[1] is None) == (cp is None)
            if cp is not None:
                _same_bits(got[1], want[1], f"{what} {fn.__name__} counts")


@pytest.mark.parametrize("omega", [3, 130])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=_name)
def test_delivery_moves_nan_payloads_and_subnormals_bit_for_bit(dtype,
                                                                 omega):
    """Every NaN payload and subnormal of a narrow float payload (and of its
    counts payload) arrives with its own bits: the masked transposes done on
    the integer bits in numpy."""
    rng = np.random.default_rng(omega)
    fill = -np.inf
    fb = _bits(np.array([fill], dtype=DTYPES[dtype][0]))[0]
    lane = np.arange(omega)
    for shape, fn, axes in (((3, 3), tdeliver.deliver_tiles, (1, 0)),
                            ((3, 2, 2), tdeliver.assemble_proc_tiles,
                             (1, 2, 0))):
        msgs = _keys(dtype, (*shape, omega), "special", omega)
        cp = _keys(dtype, shape, "special", omega + 1)
        counts = _counts(rng, shape, omega)
        out, ct = fn(_to_torch(msgs, dtype), torch.from_numpy(counts),
                     _to_torch(cp, dtype), fill=fill)
        want = np.where(lane < counts.transpose(axes)[..., None],
                        _bits(msgs).transpose(*axes, len(shape)), fb)
        np.testing.assert_array_equal(_bits(out), want)
        np.testing.assert_array_equal(_bits(ct), _bits(cp).transpose(axes))


@pytest.mark.parametrize("dtype", [torch.float64, torch.int64], ids=_name)
def test_delivery_raises_on_8_byte_payloads(dtype):
    """JAX with x64 off makes no 8-byte payload; the kernels move 1, 2 or 4
    bytes an element, so the array forms raise, naming the dtype."""
    c = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(TypeError, match=str(dtype)):
        tdeliver.deliver_tiles(torch.zeros((2, 2, 3), dtype=dtype), c,
                               fill=0)
    with pytest.raises(TypeError, match=str(dtype)):
        tdeliver.deliver_tiles(torch.zeros((2, 2, 3), dtype=torch.int8),
                               None, torch.zeros((2, 2), dtype=dtype))
    with pytest.raises(TypeError, match=str(dtype)):
        tdeliver.assemble_proc_tiles(torch.zeros((2, 2, 1, 3), dtype=dtype))
