"""The PSRS local sort's plain radix version (``radix_sort_plain``, the CPU
path of ``bitonic_sort_rows``) against the JAX package's Pallas kernel
``bitonic_sort_rows`` in interpret mode and against ``np.sort``, and pass by
pass against the stability that an LSD radix sort needs.

Integer keys: the tolerance is zero, outputs compare bit for bit.  The CUDA
radix kernel is held against the same plain version on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _jax_ref import bitonic, jax, jnp, np_out
from repro_torch.kernels.bitonic_sort import bitonic_sort_rows
from repro_torch.kernels.bitonic_sort.bitonic_sort import (RADIX_PASSES,
                                                          radix_key,
                                                          radix_pass,
                                                          radix_sort_plain)

INT_MIN, INT_MAX = -2**31, 2**31 - 1

_j_bitonic_rows = jax.jit(lambda x: bitonic.bitonic_sort_rows(
    x, interpret=True))


def _keys(rng, shape, kind):
    if kind == "random":
        return rng.integers(INT_MIN, INT_MAX, size=shape, endpoint=True,
                            dtype=np.int64).astype(np.int32)
    if kind == "dups":
        return rng.integers(-2, 3, size=shape).astype(np.int32)
    if kind == "equal":
        return np.full(shape, -7, np.int32)
    pool = np.array([INT_MIN, INT_MIN + 1, -1, 0, 1, INT_MAX - 1, INT_MAX],
                    np.int32)
    return pool[rng.integers(0, len(pool), size=shape)]


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows, n", [(1, 1), (1, 2), (3, 8), (2, 64),
                                     (2, 512)])
@pytest.mark.parametrize("kind", ["random", "dups", "extremes", "equal"])
def test_radix_plain_matches_pallas_interpret_and_np_sort(rows, n, kind):
    x = _keys(np.random.default_rng(rows * n + 3), (rows, n), kind)
    want = np_out(_j_bitonic_rows(jnp.asarray(x)))
    _eq(radix_sort_plain(torch.from_numpy(x)), want)
    _eq(bitonic_sort_rows(torch.from_numpy(x)), want)
    np.testing.assert_array_equal(want, np.sort(x, axis=-1))


@pytest.mark.parametrize("kind", ["random", "dups", "extremes", "equal"])
def test_radix_plain_takes_strided_rows(kind):
    """Rows a context apart, as the local sort reads the context store."""
    x = _keys(np.random.default_rng(11), (3, 300), kind)
    view = torch.from_numpy(x)[:, 22:278]                # rows 300 apart
    assert view.stride(0) == 300
    _eq(radix_sort_plain(view), np.sort(x[:, 22:278], axis=-1))
    _eq(bitonic_sort_rows(view), np.sort(x[:, 22:278], axis=-1))


def test_radix_key_puts_int_min_first_and_int_max_last():
    x = torch.tensor([0, INT_MAX, -1, INT_MIN, 1, INT_MIN + 1, INT_MAX - 1],
                     dtype=torch.int32)
    key = radix_key(x)
    assert int(key.min()) == 0 and int(key[3]) == 0
    assert int(key.max()) == 2**32 - 1 and int(key[1]) == 2**32 - 1
    assert torch.equal(torch.argsort(key), torch.argsort(x.to(torch.int64)))


@pytest.mark.parametrize("kind", ["random", "dups", "extremes"])
def test_each_pass_is_stable_on_the_low_digits(kind):
    """After pass d the row is ordered by the low 8 (d + 1) bits of the
    flipped key, keys that tie there in their input order: the stable order
    that LSD needs, pass by pass."""
    x = _keys(np.random.default_rng(5), (3, 1000), kind)
    flipped = (x.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000
    got = torch.from_numpy(x)
    for d in range(RADIX_PASSES):
        got = radix_pass(got, d)
        low = flipped & ((1 << (8 * (d + 1))) - 1)
        order = np.argsort(low, axis=-1, kind="stable")
        _eq(got, np.take_along_axis(x, order, axis=-1))


def test_radix_plain_sorts_float32_keys_on_the_cpu():
    """ops.sort pads float32 rows with the float maximum; the CPU path takes
    them through the same passes."""
    x = np.random.default_rng(9).standard_normal((2, 256)).astype(np.float32)
    x[0, :3] = [np.finfo(np.float32).max, -np.inf, np.inf]
    _eq(radix_sort_plain(torch.from_numpy(x)), np.sort(x, axis=-1))
