"""The port's synthetic data pipeline (``repro_torch.data``) against the
JAX package's (``repro.data``), on the CPU.

Tokens and hubert's frame labels are the JAX package's ``_hash_tokens``
bit for bit (uint32 arithmetic that wraps, done in int64 masked to 32 bits),
at several seeds, steps (up to 2^32 - 1), shapes and vocabularies, and so are
the batches ``synthetic_batches`` gives from any ``start_step``.  Frames and
patch embeddings come from a ``torch.Generator`` seeded from ``(seed,
step)``: not JAX's threefry numbers, so they are held to their shapes,
dtypes, determinism and moments, not to JAX's values.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import _jax_ref  # noqa: F401  (jax 0.9 shim before the JAX package)
import jax
import jax.numpy as jnp

import repro.data.pipeline as jpipe
from repro_torch.data import (BatchSpec, DataConfig, make_batch_specs,
                              synthetic_batch, synthetic_batches)
from repro_torch.data import pipeline as tpipe


@pytest.mark.parametrize("seed, step, b, s, vocab", [
    (0, 0, 1, 1, 2), (0, 1, 3, 7, 256), (7, 123456, 4, 33, 151936),
    (2**32 - 1, 2**32 - 1, 2, 5, 504), (1, 2**31 + 5, 3, 17, 1000),
    (3, 99, 16, 1024, 504)])
def test_hash_tokens_are_bit_for_bit(seed, step, b, s, vocab):
    want = np.asarray(jpipe._hash_tokens(seed, step, b, s, vocab))
    got = tpipe._hash_tokens(seed, step, b, s, vocab)
    assert got.dtype == torch.int32 and got.shape == (b, s)
    np.testing.assert_array_equal(got.numpy(), want)


_CFGS = {
    "tokens": dict(seq_len=24, global_batch=3, vocab=256, seed=5),
    "patches": dict(seq_len=24, global_batch=3, vocab=256, seed=5,
                    frontend="patches", n_frontend_tokens=8, d_model=16),
    "frames": dict(seq_len=24, global_batch=3, vocab=504, seed=5,
                   frontend="frames", d_model=16),
}


@pytest.mark.parametrize("kind", list(_CFGS))
@pytest.mark.parametrize("start", [0, 3, 1000])
def test_batches_match_the_jax_pipeline_from_any_start_step(kind, start):
    """The integer entries of each batch equal the JAX package's, from any
    ``start_step``; the float entries have the JAX shapes and dtypes."""
    jcfg = jpipe.DataConfig(**_CFGS[kind])
    tcfg = DataConfig(**_CFGS[kind])
    got = list(itertools.islice(synthetic_batches(tcfg, start_step=start,
                                                   device="cpu"), 3))
    want = list(itertools.islice(jpipe.synthetic_batches(jcfg,
                                                         start_step=start), 3))
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            wa = np.asarray(w[key])
            assert g[key].shape == wa.shape and str(g[key].dtype).endswith(
                str(wa.dtype))
            if key in ("tokens", "labels"):
                np.testing.assert_array_equal(g[key].numpy(), wa)


def test_a_resumed_pipeline_gives_the_batches_of_its_steps():
    cfg = DataConfig(**_CFGS["frames"])
    run = list(itertools.islice(synthetic_batches(cfg, device="cpu"), 6))
    resumed = list(itertools.islice(synthetic_batches(cfg, start_step=4,
                                                     device="cpu"), 2))
    for a, b in zip(run[4:], resumed):
        for key in a:
            assert torch.equal(a[key], b[key])


@pytest.mark.parametrize("kind", ["patches", "frames"])
def test_float_entries_are_standard_normals_per_seed_and_step(kind):
    cfg = DataConfig(**{**_CFGS[kind], "global_batch": 8, "seq_len": 256,
                        "d_model": 64})
    key = "frames" if kind == "frames" else "patches"
    x = synthetic_batch(cfg, 2, "cpu")[key]
    assert x.dtype == torch.float32
    assert torch.equal(x, synthetic_batch(cfg, 2, "cpu")[key])
    assert not torch.equal(x, synthetic_batch(cfg, 3, "cpu")[key])
    other = DataConfig(**{**_CFGS[kind], "global_batch": 8, "seq_len": 256,
                          "d_model": 64, "seed": 6})
    assert not torch.equal(x, synthetic_batch(other, 2, "cpu")[key])
    assert abs(float(x.mean())) < 0.05 and abs(float(x.std()) - 1) < 0.05


@pytest.mark.parametrize("kind", list(_CFGS))
def test_batch_specs_have_the_jax_shapes_and_dtypes(kind):
    jspec = jpipe.make_batch_specs(jpipe.DataConfig(**_CFGS[kind]))
    spec = make_batch_specs(DataConfig(**_CFGS[kind]))
    assert sorted(spec) == sorted(jspec)
    for key, s in spec.items():
        assert isinstance(s, BatchSpec)
        assert s.shape == jspec[key].shape
        assert str(s.dtype).split(".")[-1] == str(jspec[key].dtype)
    batch = synthetic_batch(DataConfig(**_CFGS[kind]), 0, "cpu")
    assert {k: tuple(v.shape) for k, v in batch.items()} == {
        k: s.shape for k, s in spec.items()}


def test_uint32_multiply_wraps_like_numpy():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 1000, dtype=np.uint64)
    for c in (2654435761, 40503, 374761393, 2246822519, 3266489917, 1):
        want = (a.astype(np.uint32) * np.uint32(c)).astype(np.int64)
        got = tpipe._mul32(torch.from_numpy(a.astype(np.int64)), c)
        np.testing.assert_array_equal(got.numpy(), want)
