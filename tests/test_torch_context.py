"""Parity of the port's context layer (``repro_torch.core.context``) with the
JAX package's: layouts place fields at the same word offsets, and typed
field views are exact bitcasts of the same store words.  Integer and float32
bits compare exactly (tolerance zero)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _jax_ref import core as jcore, jnp, store_words
from repro_torch import interop
from repro_torch.core import ContextLayout, Ctx, init_store
from repro_torch.pems_apps import psrs_plan


def _psrs_layouts(v, n_v, cap, rcap):
    from _jax_ref import apps
    jl = apps.psrs_plan(v, n_v, cap=cap, rcap=rcap)[0].layout
    tl = psrs_plan(v, n_v, cap=cap, rcap=rcap, device="cpu")[0].layout
    return jl, tl


def _same_layout(jl, tl):
    assert tl.names == jl.names
    for name in jl.names:
        assert tl.offset(name) == jl.offset(name), name
        assert tl.field(name).shape == jl.field(name).shape, name
        assert str(tl.field(name).dtype).endswith(str(jl.field(name).dtype))
    assert (tl.words, tl.live_words, tl.mu_bytes, tl.live_bytes) == (
        jl.words, jl.live_words, jl.mu_bytes, jl.live_bytes)
    ji, ti = jl.live_word_index(), tl.live_word_index()
    assert (ji is None) == (ti is None)
    if ji is not None:
        np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("v, n_v, cap, rcap", [
    (4, 64, None, None), (8, 100, 40, 150), (16, 256, None, None),
    (16, 1 << 23, None, None),
])
def test_psrs_layout_matches_jax(v, n_v, cap, rcap):
    jl, tl = _psrs_layouts(v, n_v, cap, rcap)
    _same_layout(jl, tl)


def test_full_scale_psrs_layout_words():
    # 2^27 keys over v = 16: one context is 293,601,890 words, and the
    # store's flat word offsets pass 2^31 (the kernels use 64-bit offsets).
    _, tl = _psrs_layouts(16, 1 << 23, None, None)
    assert tl.words == 293_601_890
    assert 16 * tl.words > 2**31


def test_allocator_layout_with_freed_hole_matches_jax():
    def build(lo_cls, i32, f32, u32):
        lo = lo_cls(64)
        lo.add("a", (5,), i32).add("b", (3, 2), f32).add("c", (7,), u32)
        lo.drop("b").add("d", (2,), i32).add("e", (9,), f32)
        return lo

    jl = build(jcore.ContextLayout, jnp.int32, jnp.float32, jnp.uint32)
    tl = build(ContextLayout, torch.int32, torch.float32, torch.uint32)
    _same_layout(jl, tl)
    assert tl.live_word_index() is not None


def test_layout_rejects_what_jax_rejects():
    lo = ContextLayout().add("a", (2,), torch.int32)
    with pytest.raises(ValueError, match="duplicate"):
        lo.add("a", (2,), torch.int32)
    with pytest.raises(ValueError, match="zero size"):
        lo.add("z", (0,), torch.int32)
    with pytest.raises(TypeError, match="4-byte"):
        lo.add("h", (2,), torch.float16)
    with pytest.raises(MemoryError, match="context exhausted"):
        ContextLayout(4).add("big", (5,), torch.int32)


def _toy(seed):
    rng = np.random.default_rng(seed)
    v = 3
    vals = {
        "i": rng.integers(-2**31, 2**31, size=(v, 4, 2)).astype(np.int32),
        "f": rng.standard_normal((v, 5)).astype(np.float32),
        "u": rng.integers(0, 2**32, size=(v, 3), dtype=np.uint64)
        .astype(np.uint32),
    }
    vals["f"][0, 0] = np.float32(-0.0)
    vals["f"][1, 1] = np.float32(np.inf)
    vals["u"][2, 2] = np.uint32(2**32 - 1)
    return v, vals


def _layouts():
    jl = (jcore.ContextLayout().add("i", (4, 2), jnp.int32)
          .add("f", (5,), jnp.float32).add("u", (3,), jnp.uint32))
    tl = (ContextLayout().add("i", (4, 2), torch.int32)
          .add("f", (5,), torch.float32).add("u", (3,), torch.uint32))
    return jl, tl


def test_store_fields_round_trip_int32_uint32_float32_bits():
    v, vals = _toy(0)
    jl, tl = _layouts()
    js = jcore.init_store(jl, v)
    ts = init_store(tl, v, device="cpu")
    for name, x in vals.items():
        js = js.with_field(name, jnp.asarray(x))
        ts = ts.with_field(name, torch.from_numpy(x.view(
            np.int32 if x.dtype == np.uint32 else x.dtype))
            .view(tl.field(name).dtype))
    np.testing.assert_array_equal(interop.store_to_numpy(ts),
                                  store_words(js))
    for name, x in vals.items():
        got = ts.field(name)
        assert got.dtype == tl.field(name).dtype
        assert got.shape == (v,) + tl.field(name).shape
        np.testing.assert_array_equal(
            got.view(torch.int32).numpy().view(x.dtype), x)
    # Raw word ranges round-trip through the word-level API.
    w = ts.field_words_view("f").clone()
    ts.with_field("f", torch.zeros(v, 5))
    assert int(ts.field_words_view("f").abs().sum()) == 0
    ts.with_field_words("f", w)
    np.testing.assert_array_equal(
        ts.field("f").numpy().view(np.uint32), vals["f"].view(np.uint32))
    np.testing.assert_array_equal(
        w.numpy().view(np.uint32),
        np.asarray(js.field_words_view("f")))
    with pytest.raises(TypeError, match="int32 words"):
        ts.with_field_words("f", w.view(torch.float32))


def test_ctx_get_set_batched_over_the_round():
    v, vals = _toy(1)
    _, tl = _layouts()
    data = torch.zeros((v, tl.words), dtype=torch.int32)
    ctx = Ctx(tl, data[1:3])                     # a round of k = 2 contexts
    for name, x in vals.items():
        ctx.set(name, torch.from_numpy(
            x[1:3].view(np.int32)).view(tl.field(name).dtype))
    for name, x in vals.items():
        got = ctx.get(name)
        assert got.shape == (2,) + tl.field(name).shape
        np.testing.assert_array_equal(
            got.view(torch.int32).numpy().view(x.dtype), x[1:3])
    # set writes through to the store rows the block views, in place.
    assert int(data[0].abs().sum()) == 0
    store_vals = interop.store_from_numpy(
        tl, data.numpy().view(np.uint32), device="cpu")
    np.testing.assert_array_equal(
        store_vals.field("u")[1:3].view(torch.int32).numpy().view(np.uint32),
        vals["u"][1:3])


def test_init_store_fn_matches_jax():
    jl, tl = _layouts()
    v = 4
    js = jcore.init_store(jl, v, lambda rho: {
        "i": jnp.full((4, 2), rho * 7 - 3, jnp.int32),
        "f": jnp.full((5,), rho, jnp.float32) / 4})
    ts = init_store(tl, v, lambda rhos: {
        "i": (rhos * 7 - 3)[:, None, None].expand(v, 4, 2),
        "f": rhos[:, None].expand(v, 5).to(torch.float32) / 4},
        device="cpu")
    np.testing.assert_array_equal(interop.store_to_numpy(ts),
                                  store_words(js))


def test_interop_rejects_mismatched_words():
    _, tl = _layouts()
    with pytest.raises(TypeError):
        interop.store_from_numpy(tl, np.zeros((2, tl.words), np.int32),
                                 device="cpu")
    with pytest.raises(ValueError):
        interop.store_from_numpy(tl, np.zeros((2, tl.words + 1), np.uint32),
                                 device="cpu")
