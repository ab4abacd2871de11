"""The port's optimizer (``repro_torch.optim``: AdamW, its int8 moments, the
cosine schedule) and the training step's int8 error-feedback compression
(``repro_torch.train.train_step._compress_ef``) against the JAX package's,
on the CPU.

The inputs are made with numpy from seeds and given to both packages.
Everything here is elementwise float32 arithmetic in the same order, so it
is held bit for bit: ``_quant``/``_dequant`` (``torch.round`` and
``jnp.round`` both round half to even), ``_compress_ef``, the schedule, and
AdamW's parameters and moments (float32 or int8 with their scales) over
steps whose gradients the clip leaves alone.  The one reduction, the global
gradient norm, adds each leaf's squares in another order than XLA, so gnorm
is held within 1e-6 relative (a float32 ulp or two); while it is below
``grad_clip`` the clip factor is exactly 1 either way.  On a step that
clips, that ulp scales every gradient: parameters and float32 moments are
then held within 1e-6 relative of the leaf, int8 moments within one unit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _jax_ref  # noqa: F401  (jax 0.9 shim before the JAX package)
import jax
import jax.numpy as jnp

import repro.optim.adamw as jadamw
import repro.train.train_step as jtrain
from repro.optim import OptConfig as JOptConfig
from repro.optim import cosine_schedule as j_cosine
from repro_torch.optim import OptConfig, adamw_init, adamw_update
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import cosine_schedule
from repro_torch.train import train_step as ttrain


def _tree(seed, scale=1.0):
    """A small parameter-like nest: a matrix, a stacked 3-d leaf, a vector
    and a ragged last dim (not a block multiple)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return {"w": f(12, 40), "layers": {"a": f(3, 5, 70), "b": f(9)},
            "z": f(2, 131)}


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _equal(got, want):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("block", [4, 64, 2048])
@pytest.mark.parametrize("shape", [(7,), (3, 130), (2, 3, 64)])
def test_quant_and_dequant_are_bit_for_bit(block, shape):
    rng = np.random.default_rng(block + len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:5] = [0.0, 0.5, -0.5, 1e-30, -2.0]   # ties and tiny values
    jq = jadamw._quant(jnp.asarray(x), block)
    tq = tadamw._quant(torch.from_numpy(x), block)
    _equal(tq, jq)
    _equal(tadamw._dequant(tq, shape, block),
           jadamw._dequant(jq, shape, block))


def test_quant_of_an_all_zero_block_is_zero():
    q = tadamw._quant(torch.zeros((2, 10)), 4)
    assert not q["q"].any() and not q["scale"].any()


@pytest.mark.parametrize("warmup, total", [(1, 10), (5, 20), (100, 10_000)])
def test_cosine_schedule_is_bit_for_bit(warmup, total):
    for step in [0, 1, 2, warmup - 1, warmup, warmup + 1, total // 2, total,
                 total + 7]:
        got = cosine_schedule(torch.tensor(step, dtype=torch.int32),
                              warmup=warmup, total=total)
        want = np.asarray(j_cosine(jnp.int32(step), warmup=warmup,
                                   total=total))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    assert float(cosine_schedule(0, warmup=warmup, total=total)) == 0.0


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("block", [16, 2048])
def test_adamw_steps_are_bit_for_bit(quantize, block):
    """Three AdamW steps from the same parameters and gradients, below the
    clip: parameters, moments (int8 blocks and scales when quantized), the
    step and lr bit for bit, gnorm within 1e-6.  Then a step whose
    gradients the clip scales, within the bounds above."""
    jcfg = JOptConfig(quantize_moments=quantize, block=block)
    tcfg = OptConfig(quantize_moments=quantize, block=block)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = _torch_tree(_tree(0))
    js = jadamw.adamw_init(jp, jcfg)
    ts = adamw_init(tp, tcfg)
    for i in range(4):
        g = _tree(10 + i, scale=0.02 if i < 3 else 3.0)
        lr_scale = np.float32(0.5 + 0.1 * i)
        jp, js, jm = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, g), js,
                                         jcfg, jnp.asarray(lr_scale))
        _, _, tm = adamw_update(tp, _torch_tree(g), ts, tcfg,
                                torch.tensor(lr_scale))
        assert int(ts["step"]) == int(js["step"]) == i + 1
        np.testing.assert_allclose(tm["gnorm"].numpy(),
                                   np.asarray(jm["gnorm"]), rtol=1e-6)
        np.testing.assert_array_equal(tm["lr"].numpy(), np.asarray(jm["lr"]))
        if i < 3:
            assert float(jm["gnorm"]) < jcfg.grad_clip
            _equal(tp, jp)
            _equal(ts["m"], js["m"])
            _equal(ts["v"], js["v"])
            continue
        assert float(jm["gnorm"]) > jcfg.grad_clip   # this step clips
        for got, want in zip(jax.tree.leaves((tp, ts["m"], ts["v"])),
                             jax.tree.leaves((jp, js["m"], js["v"]))):
            got, want = got.numpy(), np.asarray(want)
            if want.dtype == np.int8:
                assert np.abs(got.astype(int) - want).max() <= 1
            else:
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_adamw_decays_a_leaf_whose_gradient_is_zero():
    """A frames model's ``embed`` gets zero gradients: AdamW still decays it
    by ``lr * weight_decay * p`` a step, as in the JAX package."""
    cfg = OptConfig(lr=1e-2)
    p = {"embed": torch.ones((4, 3)), "w": torch.ones(5)}
    s = adamw_init(p, cfg)
    g = {"embed": torch.zeros((4, 3)), "w": torch.full((5,), 0.1)}
    adamw_update(p, g, s, cfg, 1.0)
    want = np.float32(1.0) - np.float32(1e-2) * np.float32(0.1)
    np.testing.assert_array_equal(p["embed"].numpy(), np.full((4, 3), want))


def test_adamw_updates_bf16_parameters_in_place():
    cfg = OptConfig()
    p = {"w": torch.randn(8, 16).to(torch.bfloat16)}
    ptr = p["w"].data_ptr()
    jp = {"w": jnp.asarray(p["w"].float().numpy()).astype(jnp.bfloat16)}
    s, js = adamw_init(p, cfg), jadamw.adamw_init(jp, JOptConfig())
    g = 0.01 * np.random.default_rng(3).standard_normal((8, 16)).astype(
        np.float32)                                  # below the clip
    _, _, _ = adamw_update(p, {"w": torch.from_numpy(g).to(torch.bfloat16)},
                           s, cfg, 1.0)
    jp, js, _ = jadamw.adamw_update(
        jp, {"w": jnp.asarray(g).astype(jnp.bfloat16)}, js, JOptConfig(), 1.0)
    assert p["w"].data_ptr() == ptr and p["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["w"].float().numpy(),
                                  np.asarray(jp["w"].astype(jnp.float32)))
    np.testing.assert_array_equal(s["m"]["w"].numpy(), np.asarray(js["m"]["w"]))


@pytest.mark.parametrize("block", [8, 2048])
def test_compress_ef_is_bit_for_bit_over_rounds(block):
    """Three rounds of int8 error-feedback compression: the dequantized
    gradients and the residuals carried between rounds, bit for bit."""
    tree = _tree(5)
    jef = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), tree)
    tef = _torch_tree(jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                                   tree))
    for r in range(3):
        g = _tree(20 + r, scale=0.3)
        jg, jef = jtrain._compress_ef(jax.tree.map(jnp.asarray, g), jef,
                                      block=block)
        tg = ttrain._compress_ef(_torch_tree(g), tef, block=block)
        _equal(tg, jg)
        _equal(tef, jef)
