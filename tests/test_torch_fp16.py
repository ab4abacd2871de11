"""Float16 through the port's attention, kernel 5 and its backward 5b, and
through a float16 qwen2-smoke model, against the JAX package on the CPU.

A model's dtype is a free field of its config (``dtype="float16"`` by
``dataclasses.replace``), and the JAX package takes any float in its
attention: the Pallas kernel loads q, k and v as float32 and writes the
output in ``q.dtype``.  Inputs are made with numpy from a seed and handed to
both packages.  On the CPU the port runs its plain versions (float32 sums,
one rounding to float16); the card's kernels are held against those in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``, and their rounding is
modelled in ``tests/test_torch_flash_attention.py``.  Tolerances:

- attention outputs (``flash_attention_bh`` against the Pallas kernel in
  interpret mode, ``attend`` against ``layers.attention``): float16, within
  1e-3 of the output's scale, ``max(1, max |want|)``: both sum in float32
  and round once, so they part by an ulp of float16 (2^-10 relative) at
  most;
- gradients (autograd through ``attend`` against ``jax.grad`` of
  ``layers.attention`` with its 32-key chunks, whose P·V rounds P to
  float16): each in its input's dtype, within 6.25e-3 of ``max(1, max
  |want|)``, JAX's bf16 tolerance scaled by the two types' epsilons as for
  the float16 scans (``tests/test_torch_dtypes.py``);
- the float16 qwen2-smoke model: prefill and decode logits (float32) within
  four float16 ulps of the largest logit (2^-8 of it): every layer's
  products and norms round to float16 where XLA's CPU and torch's round
  them in other places (measured up to 3.4 ulps, with and without the JAX
  attention's chunks); greedy tokens equal, up to a request's first step
  where JAX's two best logits lie within twice that tolerance of each
  other (a near-tie either side may break); the loss within 1e-3 relative
  and every gradient leaf (float16) within 6.25e-3 of its largest element;
  one train step's loss, gnorm and moments likewise.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import _jax_ref  # noqa: F401  (jax 0.9 shim before the JAX package)
import jax
import jax.numpy as jnp

import repro.configs as jconfigs
from repro.models import Model as JModel
from repro.models.layers import attention as j_attention
from repro.optim import OptConfig as JOptConfig
from repro.serve import ServeEngine as JServeEngine
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro_torch import configs
from repro_torch.interop import (params_from_jax, train_state_from_jax,
                                 train_state_to_numpy)
from repro_torch.kernels.flash_attention import attend, flash_attention_bh
from repro_torch.optim import OptConfig
from repro_torch.serve import ServeEngine
from repro_torch.train import TrainConfig, TrainState, make_train_step
from repro_torch.tree import leaves, map_tree

F16 = np.float16
FWD_TOL = 1e-3          # of max(1, max |want|)
GRAD_TOL = 6.25e-3      # of max(1, max |want|), and of a leaf's largest
LOSS_RTOL = 1e-3
LOGIT_TOL = 2**-8       # of the largest logit: four float16 ulps

j_fa = importlib.import_module(
    "repro.kernels.flash_attention.flash_attention")
_j_bh = jax.jit(j_fa.flash_attention_bh, static_argnames=(
    "h_q", "h_kv", "causal", "block_q", "block_k", "sk_valid", "interpret"))


def _rand(rng, shape):
    return rng.standard_normal(shape, dtype=np.float32).astype(F16)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _within(got, want, tol, what=""):
    """``got`` (a float16 tensor) within ``tol`` of ``max(1, max |want|)``
    of ``want``."""
    assert got.dtype == torch.float16, what
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


# (b, hq, hkv, s, d, causal, sk_valid): the Pallas kernel's [B·H, S, d]
# layout over groups 1, 2 and 6 and head dims 16 to 256.
BH_CASES = [(2, 2, 2, 16, 16, True, 16), (1, 6, 1, 24, 32, False, 19),
            (1, 12, 2, 16, 128, True, 16), (1, 4, 2, 8, 80, True, 5),
            (1, 10, 1, 16, 256, True, 16), (2, 4, 1, 16, 64, False, 1)]


@pytest.mark.parametrize("case", BH_CASES, ids=str)
def test_fp16_kernel_5_matches_the_pallas_kernel(case):
    """``flash_attention_bh`` in float16 against the TPU kernel in interpret
    mode (float32 inside, the output in ``q.dtype``)."""
    b, hq, hkv, s, d, causal, sk_valid = case
    rng = np.random.default_rng(sum(case[:5]))
    q, k, v = (_rand(rng, (b * h, s, d)) for h in (hq, hkv, hkv))
    want = _j_bh(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h_q=hq,
                 h_kv=hkv, causal=causal, block_q=8, block_k=8,
                 sk_valid=sk_valid, interpret=True)
    assert want.dtype == jnp.float16
    got = flash_attention_bh(_t(q), _t(k), _t(v), h_q=hq, h_kv=hkv,
                             causal=causal, sk_valid=sk_valid)
    _within(got, want, FWD_TOL, str(case))


# (b, sq, sk, hq, hkv, d, mask keywords): every mask of the JAX model's
# attention: causal and not, kv_valid, decode offsets, windows, the
# prefix-LM mask alone and under a window, GQA groups 1, 2, 5, 6 and 10,
# head dims 16, 32, 64, 80, 128 and 256.
ATTN_CASES = [
    (2, 16, 16, 4, 2, 16, dict(causal=True)),
    (1, 13, 29, 6, 1, 32, dict(causal=False, kv_valid=20)),
    (2, 1, 40, 12, 2, 128, dict(causal=True, q_offset=30, kv_valid=31)),
    (1, 9, 40, 12, 2, 128, dict(causal=True, q_offset=25, kv_valid=34)),
    (2, 20, 20, 4, 1, 64, dict(causal=True, window=5)),
    (1, 24, 24, 8, 1, 256, dict(causal=True, prefix=9)),
    (1, 30, 30, 4, 2, 80, dict(causal=True, prefix=7, window=8)),
    (1, 1, 50, 10, 1, 256, dict(causal=True, window=32, q_offset=45,
                                kv_valid=46)),
    (2, 12, 12, 10, 2, 16, dict(causal=False, window=4)),
]


def _port_kw(kw, sk):
    kw = dict(kw)
    kv = kw.pop("kv_valid", None)
    return dict(kw, sk_valid=sk if kv is None else kv)


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_fp16_attend_matches_the_jax_model_attention(case):
    """``attend`` in float16 against ``repro.models.layers.attention``
    (unchunked: float32 scores and sums, one rounding) over every mask."""
    b, sq, sk, hq, hkv, d, kw = case
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = (_rand(rng, shape) for shape in ((b, sq, hq, d),
                                               (b, sk, hkv, d),
                                               (b, sk, hkv, d)))
    want = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    assert want.dtype == jnp.float16
    got = attend(_t(q), _t(k), _t(v), **_port_kw(kw, sk))
    _within(got, want, FWD_TOL, str(case))


# (b, s, hq, hkv, d, mask keywords): the backward's cases of
# tests/test_torch_flash_attention.py (40 and 70 positions over the JAX
# attention's 32-key chunks), in float16, and qwen2's heads.
BWD_CASES = [
    (2, 40, 2, 2, 16, dict(causal=True)),
    (2, 40, 4, 2, 16, dict(causal=False)),
    (1, 70, 6, 1, 16, dict(causal=True, prefix=37)),
    (2, 40, 4, 2, 16, dict(causal=True, window=16)),
    (1, 70, 6, 1, 16, dict(causal=True, prefix=9, window=20)),
    (1, 40, 4, 4, 80, dict(causal=False)),
    (1, 40, 12, 2, 128, dict(causal=True)),
    (1, 70, 4, 1, 256, dict(causal=True, window=24)),
]


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_fp16_attention_gradients_match_jax_grad(case):
    """Autograd through ``attend`` in float16 (on the CPU the plain forward
    and ``attend_backward_plain``) against ``jax.grad`` of the JAX model's
    chunked attention in float16: each gradient float16, within
    ``GRAD_TOL``."""
    b, s, hq, hkv, d, kw = case
    rng = np.random.default_rng(sum(case[:5]))
    q, k, v, dout = (_rand(rng, shape) for shape in ((b, s, hq, d),
                                                     (b, s, hkv, d),
                                                     (b, s, hkv, d),
                                                     (b, s, hq, d)))

    def f(q, k, v):
        out = j_attention(q, k, v, chunk=32, **kw)
        return jnp.vdot(out.astype(jnp.float32), dout.astype(np.float32))

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves_ = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = attend(*leaves_, **kw)
    assert out.dtype == torch.float16
    got = torch.autograd.grad(out, leaves_, _t(dout))
    for name, g, w in zip("qkv", got, want):
        assert w.dtype == jnp.float16
        _within(g, w, GRAD_TOL, f"d{name} {case}")


# --------------------------------------------------------------------------- #
# A float16 qwen2-smoke model                                                  #
# --------------------------------------------------------------------------- #

ARCH = "qwen2-1.5b"


def _cfgs():
    """(the JAX package's float16 qwen2 smoke config, the port's)."""
    return (dataclasses.replace(jconfigs.get_config(ARCH).smoke(),
                                dtype="float16"),
            dataclasses.replace(configs.get_config(ARCH).smoke(),
                                dtype="float16"))


def _noisy(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + scale * rng.standard_normal(
        np.shape(a))).astype(np.asarray(a).dtype), tree)


def _pair(seed=0, scale=0.5):
    jcfg, tcfg = _cfgs()
    jm = JModel(jcfg)
    tree = _noisy(jm.init(jax.random.PRNGKey(seed)), seed, scale)
    assert {np.asarray(a).dtype for a in jax.tree.leaves(tree)} == \
        {np.dtype(F16)}
    model = params_from_jax(tcfg, tree, device="cpu")
    return jm, jax.tree.map(jnp.asarray, tree), model


def _logits_close(got, want, what):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= LOGIT_TOL * float(np.abs(want).max()), f"{what}: {err}"


def test_fp16_qwen2_prefill_and_every_decode_step_match_jax():
    jm, jp, model = _pair()
    prompts = np.random.default_rng(1).integers(0, model.cfg.vocab, (3, 40))
    max_seq = 48
    jc = jm.init_cache(3, max_seq)
    tc = model.init_cache(3, max_seq)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompts,
                                                           jnp.int32)}, jc)
    tl, tc = model.prefill({"tokens": torch.from_numpy(prompts)}, tc)
    _logits_close(tl, jl, "prefill")
    decode = jax.jit(jm.decode)
    tok = np.asarray(jl)[:, -1].argmax(-1)[:, None]
    for pos in range(prompts.shape[1], max_seq):
        jl, jc = decode(jp, jnp.asarray(tok, jnp.int32), jnp.int32(pos), jc)
        tl, tc = model.decode(torch.from_numpy(tok), pos, tc)
        _logits_close(tl, jl, f"decode at {pos}")
        tok = np.asarray(jl)[:, -1].argmax(-1)[:, None]


def test_fp16_qwen2_greedy_tokens_equal_the_jax_engine():
    """The port's engine gives the JAX engine's greedy tokens, each request
    up to its first step whose choice is a near-tie in JAX's own logits
    (its two best within ``2 LOGIT_TOL`` of the largest logit)."""
    jm, jp, model = _pair(seed=3)
    prompts = np.random.default_rng(4).integers(0, model.cfg.vocab, (4, 40))
    steps, max_seq = 12, 56
    want = np.asarray(JServeEngine(jm, jp, max_seq=max_seq).generate(
        jnp.asarray(prompts, jnp.int32), steps=steps))
    got = ServeEngine(model, max_seq=max_seq).generate(
        torch.from_numpy(prompts), steps=steps).numpy()
    # The JAX engine's steps again, for the margin of each choice.
    jc = jm.init_cache(len(prompts), max_seq)
    jl, jc = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(prompts, jnp.int32)}, jc)
    decode = jax.jit(jm.decode)
    tie = np.zeros(want.shape, bool)
    for i in range(steps):
        last = np.asarray(jl)[:, -1]
        top = np.sort(last, -1)
        tie[:, i] = top[:, -1] - top[:, -2] <= \
            2 * LOGIT_TOL * np.abs(last).max()
        tok = last.argmax(-1)
        assert (tok == want[:, i]).all()
        if i + 1 < steps:
            jl, jc = decode(jp, jnp.asarray(tok[:, None], jnp.int32),
                            jnp.int32(prompts.shape[1] + i), jc)
    compared = 0
    for r in range(len(prompts)):
        stop = int(np.argmax(tie[r])) if tie[r].any() else steps
        np.testing.assert_array_equal(got[r, :stop], want[r, :stop])
        compared += stop
    assert compared >= want.size // 2          # the rule leaves most to compare


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def _leaves_close(got, want, tol, what):
    gl = jax.tree.leaves(got)
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(gl) == len(wl)
    for g, (path, w) in zip(gl, wl):
        w = np.asarray(w, dtype=np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(g, dtype=np.float64) - w).max()) / scale
        assert err <= tol, f"{what}{jax.tree_util.keystr(path)}: {err}"


def test_fp16_qwen2_loss_and_every_gradient_match_jax():
    """``Model.loss`` and the gradient of every float16 leaf against
    ``jax.value_and_grad`` of the JAX model's loss (40 positions: its
    attention's 32-key chunks)."""
    jcfg, tcfg = _cfgs()
    jm = JModel(jcfg)
    params = _noisy(jm.init(jax.random.PRNGKey(0)), 1, 0.1)
    batch = _batch(jcfg, 2, 40, 2)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(params, batch)
    model = params_from_jax(tcfg, params, device="cpu")
    flat = list(leaves(model.params()))
    for p in flat:
        p.requires_grad_(True)
    loss, _ = model.loss({"tokens": torch.from_numpy(batch["tokens"])})
    got = torch.autograd.grad(loss, flat)
    assert all(g.dtype == torch.float16 for g in got)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    it = iter(got)
    grads = map_tree(lambda _: next(it), model.params())
    state = train_state_to_numpy(tcfg, TrainState(
        grads, {"step": torch.zeros(()), "m": grads, "v": grads}, None))
    _leaves_close(state["params"], jax.tree.map(np.asarray, jg), GRAD_TOL,
                  "grad ")


def test_fp16_qwen2_train_step_matches_jax():
    """One step of ``make_train_step`` on float16 parameters against
    ``jax.jit(make_train_step)``: the loss, gnorm and both moments (float32)
    within the float16 tolerances (step 1's lr is 0, so the parameters stay
    as they were in both)."""
    jcfg, tcfg = _cfgs()
    kw = dict(microbatches=1, warmup_steps=1, total_steps=10)
    jt = JTrainConfig(opt=JOptConfig(block=64), **kw)
    tt = TrainConfig(opt=OptConfig(block=64), **kw)
    jm = JModel(jcfg)
    jstate = j_init_state(_noisy(jm.init(jax.random.PRNGKey(0)), 1, 0.1), jt)
    model, tstate = train_state_from_jax(
        tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    batch = _batch(jcfg, 4, 40, 10)
    jstate, jmet = jax.jit(j_make_step(jm, jt))(jstate, batch)
    tstate, tmet = make_train_step(model, tt)(
        tstate, {"tokens": torch.from_numpy(batch["tokens"])})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tmet["gnorm"]), float(jmet["gnorm"]),
                               rtol=GRAD_TOL)
    js = jax.tree.map(np.asarray, jstate)
    ts = train_state_to_numpy(tcfg, tstate)
    _leaves_close(ts["params"], js.params, 0.0, "params ")
    _leaves_close(ts["opt"]["m"], js.opt["m"], GRAD_TOL, "m ")
    _leaves_close(ts["opt"]["v"], js.opt["v"], 2 * GRAD_TOL, "v ")
