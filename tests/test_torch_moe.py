"""The port's MoE block (``repro_torch.models.blocks.moe_apply``, its
dispatch and the dense oracle) and the MoE and patches models against the
JAX package's (``repro.models.blocks``, ``repro.models.Model``,
``repro.serve.ServeEngine``) at ``.smoke()`` widths, on the CPU.

Parameters are the JAX package's initialisation plus seeded numpy noise,
carried over as numpy arrays; float32 throughout.  Tolerances:

- the block's output ``y`` within atol 1e-5 (activations of order one: the
  float sums run in another order, and torch's ``exp`` differs from XLA's by
  an ulp on about a tenth of inputs, which moves the gate weights' softmax);
- the aux loss within rtol 1e-6, a few float32 ulps: it is a softmax's mean,
  so the same ``exp`` ulps keep it from being bit-equal;
- the routing and the dispatch indices (``sel``, ``se``, ``pos_c``,
  ``keep``, ``tok_sorted``) exactly: they decide which tokens are dropped;
- the models' logits within rtol 1e-4 and atol 1e-4 (as
  ``tests/test_torch_serve.py``), greedy tokens equal.

The capacity factors are the smoke configs' 8.0 (nothing dropped), the
published 1.25 and 0.25 (many tokens dropped); ``moe_groups`` 1, 2 and 3 on
24 tokens, which all three divide.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import _jax_ref  # noqa: F401  (jax 0.9 shim before the JAX package)
import jax
import jax.numpy as jnp

import repro.configs as jconfigs
import repro.models.blocks as jblocks
from repro.models import Model as JModel
from repro.serve import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.interop import params_from_jax
from repro_torch.models import blocks
from repro_torch.serve import ServeEngine

ATOL = 1e-5
AUX_RTOL = 1e-6
TOL = dict(rtol=1e-4, atol=1e-4)
MOE = ["kimi-k2-1t-a32b", "arctic-480b"]
CAPACITY = [8.0, 1.25, 0.25]
GROUPS = [1, 2, 3]


def _cfgs(arch, **kw):
    """(the JAX package's smoke config, the port's), both with ``kw``."""
    return (dataclasses.replace(jconfigs.get_config(arch).smoke(), **kw),
            dataclasses.replace(configs.get_config(arch).smoke(), **kw))


def _noisy(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + scale * rng.standard_normal(
        np.shape(a))).astype(np.asarray(a).dtype), tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _moe(arch, seed=0, **kw):
    """(JAX cfg, port cfg, noisy MoE params as numpy, the same as
    tensors, x [4, 6, d] as numpy)."""
    jcfg, cfg = _cfgs(arch, **kw)
    p = _noisy(jblocks.moe_params(jax.random.PRNGKey(seed), jcfg), seed + 1,
               0.1)
    x = np.random.default_rng(seed + 2).standard_normal(
        (4, 6, cfg.d_model), dtype=np.float32)
    return jcfg, cfg, p, _torch(p), x


# --------------------------------------------------------------------------- #
# The block                                                                    #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_matches_jax(arch, cf, groups):
    """kimi (shared expert) and arctic (dense residual): the capacity
    dispatch, dropping included, gives the JAX block's output and aux."""
    jcfg, cfg, p, tp, x = _moe(arch, capacity_factor=cf, moe_groups=groups)
    want_y, want_aux = jblocks.moe_apply(jcfg, p, x)
    y, aux = blocks.moe_apply(cfg, tp, torch.from_numpy(x))
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=AUX_RTOL)
    n_groups, tg, cap = blocks.moe_groups(cfg, x.shape[0] * x.shape[1])
    assert n_groups == groups and tg * groups == 24
    xg = torch.from_numpy(x).reshape(n_groups, tg, -1)
    dropped = int((~blocks.moe_dispatch(cfg, tp["router"], xg, cap)["keep"])
                  .sum())
    if cf == 8.0:
        assert dropped == 0
    if cf == 0.25:
        assert dropped > 0


@pytest.mark.parametrize("arch", MOE)
def test_dense_oracle_matches_jax(arch):
    jcfg, cfg, p, tp, x = _moe(arch, seed=4)
    np.testing.assert_allclose(
        blocks.moe_apply_dense_oracle(cfg, tp, torch.from_numpy(x)).numpy(),
        np.asarray(jblocks.moe_apply_dense_oracle(jcfg, p, x)), rtol=0,
        atol=ATOL)


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("arch", MOE)
def test_capacity_path_equals_the_oracle_when_nothing_drops(arch, groups):
    """With ``cap`` at least every expert's load (capacity factor 8 on the
    smoke's 8 experts), the dispatch and combine are exact bookkeeping."""
    _, cfg, _, tp, x = _moe(arch, seed=5, moe_groups=groups)
    y, _ = blocks.moe_apply(cfg, tp, torch.from_numpy(x))
    torch.testing.assert_close(
        y, blocks.moe_apply_dense_oracle(cfg, tp, torch.from_numpy(x)),
        rtol=0, atol=ATOL)


def _numpy_dispatch(sel, weights, e, cap):
    """The JAX ``group_dispatch``'s integer steps for one group, in numpy
    with a stable argsort, and which entries the scatter ``xe.at[se,
    pos_c].set(src)`` leaves in their slot when the last write to a slot
    wins (XLA's order on the CPU)."""
    tg, k = sel.shape
    flat_e = sel.reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    se = flat_e[order]
    start = np.searchsorted(se, np.arange(e), side="left")
    pos = np.arange(tg * k) - start[se]
    pos_c, keep = np.minimum(pos, cap - 1), pos < cap
    owner = {}
    for i, slot in enumerate(zip(se, pos_c)):
        owner[slot] = i
    served = np.array([keep[i] and owner[slot] == i
                       for i, slot in enumerate(zip(se, pos_c))])
    return dict(se=se, pos_c=pos_c, keep=keep, served=served,
                tok_sorted=np.repeat(np.arange(tg), k)[order],
                w_sorted=weights.reshape(-1)[order])


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("arch", MOE)
def test_dispatch_indices_match_a_numpy_stable_argsort(arch, cf, groups):
    """The routing equals ``lax.top_k`` of the JAX package's float32 router
    logits, and each group's dispatch indices equal a numpy recomputation
    from it, bit for bit."""
    _, cfg, p, tp, x = _moe(arch, seed=6, capacity_factor=cf,
                            moe_groups=groups)
    n_groups, tg, cap = blocks.moe_groups(cfg, 24)
    xg = torch.from_numpy(x).reshape(n_groups, tg, -1)
    got = blocks.moe_dispatch(cfg, tp["router"], xg, cap)
    logits = jnp.asarray(x.reshape(n_groups, tg, -1)) @ p["router"]
    _, want_sel = jax.lax.top_k(logits, cfg.top_k)
    np.testing.assert_array_equal(got["sel"].numpy(), np.asarray(want_sel))
    for g in range(n_groups):
        want = _numpy_dispatch(got["sel"][g].numpy(),
                               got["weights"][g].numpy(), cfg.n_experts, cap)
        for name in ("se", "pos_c", "keep", "served", "tok_sorted",
                     "w_sorted"):
            np.testing.assert_array_equal(got[name][g].numpy(), want[name],
                                          err_msg=name)


def test_top_k_takes_the_lower_index_among_ties():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0],
                           [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    vals, idx = blocks._top_k(logits, 4)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(logits.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


def test_an_expert_past_its_capacity_loses_its_last_slot_as_in_jax():
    """cap 1 with every token on one expert: the JAX scatter writes the
    dropped entries' zeros over the kept one (the last write wins on the
    CPU), so that expert gives every token nothing; the port does the
    same, deterministically."""
    jcfg, cfg, p, tp, x = _moe("arctic-480b", seed=7, capacity_factor=0.1)
    assert blocks.moe_groups(cfg, 24)[2] == 1
    p = dict(p, router=np.zeros_like(p["router"]))
    p["router"][:, 5] = 1.0    # expert 5, then 0 (ties: the lower index)
    x = np.abs(x)
    tp = _torch(p)
    want_y, _ = jblocks.moe_apply(jcfg, p, x)
    y, _ = blocks.moe_apply(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=0,
                               atol=ATOL)
    dense = jblocks.mlp(x, p["dense"], cfg.act)
    np.testing.assert_allclose(y.numpy(), np.asarray(dense), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("arch", MOE)
def test_expert_stacks_are_made_expert_by_expert(arch):
    """Random init makes each expert stack in the model's dtype, one expert
    at a time (the full-width stacks pass 2^31 elements and would not fit
    beside the model in float32), with the JAX shapes and a float32
    router."""
    cfg = dataclasses.replace(configs.get_config(arch).smoke(),
                              dtype="bfloat16")
    p = blocks.moe_params(torch.Generator().manual_seed(0), cfg)
    gates = 1 if cfg.act == "gelu" else 2
    assert p["router"].dtype == torch.float32
    assert p["w_in"].shape == (cfg.n_experts, cfg.d_model, gates, cfg.d_ff)
    assert p["w_out"].shape == (cfg.n_experts, cfg.d_ff, cfg.d_model)
    assert p["w_in"].dtype == p["w_out"].dtype == torch.bfloat16
    assert ("shared" in p) == bool(cfg.n_shared_experts)
    assert ("dense" in p) == cfg.moe_dense_residual
    std = float(p["w_in"].float().std()) * cfg.d_model ** 0.5
    assert 0.9 < std < 1.1
    assert not torch.equal(p["w_in"][0], p["w_in"][1])


# --------------------------------------------------------------------------- #
# The models                                                                   #
# --------------------------------------------------------------------------- #

def _pair(arch, seed=0, **kw):
    """(JAX model, its noisy params as jnp arrays, the port's model holding
    the same params on the CPU)."""
    jcfg, cfg = _cfgs(arch, **kw)
    jm = JModel(jcfg)
    tree = _noisy(jm.init(jax.random.PRNGKey(seed)), seed, 0.5)
    return jm, jax.tree.map(jnp.asarray, tree), params_from_jax(
        cfg, tree, device="cpu")


def _patches(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)


# (arch, capacity factor, moe_groups); paligemma has no experts.
MODEL_CASES = [(arch, cf, groups) for arch in MOE
               for cf, groups in ((8.0, 1), (1.25, 1), (1.25, 2), (0.25, 3))]
MODEL_CASES.append(("paligemma-3b", 8.0, 1))


@pytest.mark.parametrize("arch, cf, groups", MODEL_CASES, ids=str)
def test_model_prefill_and_every_decode_step_match(arch, cf, groups):
    """The MoE models (kimi: a dense first layer of MLP width
    ``moe_dense_d_ff``, then MoE) and paligemma (patches before the prompt,
    attended under the prefix-LM mask) against ``repro.models.Model``: the
    prefill's logits and every decode step's.  A decode step of 3 requests
    has ``cap`` 1 at capacity factor 0.25 and 1.25 (2 experts of 8 a
    token), so tokens drop in every step."""
    jm, jp, model = _pair(arch, moe_groups=groups, capacity_factor=cf)
    cfg = model.cfg
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (3, 12))
    prefix = cfg.n_frontend_tokens
    max_seq = prefix + 20
    jbatch = {"tokens": jnp.asarray(prompts, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(prompts)}
    if prefix:
        pt = _patches(cfg, 3, 2)
        jbatch["patches"], tbatch["patches"] = jnp.asarray(pt), \
            torch.from_numpy(pt)
    jc, tc = jm.init_cache(3, max_seq), model.init_cache(3, max_seq)
    jl, jc = jax.jit(jm.prefill)(jp, jbatch, jc)
    tl, tc = model.prefill(tbatch, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    decode = jax.jit(jm.decode)
    tok = np.asarray(jl)[:, -1].argmax(-1)[:, None]
    for pos in range(prefix + prompts.shape[1], max_seq):
        jl, jc = decode(jp, jnp.asarray(tok, jnp.int32), jnp.int32(pos), jc)
        tl, tc = model.decode(torch.from_numpy(tok), pos, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jl)[:, -1].argmax(-1)[:, None]


@pytest.mark.parametrize("arch, cf", [(arch, cf) for arch in MOE
                                      for cf in CAPACITY]
                         + [("paligemma-3b", 8.0)], ids=str)
def test_greedy_tokens_equal_the_jax_engine(arch, cf):
    jm, jp, model = _pair(arch, seed=3, capacity_factor=cf)
    cfg = model.cfg
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (4, 9))
    max_seq = cfg.n_frontend_tokens + 24
    jextra = textra = None
    if cfg.n_frontend_tokens:
        pt = _patches(cfg, 4, 5)
        jextra, textra = {"patches": jnp.asarray(pt)}, \
            {"patches": torch.from_numpy(pt)}
    want = JServeEngine(jm, jp, max_seq=max_seq).generate(
        jnp.asarray(prompts, jnp.int32), steps=12, extra_batch=jextra)
    eng = ServeEngine(model, max_seq=max_seq)
    got = eng.generate(torch.from_numpy(prompts), steps=12,
                       extra_batch=textra)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(eng.timing["decode_ms"]) == 12


def test_a_patches_model_needs_its_patches():
    """The JAX engine decodes a patches model from ``S_prompt +
    n_frontend_tokens`` even when no patches were passed, past the
    positions its prefill filled; the port raises instead, naming them, and
    checks their shape."""
    model = params_from_jax(
        configs.get_config("paligemma-3b").smoke(),
        jax.tree.map(np.asarray, JModel(jconfigs.get_config(
            "paligemma-3b").smoke()).init(jax.random.PRNGKey(0))),
        device="cpu")
    eng = ServeEngine(model, max_seq=40)
    prompts = torch.zeros((2, 5), dtype=torch.int64)
    with pytest.raises(ValueError, match="patches"):
        eng.generate(prompts, steps=3)
    with pytest.raises(ValueError, match="patches must be"):
        eng.generate(prompts, steps=3, extra_batch={
            "patches": torch.zeros((2, 7, model.cfg.d_model))})
    with pytest.raises(ValueError, match="exceed max_seq"):
        eng.generate(prompts, steps=30, extra_batch={
            "patches": torch.zeros((2, 8, model.cfg.d_model))})
    out = eng.generate(prompts, steps=3, extra_batch={
        "patches": torch.zeros((2, 8, model.cfg.d_model))})
    assert out.shape == (2, 3)
