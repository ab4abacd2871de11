"""The port's configs, layers and blocks (``repro_torch.configs`` and
``repro_torch.models``) against the JAX package's (``repro.configs`` and
``repro.models``) at ``.smoke()`` widths, on the CPU.

Block parameters are the JAX package's own initialisation plus seeded numpy
noise (so that biases, norms, ``A_log`` and ``D`` are not at their all-zero
or all-one starting values), carried over as numpy arrays.  float32
throughout; atol 1e-5 on activations of order one: only the order of the
float sums differs (the JAX attention streams 32-key chunks, the port's plain
attention does not).
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
import repro.models.layers as jlayers
from repro_torch import configs
from repro_torch.interop import params_from_jax
from repro_torch.models import Model
from repro_torch.models import blocks, layers

ATOL = 1e-5


def _noisy(tree, seed, scale=0.1):
    """The JAX parameter pytree as numpy arrays plus N(0, scale²) noise."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + scale * rng.standard_normal(
        np.shape(a))).astype(np.asarray(a).dtype), tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)


# --------------------------------------------------------------------------- #
# configs                                                                      #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_config_copies_equal_the_jax_package(name):
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    j, t = jconfigs.get_config(name), configs.get_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.smoke()) == dataclasses.asdict(j.smoke())
    t, j = t.smoke(), j.smoke()
    assert (t.head_dim, t.d_inner, t.ssm_heads) == (j.head_dim, j.d_inner,
                                                    j.ssm_heads)


SERVED = {"qwen2-1.5b", "qwen2.5-3b", "yi-6b", "qwen3-14b", "mamba2-130m",
          "recurrentgemma-2b"}


@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_model_serves_dense_and_ssm_and_raises_for_the_rest(name):
    cfg = configs.get_config(name).smoke()
    if name in SERVED:
        m = Model(cfg, device="cpu")
        assert len(m.layers) == cfg.n_layers
    else:
        with pytest.raises(NotImplementedError, match="queue 1 item 10|"
                                                      "encoder-only"):
            Model(cfg, device="cpu")


def test_training_is_outside_the_slice():
    m = Model(configs.get_config("qwen2-1.5b").smoke(), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        m.loss({"tokens": torch.zeros((1, 4), dtype=torch.int64)})


# --------------------------------------------------------------------------- #
# layers                                                                       #
# --------------------------------------------------------------------------- #

def test_rmsnorm_and_rope_match():
    x, w = _x(0, 2, 5, 3, 16), _x(1, 16)
    _close(layers.rmsnorm(*map(torch.from_numpy, (x, w)), 1e-6),
           jlayers.rmsnorm(x, w, 1e-6))
    pos = np.arange(7, 12)
    _close(layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           jlayers.rope(x, jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches(act):
    p = _noisy(jlayers.mlp_params(jax.random.PRNGKey(0), 16, 24, act,
                                  jnp.float32), 1)
    x = _x(2, 2, 5, 16)
    _close(layers.mlp(torch.from_numpy(x), _torch(p), act),
           jlayers.mlp(x, p, act))


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, q_offset=6, kv_valid=9)],
                         ids=str)
def test_attention_matches(kw):
    q, k, v = _x(0, 2, 3, 4, 16), _x(1, 2, 12, 2, 16), _x(2, 2, 12, 2, 16)
    for chunk in (0, 4):
        _close(layers.attention(*map(torch.from_numpy, (q, k, v)), **kw),
               jlayers.attention(q, k, v, chunk=chunk, **kw))


@pytest.mark.parametrize("kw, what", [(dict(window=4), "local_window"),
                                      (dict(prefix=2), "prefix")])
def test_attention_knobs_outside_the_slice_raise(kw, what):
    """``prefix`` (the patches frontend) is outside the slice and raises;
    ``window`` (recurrentgemma's local attention) came with the hybrid
    family and now matches the JAX attention."""
    if what == "prefix":
        q = torch.zeros((1, 3, 2, 16))
        with pytest.raises(NotImplementedError, match=what):
            layers.attention(q, q, q, **kw)
        return
    q, k, v = _x(0, 2, 9, 4, 16), _x(1, 2, 9, 2, 16), _x(2, 2, 9, 2, 16)
    for chunk in (0, 4):
        _close(layers.attention(*map(torch.from_numpy, (q, k, v)), **kw),
               jlayers.attention(q, k, v, chunk=chunk, **kw))


# --------------------------------------------------------------------------- #
# blocks                                                                       #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-14b"])
def test_attn_block_prefill_and_decode_match(arch):
    """attn_apply without a cache, then with one: a 7-token prefill and three
    decode steps; outputs and the cache contents match the JAX block."""
    jcfg = jconfigs.get_config(arch).smoke()
    cfg = configs.get_config(arch).smoke()
    p = _noisy(jblocks.attn_params(jax.random.PRNGKey(0), jcfg), 1)
    tp = _torch(p)
    b, s, max_seq = 2, 7, 12
    x = _x(3, b, s, cfg.d_model)
    out, _ = blocks.attn_apply(cfg, tp, torch.from_numpy(x))
    want, _ = jblocks.attn_apply(jcfg, p, x)
    _close(out, want)

    jc = jblocks.attn_cache(jcfg, b, max_seq)
    tc = blocks.attn_cache(cfg, b, max_seq, "cpu")
    want, jc = jblocks.attn_apply(jcfg, p, x, cache=jc, cache_pos=0)
    out, tc = blocks.attn_apply(cfg, tp, torch.from_numpy(x), cache=tc,
                                cache_pos=0)
    _close(out, want)
    for pos in range(s, s + 3):
        x1 = _x(pos, b, 1, cfg.d_model)
        want, jc = jblocks.attn_apply(jcfg, p, x1, cache=jc,
                                      cache_pos=jnp.int32(pos))
        out, tc = blocks.attn_apply(cfg, tp, torch.from_numpy(x1), cache=tc,
                                    cache_pos=pos)
        _close(out, want)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_attn_cache_overflow_raises():
    cfg = configs.get_config("qwen2-1.5b").smoke()
    p = _torch(_noisy(jblocks.attn_params(
        jax.random.PRNGKey(0), jconfigs.get_config("qwen2-1.5b").smoke()), 1))
    cache = blocks.attn_cache(cfg, 1, 4, "cpu")
    with pytest.raises(ValueError, match="cannot take"):
        blocks.attn_apply(cfg, p, torch.zeros((1, 3, cfg.d_model)),
                          cache=cache, cache_pos=2)


def test_mamba_block_prefill_and_decode_match():
    """mamba_apply without a cache, then a 9-token prefill (the SSD scan)
    and three decode steps (the single-step recurrence); outputs, the SSM
    state and the conv window match the JAX block."""
    jcfg = jconfigs.get_config("mamba2-130m").smoke()
    cfg = configs.get_config("mamba2-130m").smoke()
    p = _noisy(jblocks.mamba_params(jax.random.PRNGKey(0), jcfg), 1)
    tp = _torch(p)
    b, s = 2, 9
    x = _x(3, b, s, cfg.d_model)
    out, _ = blocks.mamba_apply(cfg, tp, torch.from_numpy(x))
    want, _ = jblocks.mamba_apply(jcfg, p, x)
    _close(out, want)

    jc = jblocks.mamba_cache(jcfg, b)
    tc = blocks.mamba_cache(cfg, b, "cpu")
    want, jc = jblocks.mamba_apply(jcfg, p, x, cache=jc, cache_pos=0)
    out, tc = blocks.mamba_apply(cfg, tp, torch.from_numpy(x), cache=tc,
                                 cache_pos=0)
    _close(out, want)
    _close(tc["ssm"], jc["ssm"])
    _close(tc["conv"], jc["conv"])
    for pos in range(s, s + 3):
        x1 = _x(pos, b, 1, cfg.d_model)
        want, jc = jblocks.mamba_apply(jcfg, p, x1, cache=jc,
                                       cache_pos=jnp.int32(pos))
        out, tc = blocks.mamba_apply(cfg, tp, torch.from_numpy(x1), cache=tc,
                                     cache_pos=pos)
        _close(out, want)
    _close(tc["ssm"], jc["ssm"])
    _close(tc["conv"], jc["conv"])


def test_rglru_block_prefill_and_decode_match():
    """rglru_apply without a cache, then a 9-token prefill (the LRU scan) and
    three decode steps (the single-step recurrence and the cached 3-row conv
    window); outputs, the state ``h`` and the conv window match the JAX
    block."""
    jcfg = jconfigs.get_config("recurrentgemma-2b").smoke()
    cfg = configs.get_config("recurrentgemma-2b").smoke()
    p = _noisy(jblocks.rglru_params(jax.random.PRNGKey(0), jcfg), 1)
    tp = _torch(p)
    b, s = 2, 9
    x = _x(3, b, s, cfg.d_model)
    out, _ = blocks.rglru_apply(cfg, tp, torch.from_numpy(x))
    want, _ = jblocks.rglru_apply(jcfg, p, x)
    _close(out, want)

    jc = jblocks.rglru_cache(jcfg, b)
    tc = blocks.rglru_cache(cfg, b, "cpu")
    want, jc = jblocks.rglru_apply(jcfg, p, x, cache=jc, cache_pos=0)
    out, tc = blocks.rglru_apply(cfg, tp, torch.from_numpy(x), cache=tc,
                                 cache_pos=0)
    _close(out, want)
    _close(tc["h"], jc["h"])
    _close(tc["conv"], jc["conv"])
    for pos in range(s, s + 3):
        x1 = _x(pos, b, 1, cfg.d_model)
        want, jc = jblocks.rglru_apply(jcfg, p, x1, cache=jc,
                                       cache_pos=jnp.int32(pos))
        out, tc = blocks.rglru_apply(cfg, tp, torch.from_numpy(x1), cache=tc,
                                     cache_pos=pos)
        _close(out, want)
    _close(tc["h"], jc["h"])
    _close(tc["conv"], jc["conv"])


def test_hybrid_layers_follow_the_jax_groups():
    """recurrentgemma-2b's 26 layers: 8 (rec, rec, attn) groups, then the 2
    rec layers of the JAX ``extra`` stack."""
    from repro_torch.models.model import layer_kinds
    kinds = layer_kinds(configs.get_config("recurrentgemma-2b"))
    assert kinds == ["rec", "rec", "attn"] * 8 + ["rec", "rec"]
    smoke = layer_kinds(configs.get_config("recurrentgemma-2b").smoke())
    assert smoke == ["rec", "rec", "attn", "rec"]
    assert layer_kinds(configs.get_config("qwen2-1.5b").smoke()) == ["attn"] * 2


def test_hybrid_model_prefill_and_decode_past_the_window_match():
    """The hybrid smoke model (one (rec, rec, attn) group and one extra rec
    layer, window 16) against ``repro.models.Model`` with the same
    parameters: the 21-token prefill's logits and every decode step's up to
    position 39, past the window, within 1e-5.  Noise of 0.1 on the
    parameters: ``sqrt(1 - a²)`` cancels as the gate ``a`` nears 1, so a
    larger noise turns the two sides' fp32 rounding into 1e-4."""
    from repro.models import Model as JModel
    arch = "recurrentgemma-2b"
    jcfg = jconfigs.get_config(arch).smoke()
    cfg = configs.get_config(arch).smoke()
    jm = JModel(jcfg)
    tree = _noisy(jm.init(jax.random.PRNGKey(0)), 2)
    model = params_from_jax(cfg, tree, device="cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (3, 21))
    max_seq = 40
    jc, tc = jm.init_cache(3, max_seq), model.init_cache(3, max_seq)
    jl, jc = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(prompts, jnp.int32)}, jc)
    tl, tc = model.prefill({"tokens": torch.from_numpy(prompts)}, tc)
    _close(tl, jl)
    decode = jax.jit(jm.decode)
    tok = np.asarray(jl)[:, -1].argmax(-1)[:, None]
    for pos in range(prompts.shape[1], max_seq):
        jl, jc = decode(jp, jnp.asarray(tok, jnp.int32), jnp.int32(pos), jc)
        tl, tc = model.decode(torch.from_numpy(tok), pos, tc)
        _close(tl, jl)
        tok = np.asarray(jl)[:, -1].argmax(-1)[:, None]


# --------------------------------------------------------------------------- #
# carrying parameters over                                                     #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-130m",
                                  "recurrentgemma-2b"])
def test_params_from_jax_unstacks_layers_bit_for_bit(arch):
    """The JAX tree (stacked [L, ...] layers, bfloat16 here) lands in the
    port's per-layer parameters with the same bits; a hybrid tree's groups
    and extra rec layers land in the order the JAX model runs them."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch).smoke(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_config(arch).smoke(),
                              dtype="bfloat16")
    from repro.models import Model as JModel
    tree = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(0)))
    m = params_from_jax(cfg, tree, device="cpu")
    assert m.top["embed"].dtype == torch.bfloat16

    def bits(t):
        return t.view(torch.int16).numpy()

    np.testing.assert_array_equal(bits(m.top["embed"]),
                                  tree["embed"].view(np.int16))
    if cfg.family == "hybrid":
        n_grp = cfg.n_layers // len(cfg.block_pattern)
        where = [(tree["layers"][f"b{j}"], g) for g in range(n_grp)
                 for j in range(len(cfg.block_pattern))]
        where += [(tree["extra"], e) for e in range(cfg.n_layers - 3 * n_grp)]
    else:
        where = [(tree["layers"], i) for i in range(cfg.n_layers)]
    leaf = {"mamba": "in_proj", "attn": "wq", "rec": "in_x"}
    for layer, (stack, i) in zip(m.layers, where, strict=True):
        name = next(n for n in leaf if n in layer)
        assert name in stack
        np.testing.assert_array_equal(bits(layer[name][leaf[name]]),
                                      stack[name][leaf[name]][i].view(
                                          np.int16))
    short = dataclasses.replace(cfg, n_layers=cfg.n_layers + 1)
    with pytest.raises(ValueError, match="stacks"):
        params_from_jax(short, tree, device="cpu")
