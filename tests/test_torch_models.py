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
          "recurrentgemma-2b", "kimi-k2-1t-a32b", "arctic-480b",
          "paligemma-3b"}


@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_model_serves_dense_and_ssm_and_raises_for_the_rest(name):
    """Every model builds; every decoder of the JAX package is served, and
    serving encoder-only hubert (the frames frontend, no decode step)
    raises, as ``repro/launch/serve.py`` refuses it."""
    cfg = configs.get_config(name).smoke()
    m = Model(cfg, device="cpu")
    assert len(m.layers) == cfg.n_layers
    if name in SERVED:
        assert m.init_cache(1, 8)["layers"]
    else:
        with pytest.raises(NotImplementedError, match="encoder-only"):
            m.init_cache(1, 8)


def test_training_is_outside_the_slice():
    """Training runs for every family whose forward uses kernel 5 alone
    (hubert's frames included: ``tests/test_torch_train.py``); the ssm and
    hybrid families, whose scans have no backward kernel yet, raise naming
    ROADMAP.md queue 1 item 11."""
    for name in ("qwen2-1.5b", "hubert-xlarge"):
        cfg = configs.get_config(name).smoke()
        batch = ({"frames": torch.zeros((1, 4, cfg.d_model)),
                  "labels": torch.zeros((1, 4), dtype=torch.int64)}
                 if cfg.frontend == "frames" else
                 {"tokens": torch.zeros((1, 4), dtype=torch.int64)})
        loss, aux = Model(cfg, device="cpu").loss(batch)
        assert torch.isfinite(loss) and set(aux) == {"ce", "aux"}
    for name in ("mamba2-130m", "recurrentgemma-2b"):
        m = Model(configs.get_config(name).smoke(), device="cpu")
        with pytest.raises(NotImplementedError, match="queue 1 item 11"):
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
    """Both knobs once outside the slice now match the JAX attention:
    ``window`` (recurrentgemma's local attention, with the hybrid family)
    and ``prefix`` (the patches frontend's prefix-LM mask, with the vlm
    family)."""
    q, k, v = _x(0, 2, 9, 4, 16), _x(1, 2, 9, 2, 16), _x(2, 2, 9, 2, 16)
    for chunk in (0, 4):
        _close(layers.attention(*map(torch.from_numpy, (q, k, v)), **kw),
               jlayers.attention(q, k, v, chunk=chunk, **kw))


@pytest.mark.parametrize("kw", [
    dict(prefix=1), dict(prefix=5), dict(prefix=9), dict(prefix=20),
    dict(prefix=5, window=3), dict(prefix=5, causal=False),
    dict(prefix=6, q_offset=6, kv_valid=9),
    dict(prefix=8, q_offset=2, kv_valid=11, window=4)], ids=str)
def test_attention_with_a_prefix_matches_the_jax_attention(kw):
    """The prefix-LM mask ``(k <= q) | (k < prefix)`` under ``causal``: a
    prefix of one key, inside the keys, all of them and past them; with a
    window (applied after it), without ``causal`` (no effect), and at a
    decode-like ``q_offset`` with ``kv_valid``."""
    sk = 11
    q, k, v = _x(3, 2, 11 - kw.get("q_offset", 0), 4, 16), _x(4, 2, sk, 2, 16), \
        _x(5, 2, sk, 2, 16)
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


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "arctic-480b",
                                  "paligemma-3b"])
def test_init_params_have_the_jax_trees_shapes(arch):
    """The port's random init has the JAX ``Model.init`` tree's shapes and
    dtypes, layer for layer: kimi's leading dense layer (JAX's ``dense0``)
    with the MLP width ``moe_dense_d_ff`` (96 here, not ``d_ff``), the MoE
    layers' experts, shared expert, dense residual and float32 router."""
    from repro.models import Model as JModel
    from repro_torch.models.model import init_params
    kw = dict(dtype="bfloat16")
    if arch == "kimi-k2-1t-a32b":
        kw["moe_dense_d_ff"] = 96
    jcfg = dataclasses.replace(jconfigs.get_config(arch).smoke(), **kw)
    cfg = dataclasses.replace(configs.get_config(arch).smoke(), **kw)
    tree = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    got = init_params(cfg, torch.Generator().manual_seed(0))
    stacks = ([(tree["dense0"], i) for i in range(cfg.first_dense_layers)]
              + [(tree["layers"], i)
                 for i in range(cfg.n_layers - cfg.first_dense_layers)])

    def shapes(t, one=None):
        if isinstance(t, dict):
            return {k: shapes(v, one) for k, v in t.items()}
        if isinstance(t, torch.Tensor):
            return tuple(t.shape), str(t.dtype).split(".")[-1]
        return tuple(t.shape[1:] if one else t.shape), str(t.dtype)

    assert len(got["layers"]) == len(stacks)
    for layer, (stack, _) in zip(got["layers"], stacks):
        assert shapes(layer) == shapes(stack, one=True)
    top = {k: v for k, v in tree.items() if k not in ("layers", "dense0")}
    assert shapes({k: v for k, v in got.items() if k != "layers"}) == \
        shapes(top)
    if arch == "kimi-k2-1t-a32b":
        assert got["layers"][0]["mlp"]["w_in"].shape == (cfg.d_model, 2, 96)


def test_hybrid_layers_follow_the_jax_groups():
    """recurrentgemma-2b's 26 layers: 8 (rec, rec, attn) groups, then the 2
    rec layers of the JAX ``extra`` stack."""
    from repro_torch.models.model import layer_kinds
    kinds = layer_kinds(configs.get_config("recurrentgemma-2b"))
    assert kinds == ["rec", "rec", "attn"] * 8 + ["rec", "rec"]
    smoke = layer_kinds(configs.get_config("recurrentgemma-2b").smoke())
    assert smoke == ["rec", "rec", "attn", "rec"]
    assert layer_kinds(configs.get_config("qwen2-1.5b").smoke()) == ["attn"] * 2
    assert layer_kinds(configs.get_config("kimi-k2-1t-a32b")) == \
        ["attn"] + ["moe"] * 60
    assert layer_kinds(configs.get_config("arctic-480b").smoke()) == \
        ["moe"] * 2
    assert layer_kinds(configs.get_config("paligemma-3b")) == ["attn"] * 18


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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "arctic-480b"])
def test_params_from_jax_carries_dense0_and_the_moe_stack_bit_for_bit(
        arch, dtype):
    """An MoE tree: ``dense0`` (kimi's leading dense layer) becomes the
    first layers and the MoE stack follows; every expert array, the shared
    expert, the dense residual and the router (float32 in a bfloat16
    model) carry over with the same bits."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch).smoke(), dtype=dtype)
    cfg = dataclasses.replace(configs.get_config(arch).smoke(), dtype=dtype)
    from repro.models import Model as JModel
    tree = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(1)))
    m = params_from_jax(cfg, tree, device="cpu")

    def bits(a):
        a = a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32
                   ) if isinstance(a, torch.Tensor) else a
        return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else
                          a.view(np.int16 if a.dtype.itemsize == 2
                                 else np.int32))

    n_dense = cfg.first_dense_layers
    assert ("dense0" in tree) == bool(n_dense)
    for i in range(n_dense):
        layer = m.layers[i]
        assert "moe" not in layer
        for name in ("w_in", "w_out"):
            np.testing.assert_array_equal(
                bits(layer["mlp"][name]), bits(tree["dense0"]["mlp"][name][i]))
    for i in range(cfg.n_layers - n_dense):
        layer, jl = m.layers[n_dense + i]["moe"], tree["layers"]["moe"]
        assert layer["router"].dtype == torch.float32
        for name in ("router", "w_in", "w_out"):
            np.testing.assert_array_equal(bits(layer[name]),
                                          bits(jl[name][i]), err_msg=name)
        for part in ("shared", "dense"):
            assert (part in layer) == (part in jl)
            if part in jl:
                np.testing.assert_array_equal(bits(layer[part]["w_in"]),
                                              bits(jl[part]["w_in"][i]))
