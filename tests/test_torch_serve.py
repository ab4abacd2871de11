"""The port's serving path (``repro_torch.models.Model``, ``ServeEngine``,
``launch.serve``) against the JAX package's (``repro.models.Model``,
``repro.serve.ServeEngine``) at ``.smoke()`` widths, on the CPU.

Both sides run the same parameters: the JAX package's initialisation plus
seeded numpy noise (0.5, or 0.1 for recurrentgemma, whose ``sqrt(1 - a²)``
cancels as its gate ``a`` nears 1 and turns a larger noise's fp32 rounding
into 1e-4 of the logits), carried over with ``params_from_jax``.  The prefill's
and every decode step's logits agree within rtol 1e-4 and atol 1e-4 in
float32 (the two attentions sum in another order), and greedy decoding gives
the same tokens.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _jax_ref  # noqa: F401  (jax 0.9 shim before the JAX package)
import jax
import jax.numpy as jnp

import repro.configs as jconfigs
from repro.models import Model as JModel
from repro.serve import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model
from repro_torch.serve import ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["qwen2-1.5b", "mamba2-130m", "qwen3-14b", "recurrentgemma-2b"]
NOISE = {"recurrentgemma-2b": 0.1}


def _pair(arch, seed=0):
    """(JAX model, its noisy params as jnp arrays, the port's model holding
    the same params on the CPU)."""
    jcfg = jconfigs.get_config(arch).smoke()
    jm = JModel(jcfg)
    rng = np.random.default_rng(seed)
    scale = NOISE.get(arch, 0.5)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))
                   ).astype(np.asarray(a).dtype),
        jm.init(jax.random.PRNGKey(seed)))
    model = params_from_jax(configs.get_config(arch).smoke(), tree,
                            device="cpu")
    return jm, jax.tree.map(jnp.asarray, tree), model


def _prompts(seed, vocab, b=3, s=13):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_every_decode_step_match(arch):
    jm, jp, model = _pair(arch)
    prompts = _prompts(1, model.cfg.vocab)
    max_seq = 24
    jc = jm.init_cache(prompts.shape[0], max_seq)
    tc = model.init_cache(prompts.shape[0], max_seq)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompts,
                                                           jnp.int32)}, jc)
    tl, tc = model.prefill({"tokens": torch.from_numpy(prompts)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    decode = jax.jit(jm.decode)
    tok = np.asarray(jl)[:, -1].argmax(-1)[:, None]
    for pos in range(prompts.shape[1], max_seq):
        jl, jc = decode(jp, jnp.asarray(tok, jnp.int32), jnp.int32(pos), jc)
        tl, tc = model.decode(torch.from_numpy(tok), pos, tc)
        assert tl.shape == (prompts.shape[0], 1, model.cfg.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jl)[:, -1].argmax(-1)[:, None]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_the_jax_engine(arch):
    jm, jp, model = _pair(arch, seed=3)
    prompts = _prompts(4, model.cfg.vocab, b=4, s=9)
    want = JServeEngine(jm, jp, max_seq=32).generate(
        jnp.asarray(prompts, jnp.int32), steps=12)
    eng = ServeEngine(model, max_seq=32)
    got = eng.generate(torch.from_numpy(prompts), steps=12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(eng.timing["decode_ms"]) == 12 and eng.timing["prefill_ms"] > 0


def test_sampling_is_seeded_and_in_range():
    model = Model(configs.get_config("mamba2-130m").smoke(), device="cpu")
    eng = ServeEngine(model, max_seq=20)
    prompts = torch.from_numpy(_prompts(0, model.cfg.vocab, b=2, s=5))
    runs = [eng.generate(prompts, steps=8, temperature=0.8,
                         generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (2, 8)
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < model.cfg.vocab
    with pytest.raises(ValueError, match="exceed max_seq"):
        eng.generate(prompts, steps=16)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-130m",
                                  "recurrentgemma-2b"])
def test_launch_serve_runs_on_the_cpu(arch, capsys):
    # recurrentgemma's prompt runs past its smoke window of 16.
    prompt = 20 if arch == "recurrentgemma-2b" else 6
    out = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--requests", "2", "--prompt-len", str(prompt),
                             "--gen-len", "4"])
    assert out.shape == (2, 4)
    text = capsys.readouterr().out
    assert "prefill" in text and "ms/step" in text and "tok/s" in text


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("qwen2-1.5b").smoke()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--arch", "mamba2-130m", "--smoke"])
    tree = jax.tree.map(np.asarray, JModel(jconfigs.get_config(
        "qwen2-1.5b").smoke()).init(jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(cfg, tree)
    assert Model(cfg, device="cpu").device.type == "cpu"
