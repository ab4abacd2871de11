"""The port's training path (``Model.loss``, ``repro_torch.train``,
``repro_torch.launch.train``, ``interop.train_state_from_jax``) against the
JAX package's (``repro.models.Model.loss``, ``repro.train``), on the CPU at
``.smoke()`` widths.

Parameters are the JAX package's initialisation plus seeded numpy noise,
carried over with ``train_state_from_jax``; batches are numpy arrays from
seeds given to both packages; float32 throughout.  On the CPU the attention
takes its plain version and the plain backward (``attend_backward_plain``),
against XLA's autodiff of the JAX model's chunked attention (``attn_chunk``
32 with 40 positions, so its KV chunks and their ``jax.checkpoint`` run).
Tolerances:

- the loss, ce and aux within 1e-5 relative: float32 sums in other orders;
- every gradient leaf within 1e-5 of its largest element (measured: below
  3e-6 for every leaf of the five models);
- three free-running train steps: the losses within 1e-5 relative, gnorm
  within 1e-5 (1e-4 with ``grad_compress``), every parameter and moment
  leaf within 1e-5 of its largest element, or 1e-2 with ``grad_compress``
  (a gradient element on an int8 rounding boundary moves by a whole unit,
  1/127 of its block's largest, which the moments carry) and for qwen2,
  whose key bias gets gradients of rounding noise (the softmax is blind to
  it) that Adam's normalisation turns into steps of either sign, 1e-4;
- with ``quantize_moments`` each step starts from the JAX package's state:
  an int8 moment whose value sits on a rounding boundary flips by an ulp of
  the gradient, and an element whose v then quantizes to 0 in one package
  only steps by m/eps there, so free-running runs part after a step.  Held:
  the losses within 1e-5, at least 99.5 % of the int8 moments equal, and at
  least 99.9 % of the parameter elements within 1e-5 of their leaf's
  largest element (the bit-for-bit AdamW is ``tests/test_torch_optim.py``);
- three free-running steps with ``accum_dtype="bfloat16"`` (two
  microbatches summed into a bf16 accumulator, where the packages' sums
  part by up to one bf16 ulp, 2^-8 of the accumulated gradient): the losses
  and gnorm within 1e-5 relative, every ``m`` leaf within one bf16 ulp
  (2^-8) of its largest element and every ``v`` leaf within two (2^-7: it
  is a square of the gradient), the parameters within 1e-4 (each Adam step
  moves them by the moments' ratio times lr; measured: ``m`` 3.0e-3, ``v``
  4.3e-3, parameters 1.3e-5).
"""

from __future__ import annotations

import dataclasses
import re
import threading

import numpy as np
import pytest
import torch

import _jax_ref  # noqa: F401  (jax 0.9 shim before the JAX package)
import jax
import jax.numpy as jnp

import repro.configs as jconfigs
from repro.models import Model as JModel
from repro.optim import OptConfig as JOptConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.interop import (params_from_jax, train_state_from_jax,
                                 train_state_to_numpy)
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.optim import OptConfig
from repro_torch.train import (TrainConfig, TrainState, init_train_state,
                               load_train_state_, make_train_step)
from repro_torch.tree import leaves, map_tree

RTOL = 1e-5
GRAD_TOL = 1e-5
TRAINED = ["hubert-xlarge", "qwen2-1.5b", "paligemma-3b", "kimi-k2-1t-a32b",
           "arctic-480b", "qwen2.5-3b", "yi-6b", "qwen3-14b", "mamba2-130m",
           "recurrentgemma-2b"]
# bf16 gradient accumulation (module docstring): m within one bf16 ulp, v
# within two, the parameters within 1e-4 of each leaf's largest element.
ACCUM_BF16_TOL = {"m": 2**-8, "v": 2**-7, "params": 1e-4}


def _cfgs(arch, **kw):
    """(the JAX package's smoke config, the port's), both with ``kw``."""
    return (dataclasses.replace(jconfigs.get_config(arch).smoke(), **kw),
            dataclasses.replace(configs.get_config(arch).smoke(), **kw))


def _noisy(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + scale * rng.standard_normal(
        np.shape(a))).astype(np.asarray(a).dtype), tree)


def _batch(cfg, b, s, seed):
    """A numpy training batch of ``s`` positions: frames and labels, or
    tokens (after patch embeddings for the patches frontend)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "frames":
        return {"frames": rng.standard_normal((b, s, cfg.d_model),
                                              dtype=np.float32),
                "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "patches":
        out["patches"] = rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(model, batch):
    """(loss, metrics, gradients in the JAX layout as numpy arrays) of the
    port's model, zeros for leaves the loss does not reach."""
    params = model.params()
    flat = list(leaves(params))
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = model.loss(batch)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(flat, got)])
    grads = map_tree(lambda _: next(it), params)
    state = TrainState(grads, {"step": torch.zeros(()), "m": grads,
                               "v": grads}, None)
    return loss, metrics, train_state_to_numpy(model.cfg, state)["params"]


def _leaves_close(got, want, tol, what=""):
    """Every leaf of ``got`` within ``tol`` of the largest element of the
    matching leaf of ``want`` (same structure, JAX layout)."""
    gl = jax.tree.leaves(got)
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(gl) == len(wl)
    for g, (path, w) in zip(gl, wl):
        w = np.asarray(w, dtype=np.float64)
        assert np.shape(g) == w.shape, (jax.tree_util.keystr(path))
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(np.asarray(g, dtype=np.float64) - w).max() / scale
        assert err <= tol, f"{what}{jax.tree_util.keystr(path)}: {err}"


@pytest.mark.parametrize("arch, kw", [(a, {}) for a in TRAINED] + [
    ("kimi-k2-1t-a32b", dict(capacity_factor=0.25))])
def test_loss_and_every_gradient_match_jax_value_and_grad(arch, kw):
    """``Model.loss`` (loss, ce, aux) and the gradient of every parameter
    leaf against ``jax.value_and_grad(model.loss)``: hubert's frames and
    labels, qwen2's shifted tokens, paligemma's text after its patches, the
    MoE models' aux loss at 1e-2 (kimi also at capacity factor 0.25, where
    most entries are dropped and JAX's duplicate scatter sends the gradient
    to the winning write only)."""
    jcfg, tcfg = _cfgs(arch, **kw)
    jm = JModel(jcfg)
    params = _noisy(jm.init(jax.random.PRNGKey(0)), 1)
    batch = _batch(jcfg, 2, 40, 2)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(params, batch)
    model = params_from_jax(tcfg, params, device="cpu")
    loss, met, tg = _grads(model, _t(batch))
    for got, want in ((loss, jl), (met["ce"], jmet["ce"]),
                      (met["aux"], jmet["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=RTOL)
    if tcfg.is_moe:
        assert float(met["aux"]) > 0
    _leaves_close(tg, jax.tree.map(np.asarray, jg), GRAD_TOL)


def test_a_frames_model_gets_zero_embed_gradients_and_decays_them():
    """hubert never reads ``embed``: its gradient is zeros (as ``jax.grad``
    gives it) and a train step still decays it by AdamW's weight decay."""
    _, tcfg = _cfgs("hubert-xlarge")
    model = Model(tcfg, device="cpu", seed=0)
    _, _, grads = _grads(model, _t(_batch(tcfg, 2, 40, 3)))
    assert not np.asarray(grads["embed"]).any()
    assert np.asarray(grads["frontend_proj"]).any()
    tc = TrainConfig(warmup_steps=1, total_steps=10)
    state = init_train_state(model.params(), tc)
    before = model.top["embed"].detach().clone()
    step = make_train_step(model, tc)
    for i in range(2):
        state, m = step(state, _t(_batch(tcfg, 2, 40, 4 + i)))
    lr = float(m["lr"])
    want = before * (1 - lr * tc.opt.weight_decay)
    torch.testing.assert_close(model.top["embed"].detach(), want, rtol=1e-6,
                               atol=0)


def _run_both(arch, jt, tt, steps, resync=False, b=4):
    """``steps`` train steps of both packages from the same state and
    batches; yields (JAX state as numpy, JAX metrics, port state in the JAX
    layout, port metrics) after each.  With ``resync`` each port step starts
    from the JAX package's state."""
    jcfg, tcfg = _cfgs(arch)
    jm = JModel(jcfg)
    jstate = j_init_state(_noisy(jm.init(jax.random.PRNGKey(0)), 1), jt)
    jstep = jax.jit(j_make_step(jm, jt))
    model, tstate = train_state_from_jax(
        tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    tstep = make_train_step(model, tt)
    for i in range(steps):
        if resync and i:
            model, tstate = train_state_from_jax(
                tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
            tstep = make_train_step(model, tt)
        batch = _batch(jcfg, b, 40, 10 + i)
        jstate, jmet = jstep(jstate, batch)
        tstate, tmet = tstep(tstate, _t(batch))
        yield (jax.tree.map(np.asarray, jstate), jmet,
               train_state_to_numpy(tcfg, tstate), tmet)


def _configs(nmb, compress, quantize):
    kw = dict(microbatches=nmb, warmup_steps=1, total_steps=10,
              grad_compress=compress)
    return (JTrainConfig(opt=JOptConfig(quantize_moments=quantize, block=64),
                         **kw),
            TrainConfig(opt=OptConfig(quantize_moments=quantize, block=64),
                        **kw))


@pytest.mark.parametrize("arch, nmb, compress", [
    ("hubert-xlarge", 1, False), ("hubert-xlarge", 2, False),
    ("hubert-xlarge", 1, True), ("hubert-xlarge", 2, True),
    ("qwen2-1.5b", 2, False), ("kimi-k2-1t-a32b", 1, False),
    ("mamba2-130m", 1, False), ("recurrentgemma-2b", 2, False)])
def test_three_train_steps_match_jax(arch, nmb, compress):
    """Three free-running steps of ``make_train_step`` against
    ``jax.jit(make_train_step)``: microbatches 1 and 2, ``grad_compress``
    off and on (its residuals ``ef`` too), float32 moments.  Step 1's lr is
    0 (the cosine schedule at step 0), so two steps move the parameters."""
    jt, tt = _configs(nmb, compress, False)
    tol = 1e-2 if compress else (1e-4 if arch == "qwen2-1.5b" else GRAD_TOL)
    for i, (js, jmet, ts, tmet) in enumerate(_run_both(arch, jt, tt, 3)):
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tmet["gnorm"]), float(jmet["gnorm"]),
                                   rtol=1e-4 if compress else RTOL)
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                                   rtol=1e-6)
    assert float(jmet["lr"]) > 0
    assert int(ts["opt"]["step"]) == int(js.opt["step"]) == 3
    _leaves_close(ts["params"], js.params, tol, "params")
    _leaves_close(ts["opt"]["m"], js.opt["m"], tol, "m")
    _leaves_close(ts["opt"]["v"], js.opt["v"], tol, "v")
    if compress:
        # A residual is below half a unit (1/127 of its block's largest
        # gradient, about twice the leaf's largest residual): elsewhere it
        # carries the gradients' float differences (1e-5 of 127 units), and
        # where a rounding flips it moves by a whole unit.
        for a, b in zip(jax.tree.leaves(ts["ef"]), jax.tree.leaves(js.ef)):
            unit = 2 * np.abs(b).max()
            diff = np.abs(a - b)
            assert diff.max() <= 1.01 * unit
            assert (diff > 2e-3 * unit).mean() <= 0.01
    else:
        assert ts["ef"] is None and js.ef is None


@pytest.mark.parametrize("arch", ["hubert-xlarge", "kimi-k2-1t-a32b"])
def test_train_steps_with_bf16_accumulation_match_jax(arch):
    """Three free-running steps with two microbatches summed in a bf16
    accumulator (``accum_dtype="bfloat16"``) against
    ``jax.jit(make_train_step)``, within ``ACCUM_BF16_TOL``."""
    kw = dict(microbatches=2, warmup_steps=1, total_steps=10,
              accum_dtype="bfloat16")
    for js, jmet, ts, tmet in _run_both(arch, JTrainConfig(**kw),
                                        TrainConfig(**kw), 3):
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tmet["gnorm"]), float(jmet["gnorm"]),
                                   rtol=RTOL)
    assert int(ts["opt"]["step"]) == int(js.opt["step"]) == 3
    _leaves_close(ts["opt"]["m"], js.opt["m"], ACCUM_BF16_TOL["m"], "m")
    _leaves_close(ts["opt"]["v"], js.opt["v"], ACCUM_BF16_TOL["v"], "v")
    _leaves_close(ts["params"], js.params, ACCUM_BF16_TOL["params"],
                  "params")


@pytest.mark.parametrize("nmb, compress", [(1, False), (2, True)])
def test_train_steps_with_int8_moments_match_jax(nmb, compress):
    """``quantize_moments`` (int8 blocks of 64): three steps, each from the
    JAX package's state (see the module docstring)."""
    jt, tt = _configs(nmb, compress, True)
    for js, jmet, ts, tmet in _run_both("hubert-xlarge", jt, tt, 3,
                                        resync=True):
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=RTOL)
        q = [(np.asarray(a), b) for a, b in zip(
            jax.tree.leaves((js.opt["m"], js.opt["v"])),
            jax.tree.leaves((ts["opt"]["m"], ts["opt"]["v"])))
            if np.asarray(a).dtype == np.int8]
        assert q and all(b.dtype == np.int8 for _, b in q)
        same = sum(int((a == b).sum()) for a, b in q)
        assert same >= 0.995 * sum(a.size for a, _ in q)
        near = total = 0
        for a, b in zip(jax.tree.leaves(js.params),
                        jax.tree.leaves(ts["params"])):
            near += int((np.abs(a - b) <= 1e-5 * np.abs(a).max()).sum())
            total += a.size
        assert near >= 0.999 * total


@pytest.mark.parametrize("arch", ["hubert-xlarge", "kimi-k2-1t-a32b",
                                  "mamba2-130m", "recurrentgemma-2b"])
def test_layer_remat_gives_the_gradients_of_no_remat(arch):
    """``remat == "layer"`` (each layer under ``torch.utils.checkpoint``,
    its forward rerun in the backward) against ``"none"``: the same loss
    and the same gradients, bit for bit (the same CPU operations)."""
    jcfg, tcfg = _cfgs(arch)
    params = _noisy(JModel(jcfg).init(jax.random.PRNGKey(0)), 1)
    batch = _t(_batch(jcfg, 2, 40, 5))
    out = {}
    for remat in ("layer", "none"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        model = params_from_jax(cfg, params, device="cpu")
        out[remat] = _grads(model, batch)
    assert float(out["layer"][0]) == float(out["none"][0])
    for a, b in zip(jax.tree.leaves(out["layer"][2]),
                    jax.tree.leaves(out["none"][2])):
        np.testing.assert_array_equal(a, b)


def test_a_patches_batch_without_patches_raises():
    _, tcfg = _cfgs("paligemma-3b")
    model = Model(tcfg, device="cpu")
    with pytest.raises(ValueError, match="patches"):
        model.loss({"tokens": torch.zeros((1, 8), dtype=torch.int64)})


@pytest.mark.parametrize("arch", ["hubert-xlarge", "kimi-k2-1t-a32b",
                                  "recurrentgemma-2b", "mamba2-130m"])
@pytest.mark.parametrize("quantize, compress", [(False, False), (True, True)])
def test_train_state_round_trips_through_interop(arch, quantize, compress):
    """``train_state_from_jax`` then ``train_state_to_numpy`` gives back the
    JAX package's state (stacks, ``dense0``, hybrid groups and ``extra``,
    int8 moment blocks, ``ef``) exactly."""
    jcfg, tcfg = _cfgs(arch)
    jt, _ = _configs(1, compress, quantize)
    noisy = lambda t, s: jax.tree.map(
        lambda a: a if a.dtype == np.int8 else a + np.float32(0.5), t)
    js = jax.tree.map(np.asarray, j_init_state(
        _noisy(JModel(jcfg).init(jax.random.PRNGKey(0)), 1), jt))
    js = dataclasses.replace(js, opt={**js.opt, "m": noisy(js.opt["m"], 0)})
    _, ts = train_state_from_jax(tcfg, js, device="cpu")
    assert all(p.requires_grad for p in leaves(ts.params))
    back = train_state_to_numpy(tcfg, ts)
    for got, want in ((back["params"], js.params), (back["opt"], js.opt),
                      (back["ef"], js.ef)):
        assert (jax.tree.structure(got) == jax.tree.structure(want))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)


def test_a_bf16_train_state_checkpoint_round_trips(tmp_path):
    """bf16 parameters (no numpy type) are saved as their bits and restored
    into the live state's tensors in place."""
    _, tcfg = _cfgs("qwen2-1.5b")
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    model = Model(cfg, device="cpu", seed=3)
    state = init_train_state(model.params(), TrainConfig())
    saved = [t.detach().clone() for t in leaves(state)]
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(7, state)
    with torch.no_grad():
        for t in leaves(state):
            t.zero_()
    step, got = mgr.restore_latest(like=state)
    load_train_state_(state, got)
    assert step == 7
    for a, b in zip(leaves(state), saved):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert model.top["embed"].dtype == torch.bfloat16
    assert torch.equal(model.top["embed"].detach(), saved[0]) or any(
        torch.equal(model.top["embed"].detach(), s) for s in saved)


def _losses(out: str) -> dict:
    return {int(s): float(v) for s, v in
            re.findall(r"step +(\d+) loss=([0-9.]+)", out)}


def test_launch_train_resumes_after_a_crash(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.launch.train --smoke --device cpu`` with
    checkpoints: a run that crashes after step 5 (the data pipeline raises)
    resumes from its newest checkpoint (step 4) and continues the loss curve
    of an uninterrupted run exactly."""
    argv = ["--arch", "hubert-xlarge", "--smoke", "--device", "cpu",
            "--steps", "7", "--seq", "24", "--batch", "4",
            "--microbatches", "2", "--log-every", "1", "--ckpt-every", "2"]
    launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "whole")])
    whole = _losses(capsys.readouterr().out)
    assert sorted(whole) == list(range(1, 8))

    real = launch_train.synthetic_batches

    def crashing(cfg, start_step=0, device=None):
        for i, batch in enumerate(real(cfg, start_step, device)):
            if start_step + i == 5:
                raise RuntimeError("crash")
            yield batch

    monkeypatch.setattr(launch_train, "synthetic_batches", crashing)
    with pytest.raises(RuntimeError, match="crash"):
        launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "run")])
    monkeypatch.setattr(launch_train, "synthetic_batches", real)
    # The crashed run's last checkpoint write (on the manager's thread) ends
    # before the next run reads the directory.
    for t in threading.enumerate():
        if t is not threading.current_thread() and t.daemon:
            t.join(timeout=60)
    first = _losses(capsys.readouterr().out)
    assert sorted(first) == list(range(1, 6))
    launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "run")])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    resumed = _losses(out)
    assert sorted(resumed) == [5, 6, 7]
    assert {**first, **resumed} == whole
