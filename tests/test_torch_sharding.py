"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's (``repro.distributed.sharding``), exactly: a spec is a
tuple of mesh axes, so there is no tolerance.

For every architecture of ``ARCH_NAMES`` on the single-pod (16×16) and the
multi-pod (2×16×16) mesh: the parameters (fsdp as the dry run's
``FSDP_ARCHS`` take it, and ``expert_fsdp_dim`` contract, ff and none), the
``decode_32k`` cache, and the f32 and int8 AdamW moments.  JAX's shapes come
from ``jax.eval_shape`` at full width (nothing is allocated); its
``ShardingRules`` reads only ``mesh.shape`` for these, so a stand-in with a
``.shape`` dict takes the place of a 512-device mesh.  The port's trees are
JAX's cut into the port's layout (one dict a layer, ``layer_stacks``), so
each port layer's spec must equal JAX's with the stack entry dropped.  The
batch's specs need a real JAX mesh and are held in
``tests/test_torch_dryrun.py``'s subprocess.
"""

import jax
import pytest

from repro.configs import ARCH_NAMES, SHAPES
from repro.configs import get_config as jax_config
from repro.distributed import sharding as jsh
from repro.models import Model as JaxModel
from repro.optim import OptConfig as JaxOptConfig
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.dryrun import FSDP_ARCHS
from repro_torch.models.model import layer_stacks

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


class _Mesh:
    """What both packages' rules read of a mesh: its axis sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _rules(pkg, mesh, **kw):
    axes = tuple(a for a in mesh if a in ("pod", "data"))
    return pkg.ShardingRules(mesh=_Mesh(mesh), data_axes=axes, **kw)


def _sub(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _cut(cfg, tree):
    """A JAX-layout tree (stacked ``[L, ...]`` leaves) in the port's layout:
    the top-level entries as they are and ``"layers"`` a list of per-layer
    nests, each leaf an object with the stacked leaf's shape less its stack
    dim."""
    class Leaf:
        def __init__(self, shape, dtype=None):
            self.shape = tuple(shape)
            self.ndim = len(self.shape)

        def dim(self):
            return self.ndim

    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        return Leaf(t.shape[1:])

    out = {k: jax.tree.map(lambda x: Leaf(x.shape), v)
           for k, v in tree.items() if k not in ("layers", "dense0", "extra")}
    layers = [None] * cfg.n_layers
    for keys, idx in layer_stacks(cfg):
        for i in idx:
            layers[i] = one(_sub(tree, keys))
    out["layers"] = layers
    return out


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _check(cfg, jspecs, tspecs):
    """Every port spec equals JAX's (the stack entry dropped in a layer)."""
    n = 0
    for k, v in tspecs.items():
        if k == "layers":
            continue
        for path, spec in _leaves(v, (k,)):
            assert spec == tuple(_sub(jspecs, path)), path
            n += 1
    for keys, idx in layer_stacks(cfg):
        stack = _sub(jspecs, keys)
        for i in idx:
            for path, spec in _leaves(tspecs["layers"][i]):
                want = tuple(_sub(stack, path))
                assert spec == want[1:], (keys, i, path, spec, want)
                n += 1
    assert n > 0


_SHAPES = {}


def _param_shapes(arch):
    if arch not in _SHAPES:
        cfg = jax_config(arch)
        _SHAPES[arch] = jax.eval_shape(JaxModel(cfg).init,
                                       jax.random.PRNGKey(0))
    return _SHAPES[arch]


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_jax(arch, mesh):
    cfg = get_config(arch)
    shapes = _param_shapes(arch)
    port = _cut(cfg, shapes)
    cases = [dict(fsdp=arch in FSDP_ARCHS)]
    if cfg.is_moe:
        cases += [dict(fsdp=True, expert_fsdp_dim=d)
                  for d in ("contract", "ff", "none")]
    for kw in cases:
        jspecs = jax.tree.map(tuple, jsh.param_pspecs(
            _rules(jsh, MESHES[mesh], **kw), shapes), is_leaf=_is_spec)
        tspecs = tsh.param_placements(_rules(tsh, MESHES[mesh], **kw), cfg,
                                      port)
        _check(cfg, jspecs, tspecs)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES
                                  if not get_config(a).is_encoder_only])
def test_decode_cache_specs_equal_jax(arch, mesh):
    cfg = get_config(arch)
    jcfg = jax_config(arch)
    shape = SHAPES["decode_32k"]
    jcache = jax.eval_shape(lambda: JaxModel(jcfg).init_cache(
        shape.global_batch, shape.seq_len))
    jspecs = jax.tree.map(tuple, jsh.cache_pspec(_rules(jsh, MESHES[mesh]),
                                                  jcache), is_leaf=_is_spec)
    port = _cut(cfg, jcache)
    tspecs = tsh.cache_placements(_rules(tsh, MESHES[mesh]), cfg, port)
    _check(cfg, jspecs, tspecs)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_moment_specs_equal_jax(arch, quantize, mesh):
    cfg = get_config(arch)
    shapes = _param_shapes(arch)
    ocfg = JaxOptConfig(quantize_moments=quantize)
    jopt = jax.eval_shape(lambda p: jax_adamw_init(p, ocfg), shapes)
    kw = dict(fsdp=arch in FSDP_ARCHS)
    jspecs = jax.tree.map(tuple, jsh.opt_pspecs(
        _rules(jsh, MESHES[mesh], **kw), jopt, shapes), is_leaf=_is_spec)
    port_params = _cut(cfg, shapes)
    port_opt = {"step": None, "m": _cut(cfg, jopt["m"]),
                "v": _cut(cfg, jopt["v"])}
    tspecs = tsh.opt_placements(_rules(tsh, MESHES[mesh], **kw), cfg,
                                port_opt, port_params)
    assert tspecs["step"] == tuple(jspecs["step"]) == ()
    for part in ("m", "v"):
        _check(cfg, jspecs[part], tspecs[part])


def test_to_placements_and_local_shape():
    """A spec's DTensor placements and local shape on a fake 2×16×16 mesh:
    each mesh dim shards the tensor dim that names it."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import fake_world, make_production_mesh

    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        rules = tsh.ShardingRules(mesh=mesh, data_axes=("pod", "data"))
        assert rules.data_size == 32 and rules.model_size == 16
        spec = (("pod", "data"), None, "model")
        assert tsh.to_placements(mesh, spec) == [Shard(0), Shard(0),
                                                 Shard(2)]
        assert tsh.to_placements(mesh, (None,)) == [Replicate()] * 3
        assert tsh.local_shape(rules, (64, 7, 32), spec) == (2, 7, 2)


def test_port_init_shapes_match_the_cut_jax_shapes():
    """The port's own parameters (``init_params`` under ``FakeTensorMode``,
    nothing allocated) have the shapes the tests above cut from JAX's (an
    ssm, a hybrid and a dense model)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.model import init_params

    for arch in ("mamba2-130m", "recurrentgemma-2b", "qwen2-1.5b"):
        cfg = get_config(arch)
        with FakeTensorMode():
            port = init_params(cfg, torch.Generator())
        cut = _cut(cfg, _param_shapes(arch))
        got = {p: tuple(t.shape) for p, t in _leaves(
            {**port, "layers": dict(enumerate(port["layers"]))})}
        want = {p: t.shape for p, t in _leaves(
            {**cut, "layers": dict(enumerate(cut["layers"]))})}
        assert got == want, arch
