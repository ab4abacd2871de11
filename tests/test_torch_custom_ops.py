"""The kernels' custom ops (``torch.ops.repro_torch.*``) on the CPU: their
fake implementations, flop formulas and DTensor sharding rules.

* Under ``FakeTensorMode`` with fake CUDA inputs (nothing launched, no card
  needed) each op gives the output shapes and dtypes of its kernel's plain
  version on real CPU tensors of the same shapes.
* Each flop formula equals the count its docstring writes, computed here
  independently (the attention's visible pairs from an explicit mask), at
  two small shapes per mask, exactly; ``FlopCounterMode`` reads it.
* The sharding rule offers the batch, the heads (channels) and the
  replicated placements only.
The card's side (the ops against the direct launch, bit for bit) is in
``tests/test_torch_gpu.py``.
"""

import importlib

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

fa = importlib.import_module("repro_torch.kernels.flash_attention."
                             "flash_attention")
ss = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
ls = importlib.import_module("repro_torch.kernels.lru_scan.lru_scan")
ops = torch.ops.repro_torch


def _cuda(*ts):
    """Fake CUDA tensors of ``ts``' shapes and dtypes (call under
    ``FakeTensorMode``)."""
    return [torch.empty(t.shape, dtype=t.dtype, device="cuda") for t in ts]


def _meta(ts):
    return [(tuple(t.shape), t.dtype) for t in ts]


MASKS = [dict(causal=True), dict(causal=False),
         dict(causal=True, window=5), dict(causal=True, prefix=6),
         dict(causal=True, q_offset=9, sk_valid=12)]


def _qkv(b, sq, sk, hq, hkv, d, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(sq * 31 + sk)
    q = torch.randn((b, sq, hq, d), generator=g).to(dtype)
    k, v = (torch.randn((b, sk, hkv, d), generator=g).to(dtype)
            for _ in range(2))
    return [t.to(device) for t in (q, k, v)]


@pytest.mark.parametrize("mask", MASKS, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fakes_give_the_plain_shapes(mask, dtype):
    q, k, v = _qkv(2, 7, 13, 4, 2, 16, dtype)
    kw = fa._options(q, k, v, **{"sk_valid": None, "q_offset": 0,
                                 "scale": None, "window": 0, "prefix": 0,
                                 **mask})
    out, lse = fa.attend_plain_with_lse(q, k, v, **kw)
    dq, dk, dv = fa.attend_backward_plain(q, k, v, out, out, **kw)
    with FakeTensorMode():
        fq, fk, fv = _cuda(q, k, v)
        assert fq.device.type == "cuda"
        got = ops.flash_attention_lse(fq, fk, fv, **kw)
        one = ops.flash_attention(fq, fk, fv, **kw)
        back = ops.flash_attention_bwd(fq, fk, fv, got[0], got[0], got[1],
                                       **kw)
    assert _meta(got) == _meta((out, lse))
    assert _meta([one]) == _meta([out])
    assert _meta(back) == _meta((dq, dk, dv))


def _pairs_by_mask(sq, sk, *, causal, sk_valid, q_offset, window, prefix):
    """The visible (row, key) pairs of one head from the plain version's
    own mask construction."""
    col = torch.arange(sk)
    row = q_offset + torch.arange(sq)
    mask = (col < sk_valid)[None, :].expand(sq, sk)
    if causal:
        mask = mask & ((col[None, :] <= row[:, None])
                       | (col < prefix)[None, :])
    if window > 0:
        mask = mask & (col[None, :] > row[:, None] - window)
    return int(mask.sum())


@pytest.mark.parametrize("mask", MASKS, ids=str)
@pytest.mark.parametrize("b, sq, sk, hq, hkv, d", [(1, 7, 13, 2, 1, 16),
                                                   (2, 20, 20, 4, 2, 32)])
def test_flash_flop_formula(mask, b, sq, sk, hq, hkv, d):
    kw = {"sk_valid": sk, "q_offset": 0, "window": 0, "prefix": 0, **mask}
    n = _pairs_by_mask(sq, sk, **kw)
    assert fa.visible_pairs(sq, sk, **kw) == n
    q, k, v = _qkv(b, sq, sk, hq, hkv, d)
    kw = dict(kw, scale=d ** -0.5)
    with FakeTensorMode():
        fq, fk, fv = _cuda(q, k, v)
        with FlopCounterMode(display=False) as fwd:
            out, lse = ops.flash_attention_lse(fq, fk, fv, **kw)
        with FlopCounterMode(display=False) as bwd:
            ops.flash_attention_bwd(fq, fk, fv, out, out, lse, **kw)
    assert fwd.get_total_flops() == 4 * n * d * hq * b
    assert bwd.get_total_flops() == 10 * n * d * hq * b


def _ssd(b, h, s, p, n):
    g = torch.Generator().manual_seed(s)
    x = torch.randn((b, h, s, p), generator=g)
    dt = torch.rand((b, h, s), generator=g)
    A = -torch.rand((h,), generator=g)
    Bm, Cm = (torch.randn((b, s, n), generator=g) for _ in range(2))
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("b, h, s, p, n", [(1, 2, 40, 16, 16),
                                           (2, 3, 130, 64, 128)])
def test_ssd_fakes_and_flops(b, h, s, p, n):
    x, dt, A, Bm, Cm = _ssd(b, h, s, p, n)
    y, fin = ss.ssd_chunked_plain(x, dt, A, Bm, Cm, 64)
    grads = ss.ssd_backward_plain(x, dt, A, Bm, Cm, y, fin, chunk=64)
    q = ss.KERNEL_CHUNK
    nc = -(-s // q)
    fwd_count = 2 * b * nc * q * q * n + b * h * nc * (2 * q * q * p
                                                       + 4 * q * n * p)
    with FakeTensorMode():
        f = _cuda(x, dt, A, Bm, Cm)
        with FlopCounterMode(display=False) as fwd:
            got = ops.ssd_scan(*f)
        with FlopCounterMode(display=False) as bwd:
            back = ops.ssd_scan_bwd(*f, got[0], got[1], got[2])
    assert _meta(got[:2]) == _meta((y, fin))
    assert tuple(got[2].shape) == (b, h, nc, n, p)
    assert got[0].stride() == torch.empty(b, s, h, p).transpose(1, 2).stride()
    assert _meta(back) == _meta(grads)
    assert fwd.get_total_flops() == fwd_count
    assert bwd.get_total_flops() == 2 * fwd_count + 2 * b * nc * q * q * n


@pytest.mark.parametrize("b, s, d", [(1, 5, 3), (2, 70, 64)])
def test_lru_fakes_and_flops(b, s, d):
    g = torch.Generator().manual_seed(s)
    a, x = torch.rand((b, s, d), generator=g), torch.randn((b, s, d),
                                                            generator=g)
    h, fin = ls.lru_chunked_plain(a, x, 16)
    grads = ls.lru_backward_plain(a, h, h, fin)
    with FakeTensorMode():
        fa_, fx = _cuda(a, x)
        with FlopCounterMode(display=False) as fwd:
            got = ops.lru_scan(fa_, fx)
        with FlopCounterMode(display=False) as bwd:
            back = ops.lru_scan_bwd(fa_, got[0], got[0], got[1])
    assert _meta(got) == _meta((h, fin))
    assert _meta(back) == _meta(grads)
    assert fwd.get_total_flops() == 2 * b * s * d
    assert bwd.get_total_flops() == 3 * b * s * d


def test_the_cpu_takes_the_plain_versions_and_the_ops_refuse_it():
    """A CPU tensor takes the plain version (no op is dispatched); the ops
    themselves have a CUDA implementation only."""
    q, k, v = _qkv(1, 4, 4, 2, 1, 16)
    with FlopCounterMode(display=False) as fc:
        fa.attend(q, k, v, causal=True)
    assert not any("repro_torch" in str(op)
                   for op in fc.get_flop_counts().get("Global", {}))
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, k, v, causal=True, sk_valid=4, q_offset=0,
                            scale=0.25, window=0, prefix=0)


def test_sharding_rule_offers_batch_heads_and_replicated():
    """On a fake 2×2 mesh: the flash rule's strategies are replicated,
    batch-sharded and head-sharded; with 3 KV heads (not divisible by 2)
    no head strategy is offered; a DTensor call sharded on the batch keeps
    its placements, one sharded on the sequence is redistributed."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed.sharding import register_kernel_rules
    from repro_torch.kernels._sharding import local_rule
    from repro_torch.launch.mesh import fake_world, make_mesh

    register_kernel_rules()
    axes = {"batch": ((0, 0, 0), (0,)), "heads": ((2, 2, 2), (2,))}

    class Spec:
        def __init__(self, shape, mesh):
            self.shape, self.mesh = shape, mesh
            self.placements = (Replicate(), Replicate())

    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        specs = [Spec((4, 8, 4, 16), mesh), Spec((4, 8, 2, 16), mesh),
                 Spec((4, 8, 2, 16), mesh)]
        got = local_rule("op", specs + [True, 8], axes)
        assert [o for o, _ in got] == [[Replicate()], [Shard(0)], [Shard(2)]]
        assert got[1][1] == [Shard(0)] * 3 + [None, None]
        specs[1] = Spec((4, 8, 3, 16), mesh)
        assert len(local_rule("op", specs + [True, 8], axes)) == 2
        with pytest.raises(ValueError, match="no DTensor"):
            local_rule("op", [True, 8], axes)
        with FakeTensorMode():
            def dt(shape, pl):
                return DTensor.from_local(torch.empty(shape, device="meta"),
                                          mesh, pl, run_check=False)
            q = dt((2, 8, 4, 16), [Shard(0), Replicate()])
            k = dt((2, 8, 2, 16), [Shard(0), Replicate()])
            kw = dict(causal=True, sk_valid=8, q_offset=0, scale=0.25,
                      window=0, prefix=0)
            out = ops.flash_attention(q, k, k, **kw)
            assert out.placements == (Shard(0), Replicate())
            assert tuple(out.to_local().shape) == (2, 8, 4, 16)
            qs = dt((4, 4, 4, 16), [Replicate(), Shard(1)])
            ks = dt((4, 4, 2, 16), [Replicate(), Shard(1)])
            out = ops.flash_attention(qs, ks, ks, **kw)
            assert all(not (p.is_shard() and p.dim == 1)
                       for p in out.placements)
