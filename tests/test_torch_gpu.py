"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device and skips
when there is none (this is decided while the test runs, never while the
module is imported).  On a machine with an NVIDIA H100 and the CUDA toolkit::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The first test builds the kernels (``build/kernels``).  Outputs compare
exactly: every kernel is integer data movement or comparison.
"""

from __future__ import annotations

import importlib

import pytest
import torch

INT_MIN, INT_MAX = -2**31, 2**31 - 1

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel(name):
    return importlib.import_module(f"repro_torch.kernels.{name}.{name}")


def _keys(shape, dev, seed, kind="random"):
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "random":
        return torch.randint(INT_MIN, INT_MAX + 1, shape, generator=g,
                             device=dev, dtype=torch.int64).to(torch.int32)
    return torch.randint(-2, 3, shape, generator=g, device=dev,
                         dtype=torch.int32)


@pytest.mark.parametrize("rows, n", [(1, 1), (3, 8), (2, 8192), (2, 16384),
                                     (3, 1 << 17)])
@pytest.mark.parametrize("kind", ["random", "dups"])
def test_bitonic_kernel_matches_plain(cuda, rows, n, kind):
    bs = _kernel("bitonic_sort")
    x = _keys((rows, n), cuda, rows * n, kind)
    before = bs.LAUNCHES
    got = bs.bitonic_sort_rows(x)
    torch.cuda.synchronize()
    assert bs.LAUNCHES == before + 1
    assert torch.equal(got, bs.bitonic_network(x))
    assert torch.equal(got, torch.sort(x, dim=-1).values)


def test_bitonic_kernel_reads_strided_rows(cuda):
    bs = _kernel("bitonic_sort")
    x = _keys((3, 3000), cuda, 1)
    assert torch.equal(bs.bitonic_sort_rows(x[:, 100:2148]),
                       torch.sort(x[:, 100:2148], dim=-1).values)


@pytest.mark.parametrize("tile", [2, 8, 256, 8192, 16384])
def test_tile_kernel_matches_plain(cuda, tile):
    km = _kernel("kway_merge")
    t = _keys((max(1, (1 << 16) // tile), tile), cuda, tile, "dups")
    before = km.LAUNCHES
    got = km.merge_tile_grid(t)
    torch.cuda.synchronize()
    assert km.LAUNCHES == before + 1
    assert torch.equal(got, km.sort_tile_rows(t))


@pytest.mark.parametrize("v, ww", [(1, 1), (3, 100), (4, 129), (16, 1000)])
@pytest.mark.parametrize("fill", [None, INT_MAX])
def test_deliver_kernel_matches_plain(cuda, v, ww, fill):
    dv = _kernel("alltoallv_deliver")
    src = _keys((v, v * ww + 7), cuda, v * ww)
    cnt = torch.randint(-2, ww + 3, (v, v + 2), device=cuda,
                        dtype=torch.int32)
    outs = []
    for fn in (dv.deliver_words, dv.deliver_words_plain):
        dst = torch.zeros((v, v * ww + 10), dtype=torch.int32, device=cuda)
        ct = torch.zeros((v, v + 3), dtype=torch.int32, device=cuda)
        fn(src, 7, dst, 10, v, ww, None if fill is None else cnt, 2, fill,
           cnt, 1, ct, 3)
        outs += [dst, ct]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])


def test_psrs_on_the_card_matches_the_cpu_and_launches_every_kernel(cuda):
    from repro_torch.pems_apps import psrs_sort

    mods = [_kernel(n) for n in ("bitonic_sort", "kway_merge",
                                 "alltoallv_deliver")]
    keys = _keys((1 << 16,), cuda, 7, "dups")
    for m in mods:
        m.LAUNCHES = 0
    for driver in ("explicit", "sliced", "async"):
        got = psrs_sort(keys, v=16, k=4, driver=driver)
        assert got.device.type == "cuda"
        assert torch.equal(got, torch.sort(keys).values)
    assert all(m.LAUNCHES > 0 for m in mods)
    cpu = psrs_sort(keys.cpu(), v=16, k=4, device="cpu")
    assert torch.equal(got.cpu(), cpu)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    bs = _kernel("bitonic_sort")
    with pytest.raises(TypeError, match="int32"):
        bs.bitonic_sort_rows(torch.zeros((2, 8), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        bs.bitonic_sort_rows(
            torch.zeros((8, 2), dtype=torch.int32, device=cuda).t())
