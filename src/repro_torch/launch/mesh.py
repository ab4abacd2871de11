"""Production meshes of the dry run: the port of ``repro/launch/mesh.py``.

A ``DeviceMesh`` of the JAX package's shapes and axis names over a fake
process group (``torch.distributed``'s ``"fake"`` backend): one process
holds rank 0 of 256 or 512 ranks, DTensor plans every collective against
the whole mesh, and nothing is sent.  Functions, never module-level
objects: importing this module creates no group, and :func:`fake_world`
tears its group down on exit, so tests in one process do not leak a group
into each other.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake default process group of ``world_size`` ranks, this process
    rank 0, for the duration of the block.  Raises if a group exists
    already (the caller's, which this must not replace)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default group
    (whose world size must be the mesh's size)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the group "
                         f"has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False):
    """``(shape, axis names)``: 16×16 ``("data", "model")`` (256 chips), or
    2×16×16 ``("pod", "data", "model")`` (512 chips) multi-pod."""
    return MULTI_POD if multi_pod else SINGLE_POD


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh over the current (fake) group: call it inside
    :func:`fake_world` of 256 ranks, or 512 ``multi_pod``."""
    return make_mesh(*production_shape(multi_pod), device_type=device_type)


def data_axes_of(mesh) -> tuple:
    """Axes usable for batch/data parallelism on this mesh."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
