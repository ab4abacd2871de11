"""The ranks of ``test_torch_elastic.py``'s worlds: each rank joins a ``gloo``
process group by a ``FileStore`` rendezvous, runs its tasks and writes what
the test checks to ``<out>/<rank>.json``.  Imports torch, the port and the
helpers that ``chip_smoke.py``'s elastic phase shares with it only, so a
world starts without JAX."""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (elastic_layout, elastic_state, int_bits,  # noqa: E402
                        shard_of)

ROWS, COLS = 16, 4          # the JAX elastic test's [16, 4] leaf


def run(rank: int, world: int, store: str, out: str, tasks: list) -> None:
    """``torch.multiprocessing.spawn``'s entry: every task of ``tasks`` (a
    list of ``(name, kwargs)``) in order, under one process group."""
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        got = {name: TASKS[name](rank, world, **kw) for name, kw in tasks}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"{rank}.json"), "w") as f:
        json.dump(got, f)


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(int_bits(a), int_bits(b)))


# --------------------------------------------------------------------------- #
# Tasks                                                                        #
# --------------------------------------------------------------------------- #

def save_rows(rank, world, directory):
    """The JAX elastic test's state, ``arange(64)`` as ``[16, 4]``, saved at
    step 7 from a DTensor sharded by rows over the world."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.checkpoint import CheckpointManager
    mesh = _mesh((world,), ("data",))
    full = torch.arange(ROWS * COLS, dtype=torch.float32).reshape(ROWS, COLS)
    w = distribute_tensor(full, mesh, [Shard(0)], src_data_rank=None)
    CheckpointManager(directory).save(7, {"w": w})
    return {"local_rows": list(w.to_local().shape)}


def restore_rows(rank, world, directory):
    """Restore a ``[16, 4]`` row checkpoint onto this world by rows; each
    rank's shard against its rows of ``arange(64)``."""
    from torch.distributed.tensor import Shard

    from repro_torch.checkpoint import CheckpointManager
    mesh = _mesh((world,), ("data",))
    like = {"w": torch.empty((ROWS, COLS), device="meta")}
    step, st = CheckpointManager(directory).restore_latest(
        like=like, placements={"w": (mesh, [Shard(0)])})
    local = st["w"].to_local()
    per = ROWS // world
    want = torch.arange(ROWS * COLS, dtype=torch.float32).reshape(
        ROWS, COLS)[rank * per:(rank + 1) * per]
    return {"step": step, "equal": same_bits(local, want),
            "local_shape": list(local.shape)}


def _small_state(mesh, step: int):
    """A state of DTensor leaves (rows, and bf16 columns), a replicated
    plain tensor and a numpy scalar, its values a function of ``step``."""
    from torch.distributed.tensor import Shard, distribute_tensor
    g = torch.Generator().manual_seed(step)
    w = torch.randn((ROWS, COLS), generator=g)
    b = torch.randn((6, 8), generator=g).to(torch.bfloat16)
    return ({"w": distribute_tensor(w, mesh, [Shard(0)], src_data_rank=None),
             "b": distribute_tensor(b, mesh, [Shard(1)], src_data_rank=None),
             "n": torch.full((3,), step, dtype=torch.int64),
             "s": np.int32(step)},
            {"w": w, "b": b})


def steps(rank, world, directory):
    """Steps 1-3 saved from DTensors (1 and 3 blocking, 2 not); whether each
    rank found the step committed when ``save``/``wait`` returned, and how
    many arrays each rank wrote.  Then step 3 corrupted: every rank's
    restore; then step 2 failing on rank 1 alone: every rank's restore;
    then bad placements, on one rank and on all."""
    from torch.distributed.tensor import Shard

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import manager as manager_mod
    mesh = _mesh((world,), ("data",))
    mgr = CheckpointManager(directory, keep=3)
    writes = [0]
    save_npy = manager_mod.save_npy_durable

    def counted(path, arr):
        writes[0] += 1
        save_npy(path, arr)

    manager_mod.save_npy_durable = counted
    committed = []
    for step in (1, 2, 3):
        state, _ = _small_state(mesh, step)
        path = mgr.save(step, state, blocking=step != 2)
        mgr.wait()
        committed.append(os.path.isfile(os.path.join(path, "manifest.json")))
    manager_mod.save_npy_durable = save_npy

    like = {"w": torch.empty((ROWS, COLS), device="meta"),
            "b": torch.empty((6, 8), dtype=torch.bfloat16, device="meta"),
            "n": torch.empty((3,), dtype=torch.int64, device="meta"),
            "s": np.int32(0)}
    where = {"w": (mesh, [Shard(0)]), "b": (mesh, [Shard(1)]),
             "n": "cpu", "s": None}

    def check(step, st):
        _, full = _small_state(mesh, step)
        return (same_bits(st["w"].to_local(),
                          shard_of(full["w"], mesh, [Shard(0)]))
                and same_bits(st["b"].to_local(),
                              shard_of(full["b"], mesh, [Shard(1)]))
                and torch.equal(st["n"], torch.full((3,), step))
                and int(st["s"]) == step)

    dist.barrier()
    if rank == 0:    # flip a byte in the middle of step 3's rows
        f = os.path.join(directory, f"step_{3:012d}", "arr_00003.npy")
        with open(f, "r+b") as fh:
            fh.seek(-5, os.SEEK_END)
            byte = fh.read(1)
            fh.seek(-5, os.SEEK_END)
            fh.write(bytes([byte[0] ^ 0xFF]))
    dist.barrier()
    got = {}
    step, st = mgr.restore_latest(like=like, placements=where)
    got["after_corrupt"] = [step, check(step, st)]

    if rank == 1:    # step 2 fails to load on rank 1 alone
        load = mgr._load

        def failing(s, *a):
            if s == 2:
                raise IOError("rank 1 cannot read step 2")
            return load(s, *a)
        mgr._load = failing
    step, st = mgr.restore_latest(like=like, placements=where)
    got["after_one_rank_fails"] = [step, check(step, st)]
    mgr.__dict__.pop("_load", None)

    missing = f"cuda:{torch.cuda.device_count()}"
    for case, bad in (("one_rank_missing_card",
                       missing if rank == 2 else "cpu"),
                      ("every_rank_short_placements", (mesh, [])),
                      ("every_rank_shard_dim_past_the_leaf",
                       (mesh, [Shard(1)]))):
        try:
            mgr.restore_latest(like=like, placements=dict(where, n=bad))
            got[case] = "restored"
        except ValueError as e:
            got[case] = f"ValueError: {e}"

    place = manager_mod._place
    if rank == 2:    # placing a leaf fails on rank 2 alone (card memory)
        def out_of_memory(*a):
            raise torch.cuda.OutOfMemoryError("no room for the leaf")
        manager_mod._place = out_of_memory
    try:
        mgr.restore_latest(like=like, placements=where)
        got["one_rank_fails_to_place"] = "restored"
    except RuntimeError as e:
        got["one_rank_fails_to_place"] = f"{type(e).__name__}: {e}"
    manager_mod._place = place
    return dict(got, committed=committed, arrays_written=writes[0])


def _sharded(state, where) -> int:
    """How many leaves of ``state`` ``where`` shards on some mesh dim."""
    from repro_torch.tree import leaves, map_tree
    return sum(leaves(map_tree(
        lambda t, p: any(x.is_shard() for x in p[1]), state, where)))


def save_train_state(rank, world, directory, arch, seed):
    """``arch``'s smoke train state laid out over a ``(data 1, model
    world)`` mesh by ``param_placements``/``opt_placements`` through
    ``shardings_for``, saved at step 5."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.tree import leaves, map_tree
    cfg = get_config(arch).smoke()
    mesh = _mesh((1, world), ("data", "model"))
    st = elastic_state(cfg, seed, "cpu")
    where = elastic_layout(cfg, st.params, st.opt, mesh)
    sharded = map_tree(lambda t, p: distribute_tensor(
        t.detach(), *p, src_data_rank=None), st, where)
    CheckpointManager(directory).save(5, sharded)
    return {"leaves": len(list(leaves(st))),
            "sharded_leaves": _sharded(st, where)}


def restore_train_state(rank, world, directory, arch, seed):
    """Restore the saved state from a ``meta`` like onto a ``(data 1, model
    world)`` mesh; every local shard against its slice of the state
    rebuilt from the seed."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models.model import meta_params
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.tree import leaves, map_tree
    cfg = get_config(arch).smoke()
    mesh = _mesh((1, world), ("data", "model"))
    like = init_train_state(meta_params(cfg), TrainConfig())
    where = elastic_layout(cfg, like.params, like.opt, mesh)
    step, got = CheckpointManager(directory).restore_latest(
        like=like, placements=where)
    want = elastic_state(cfg, seed, "cpu")
    equal = list(leaves(map_tree(
        lambda g, w, p: same_bits(g.to_local(),
                                  shard_of(w.detach(), *p)),
        got, want, where)))
    return {"step": step, "leaves": len(equal), "all_equal": all(equal),
            "placed_sharded": _sharded(like, where),
            "sharded_leaves": sum(g.to_local().shape != w.shape
                                  for g, w in zip(leaves(got),
                                                  leaves(want)))}


TASKS = {"save_rows": save_rows, "restore_rows": restore_rows,
         "steps": steps, "save_train_state": save_train_state,
         "restore_train_state": restore_train_state}
