"""Chaos matrix of the port, buffered driver: PSRS on the file tier killed
(``kill -9``, in port children) in and after every stage with a bit-identical
resume, a torn write healed by the resume, a no-op re-resume, and seeded EIO
bursts absorbed by the engine's retries under each I/O driver.  The
``odirect`` and ``mmap`` chains are ``tests/test_torch_chaos_odirect.py``
and ``tests/test_torch_chaos_mmap.py``;
``tests/test_chaos.py`` holds the JAX package to the same matrix."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _chaos import assert_killed, assert_ok, kill_chain, run_child
from repro_torch.pems_apps import psrs_sort


@pytest.mark.parametrize("kind", ["in", "after"])
def test_kill9_at_every_stage_then_resume(tmp_path, kind):
    sd = str(tmp_path / "state")
    kill_chain(sd, "buffered", kind, range(8))
    # A rerun against the finished state dir is a no-op resume.
    before = open(f"{sd}/cursor.json").read()
    assert_ok(run_child(sd))
    assert open(f"{sd}/cursor.json").read() == before


def test_torn_write_healed_by_resume(tmp_path):
    """A silent torn write inside the in-progress stage, then kill -9 before
    the stage commits: the resume recomputes the sidecar over what hit the
    disk, reruns the stage, and the output is bit-identical."""
    sd = str(tmp_path / "state")
    assert_killed(run_child(sd, kind="in", stage=0,
                            fault_spec="torn@wb0-4095:0.5"))
    assert_ok(run_child(sd))


def test_injected_kill_mid_pwrite_resumes(tmp_path):
    """``kill@w3``: the child dies inside its fourth write request, with I/O
    in flight, not at a stage boundary."""
    sd = str(tmp_path / "state")
    assert_killed(run_child(sd, fault_spec="kill@w3"))
    assert_ok(run_child(sd))


@pytest.mark.parametrize("io_driver", ("buffered", "odirect", "mmap"))
def test_seeded_eio_bursts_absorbed_by_retries(tmp_path, io_driver):
    rng = np.random.default_rng(23)
    data = rng.integers(-2**31, 2**31 - 1, size=2048, dtype=np.int32)
    out, pems = psrs_sort(
        torch.from_numpy(data), v=8, k=2, driver="async", tier="file",
        io_driver=f"faulty:{io_driver}",
        fault_spec="seed=5;eio@p0.03:x2;lat@p0.02:0.001",
        io_retries=4, io_queue_depth=4, device="cpu",
        backing_path=str(tmp_path / "ctx.bin"), return_pems=True)
    np.testing.assert_array_equal(out.numpy(), np.sort(data))
    injected = pems.backing.file.injected["eio"]
    s = pems.tier_stats
    assert injected > 0                          # faults really fired
    assert s.retries == injected                 # each absorbed by a retry
    assert s.permanent_errors == 0 and s.backoff_s > 0.0
