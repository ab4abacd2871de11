"""The port's crash recovery (``repro_torch.core.recovery``,
``repro_torch.pems_apps.psrs_run_recoverable``) against the JAX package's:
the cursor and atomic files byte for byte, the recoverable run on the memmap
and file tiers at ``P`` 1 and 2 with checksums on and off (keys, backing
words, every ledger counter, the cursor, sidecar and backing bytes), a
cursor left in progress by hand, and state dirs killed in one package and
resumed in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import _chaos
from _chaos import assert_killed, run_child
from _jax_ref import apps, core as jcore
from repro_torch.core import SuperstepCursor, atomic_replace_file, \
    atomic_write_json
from repro_torch.core.recovery import fsync_dir
from repro_torch.pems_apps import STAGE_SNAPSHOT_FIELDS, psrs_run_recoverable

V, K = 8, 2


def _keys(seed=0, n=4096):
    return np.random.default_rng(seed).integers(
        -2**31, 2**31 - 1, size=n, dtype=np.int32)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_cursor_files_are_byte_equal_to_jax(tmp_path):
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    for P in (1, 3):
        curs = []
        for d, cls in (("j", jcore.SuperstepCursor), ("t", SuperstepCursor)):
            curs.append([cls(cls.path_for(str(tmp_path / d), p, P))
                         for p in range(P)])
        marks = [("mark_in_progress", 0, "load"), ("note_round", 3),
                 ("mark_completed", 0, "load"),
                 ("mark_in_progress", 1, "sort_sample"), ("note_round", 0),
                 ("note_round", 1), ("mark_completed", 1, None),
                 ("mark_in_progress", 2, None)]
        for mark, *args in marks:
            for p in range(P):
                for c in (curs[0][p], curs[1][p]):
                    getattr(c, mark)(*args)
                assert _read(curs[1][p].path) == _read(curs[0][p].path)
                assert os.path.basename(curs[1][p].path) \
                    == os.path.basename(curs[0][p].path)
                assert curs[1][p].state() == curs[0][p].state()
        reopened = SuperstepCursor(curs[0][0].path)   # JAX's file, read
        assert (reopened.completed, reopened.in_progress) == (1, 2)
        for c in curs[0] + curs[1]:
            c.clear()
            assert c.state() is None and c.completed == -1
    obj = {"a": [1, 2.5, None], "b": {"c": "d"}}
    jcore.atomic_write_json(str(tmp_path / "j" / "o.json"), obj)
    atomic_write_json(str(tmp_path / "t" / "o.json"), obj, durable=False)
    assert _read(tmp_path / "t" / "o.json") == _read(tmp_path / "j" / "o.json")
    for d, fn in (("j", jcore.atomic_replace_file), ("t", atomic_replace_file)):
        fn(str(tmp_path / d / "b.bin"), lambda f: f.write(b"\x00\x01xyz"),
           binary=True)
    assert _read(tmp_path / "t" / "b.bin") == b"\x00\x01xyz"
    assert not os.path.exists(tmp_path / "t" / "b.bin.tmp")
    fsync_dir(str(tmp_path / "no-such-dir"))      # quietly nothing


def _state(pems):
    """Every ledger counter (main and per shard) and the population's
    words, through the block API."""
    return ([led.snapshot() for led in [pems.ledger] + pems.shard_ledgers],
            pems.backing.read_block(0, pems.backing.v))


def _dir_files(d):
    return sorted(f for f in os.listdir(d))


def _same_state_dirs(jd, td):
    """The two state dirs hold the same files with the same bytes; the npz
    snapshots hold the same arrays."""
    assert _dir_files(td) == _dir_files(jd)
    for name in _dir_files(jd):
        if name.endswith(".npz"):
            with np.load(os.path.join(jd, name)) as a, \
                    np.load(os.path.join(td, name)) as b:
                assert sorted(a.files) == sorted(b.files)
                for key in a.files:
                    np.testing.assert_array_equal(b[key], a[key])
                    assert b[key].dtype == a[key].dtype
        else:
            assert _read(os.path.join(td, name)) \
                == _read(os.path.join(jd, name)), name


@pytest.mark.parametrize("checksums", [True, False])
@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("tier", ["memmap", "file"])
def test_recoverable_psrs_matches_jax(tmp_path, tier, P, checksums):
    keys = _keys(P)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(v=V, k=K, P=P, tier=tier, checksums=checksums,
              driver="async" if tier == "file" else "sliced")
    jout, jpems = apps.psrs_run_recoverable(keys, state_dir=jd,
                                            return_pems=True, **kw)
    tout, tpems = psrs_run_recoverable(torch.from_numpy(keys), state_dir=td,
                                       device="cpu", return_pems=True, **kw)
    assert tout.device.type == "cpu" and tout.dtype == torch.int32
    np.testing.assert_array_equal(tout.numpy(), np.sort(keys))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    (jled, jwords), (tled, twords) = _state(jpems), _state(tpems)
    np.testing.assert_array_equal(twords, jwords)
    assert tled == jled
    assert (tpems.backing.checksum is not None) == checksums
    assert [c.completed for c in tpems.cursors] == [7] * P
    for bk in (jpems.backing, tpems.backing):
        getattr(bk, "close", lambda: None)()
    _same_state_dirs(jd, td)
    names = _dir_files(td)
    assert ("ctx.bin.crc" in names or "ctx.bin.shard0.crc" in names) \
        == checksums
    # A rerun on the finished state dir runs no stage and rereads the
    # result.
    again, pems = psrs_run_recoverable(torch.from_numpy(keys), state_dir=td,
                                       device="cpu", return_pems=True, **kw)
    assert torch.equal(again, tout)
    assert pems.ledger.swap_in == 0 and pems.ledger.supersteps == 0


def _rewind(sd, keys):
    """Rewind a finished run's state dir by hand: garbage over every data
    row on disk, a stage snapshot holding the true input for sort_sample
    (stage 1), and the cursor in progress at stage 1."""
    n_v = keys.size // V
    path = os.path.join(sd, "ctx.bin")
    rowbytes = os.path.getsize(path) // V
    with open(path, "r+b") as f:
        for r in range(V):
            f.seek(r * rowbytes)
            f.write(b"\xab" * (4 * n_v))
    jcore.atomic_replace_file(
        os.path.join(sd, "stage_snapshot.npz"),
        lambda f: np.savez(f, __stage__=np.int64(1),
                           data=keys.reshape(V, n_v)), binary=True)
    with open(os.path.join(sd, "cursor.json"), "w") as f:
        json.dump({"completed": 0, "in_progress": 1, "stage": "sort_sample",
                   "round": 2}, f)


def test_a_cursor_left_in_progress_by_hand_resumes_from_its_snapshot(
        tmp_path):
    """The resume must re-bless the sidecar over the garbage, restore the
    snapshot and rerun stages 1-7, in either package, with the same
    ledger."""
    assert STAGE_SNAPSHOT_FIELDS["sort_sample"] == ("data",)
    keys = _keys(5)
    kw = dict(v=V, k=K, tier="file", checksums=True, return_pems=True)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    for sd, run in ((jd, apps.psrs_run_recoverable),
                    (td, lambda x, **a: psrs_run_recoverable(
                        torch.from_numpy(x), device="cpu", **a))):
        _, pems = run(keys, state_dir=sd, **kw)
        pems.backing.close()
        _rewind(sd, keys)
    jout, jpems = apps.psrs_run_recoverable(keys, state_dir=jd, **kw)
    tout, tpems = psrs_run_recoverable(torch.from_numpy(keys), state_dir=td,
                                       device="cpu", **kw)
    np.testing.assert_array_equal(tout.numpy(), np.sort(keys))
    np.testing.assert_array_equal(np.asarray(jout), np.sort(keys))
    assert tpems.ledger.snapshot() == jpems.ledger.snapshot()
    assert tpems.ledger.supersteps > 0 and tpems.ledger.swap_in > 0
    assert json.load(open(os.path.join(td, "cursor.json")))["completed"] == 7


@pytest.mark.parametrize("writer, stage, reader", [
    ("jax", "sort_sample", "port"),
    ("port", "merge", "jax"),
])
def test_a_run_killed_in_one_package_resumes_in_the_other(
        tmp_path, writer, stage, reader):
    sd = str(tmp_path / "state")
    assert_killed(run_child(sd, pkg=writer, kind="in", stage=stage))
    cur = json.load(open(os.path.join(sd, "cursor.json")))
    assert cur["in_progress"] is not None and cur["completed"] >= 0
    keys = _chaos.keys()
    kw = dict(v=_chaos.V, k=_chaos.K, state_dir=sd, io_queue_depth=4)
    if reader == "port":
        out = psrs_run_recoverable(torch.from_numpy(keys), device="cpu",
                                   **kw).numpy()
    else:
        out = np.asarray(apps.psrs_run_recoverable(keys, **kw))
    np.testing.assert_array_equal(out, np.sort(keys))
    assert json.load(open(os.path.join(sd, "cursor.json"))) == {
        "completed": 7, "in_progress": None, "stage": "merge",
        "round": None}


@pytest.mark.parametrize("kind", ["in", "after"])
def test_only_the_failed_process_reruns_its_stage(tmp_path, kind):
    """``P = 2``, killed in (or after) partition: each process has its own
    cursor and snapshot; the resume reruns the stage for the processes
    whose cursor did not commit it, and the result is the P = 1 sort."""
    sd = str(tmp_path / "state")
    assert_killed(run_child(sd, kind=kind, stage="partition", P=2))
    curs = [json.load(open(os.path.join(sd, f"cursor.p{p}.json")))
            for p in range(2)]
    stage = 5
    if kind == "in":       # process 0 committed, process 1 died in it
        assert curs[0]["completed"] == stage and curs[1]["completed"] == 4
        assert curs[1]["in_progress"] == stage
    else:
        assert [c["completed"] for c in curs] == [stage, stage]
    keys = _chaos.keys()
    out, pems = psrs_run_recoverable(
        torch.from_numpy(keys), v=_chaos.V, k=_chaos.K, P=2, state_dir=sd,
        io_queue_depth=4, device="cpu", return_pems=True)
    np.testing.assert_array_equal(out.numpy(), np.sort(keys))
    # One round a superstep a process (v/P = k): both rerun merge, and
    # process 1 alone reruns partition when it died in it.
    reran = pems.shard_stats[0].rounds, pems.shard_stats[1].rounds
    assert reran == ((1, 2) if kind == "in" else (1, 1))


def test_a_fault_on_one_shard_reruns_that_process_alone(tmp_path):
    """``fault_spec="shard=1;kill@w…"``: process 1's disk dies mid-write;
    process 0's cursor is unaffected and only process 1 is behind."""
    sd = str(tmp_path / "state")
    assert_killed(run_child(sd, fault_spec="shard=1;kill@w2", P=2))
    curs = [json.load(open(os.path.join(sd, f"cursor.p{p}.json")))
            for p in range(2)]
    assert curs[0]["completed"] > curs[1]["completed"]
    keys = _chaos.keys()
    out = psrs_run_recoverable(torch.from_numpy(keys), v=_chaos.V,
                               k=_chaos.K, P=2, state_dir=sd,
                               io_queue_depth=4, device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.sort(keys))


def test_recoverable_run_refuses_what_jax_refuses(tmp_path, monkeypatch):
    keys = torch.arange(64, dtype=torch.int32)
    for kw in (dict(tier="host"), dict(tier="device"), dict(v=5)):
        args = dict(v=4, state_dir=str(tmp_path / "s"))
        args.update(kw)
        with pytest.raises(ValueError) as ref:
            apps.psrs_run_recoverable(keys.numpy(), **args)
        with pytest.raises(ValueError) as got:
            psrs_run_recoverable(keys, device="cpu", **args)
        assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match="unknown stage"):
        psrs_run_recoverable(keys, v=4, state_dir=str(tmp_path / "u"),
                             crash_in_stage="nope", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        psrs_run_recoverable(keys, v=4, state_dir=str(tmp_path / "c"))
