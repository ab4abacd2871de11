"""The port's checkpoint manager (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``): save, restore, keep-k retention, a crash
mid-save, a corrupted chunk falling back to the previous step, memmap leaves
streamed in place, tensors restored onto their ``like`` leaf's device, and
checkpoints written by either package restored by the other.
"""

from __future__ import annotations

import collections
import json
import os
import shutil

import numpy as np
import pytest
import torch

import _jax_ref  # noqa: F401  (the JAX package's import shim)
from repro.checkpoint.manager import CheckpointManager as JManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as tmanager
from repro_torch.io.npyio import create_npy_memmap

Pair = collections.namedtuple("Pair", "lo hi")


def _state(seed=0):
    """Numpy leaves in dicts, lists, tuples and a namedtuple, one 0-d."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 33)).astype(np.float32),
            "opt": [np.arange(5, dtype=np.int64),
                    (np.int32(7) * np.ones((3, 2), np.int32),
                     np.asarray(2.5))],
            "pair": Pair(rng.integers(0, 9, (4,)).astype(np.uint32),
                         rng.integers(0, 9, (2, 2, 2)).astype(np.int16)),
            "empty": np.zeros((0, 4), np.float64)}


def _leaves(tree):
    return [np.asarray(x) for _, x in tmanager._flatten(tree)]


def _assert_same(got, want, dtypes=True):
    """Equal leaves; ``dtypes=False`` for the JAX package's restores, which
    place 64-bit arrays on the device as 32-bit ones."""
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and (x.dtype == y.dtype or not dtypes)
        np.testing.assert_array_equal(x, y)


def test_flatten_gives_jax_key_strings_and_order():
    import jax
    state = _state()
    ref = jax.tree_util.tree_flatten_with_path(state)[0]
    got = list(tmanager._flatten(state))
    assert [k for k, _ in got] == [jax.tree_util.keystr(p) for p, _ in ref]
    assert all(a is b for (_, a), (_, b) in zip(got, ref))
    rebuilt = tmanager._unflatten(state, iter([x for _, x in got]))
    assert rebuilt.keys() == state.keys()
    assert isinstance(rebuilt["pair"], Pair)
    assert isinstance(rebuilt["opt"][1], tuple)
    assert list(tmanager._flatten({"a": None, "b": [None, 1]})) == [
        ("['b'][1]", 1)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_checkpoint_restores_in_the_other_package(tmp_path, writer):
    state = _state(1)
    mk = {"jax": JManager, "port": CheckpointManager}
    w = mk[writer](str(tmp_path / "ck"))
    r = mk["port" if writer == "jax" else "jax"](str(tmp_path / "ck"))
    w.save(3, state)
    w.save(4, _state(2))
    man = json.load(open(tmp_path / "ck" / "step_000000000004" /
                         "manifest.json"))
    assert man["version"] == 2
    assert all(a["chunk_crcs"] or a["shape"][0] == 0 for a in man["arrays"])
    step, got = r.restore_latest(like=state)
    assert step == 4
    _assert_same(got, _state(2), dtypes=writer == "jax")
    _assert_same(r.restore(3, like=state), state, dtypes=writer == "jax")
    flat = r.restore(3)                     # no like: a list of arrays
    for x, y in zip(flat, _leaves(state)):
        np.testing.assert_array_equal(np.asarray(x), y)


def test_manifests_match_jax_but_for_the_time(tmp_path):
    state = _state(3)
    JManager(str(tmp_path / "j")).save(9, state)
    CheckpointManager(str(tmp_path / "t")).save(9, state)
    d = "step_000000000009"
    mans = [json.load(open(tmp_path / x / d / "manifest.json"))
            for x in ("j", "t")]
    for m in mans:
        m.pop("time")
    assert mans[0] == mans[1]
    for name in sorted(os.listdir(tmp_path / "j" / d)):
        if name.endswith(".npy"):
            assert (tmp_path / "t" / d / name).read_bytes() \
                == (tmp_path / "j" / d / name).read_bytes()


def test_tensor_leaves_restore_on_their_like_device(tmp_path):
    m = CheckpointManager(str(tmp_path / "ck"))
    state = {"t": torch.arange(12, dtype=torch.float32).reshape(3, 4),
             "i": torch.tensor([5, -6], dtype=torch.int32),
             "n": np.ones(3, np.float32)}
    m.save(1, state, blocking=False)
    state["t"].add_(100)                    # the save copied it already
    m.wait()
    step, got = m.restore_latest(like=state)
    assert step == 1
    assert isinstance(got["t"], torch.Tensor) and got["t"].device.type \
        == "cpu"
    assert torch.equal(got["t"], torch.arange(12, dtype=torch.float32)
                       .reshape(3, 4))
    assert got["i"].dtype == torch.int32 and got["i"].tolist() == [5, -6]
    assert isinstance(got["n"], np.ndarray)
    # The JAX package reads the tensors' arrays.
    _, ref = JManager(str(tmp_path / "ck")).restore_latest(
        like={k: np.asarray(v) for k, v in state.items()})
    np.testing.assert_array_equal(np.asarray(ref["t"]),
                                  got["t"].numpy())


def test_keep_k_retention_keeps_the_newest(tmp_path):
    m = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for s in range(5):
        m.save(s, {"x": np.full(4, s, np.int32)})
    assert sorted(m._steps()) == [3, 4]
    assert m.restore_latest(like={"x": np.zeros(4, np.int32)})[0] == 4
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest() \
        is None


def test_a_crash_mid_save_keeps_the_prior_step(tmp_path):
    d = str(tmp_path / "ck")
    m = CheckpointManager(d, keep=5)
    state = {"w": np.arange(256, dtype=np.float32)}
    m.save(7, state)
    # A crash mid-save of step 8: its file written, its manifest torn.
    tmp = os.path.join(d, "step_000000000008.tmp")
    shutil.copytree(os.path.join(d, "step_000000000007"), tmp)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        f.write('{"step": 8, "arrays": [')
    got = m.restore_latest(like=state)
    assert got is not None and got[0] == 7
    np.testing.assert_array_equal(got[1]["w"], state["w"])
    # A fresh save of the same step cleans the staging dir and commits.
    m.save(8, {"w": state["w"] + 1})
    assert m.restore_latest(like=state)[0] == 8
    assert not os.path.exists(tmp)


def test_a_corrupted_chunk_falls_back_to_the_previous_step(tmp_path):
    m = CheckpointManager(str(tmp_path / "ck"), keep=5)
    state = {"w": np.arange(4096, dtype=np.float32).reshape(64, 64)}
    m.save(1, state)
    m.save(2, {"w": state["w"] * 2})
    shard = str(tmp_path / "ck" / "step_000000000002" / "arr_00000.npy")
    with open(shard, "r+b") as f:
        f.seek(500)
        byte = f.read(1)
        f.seek(500)
        f.write(bytes([byte[0] ^ 0xFF]))
    for mgr in (m, JManager(str(tmp_path / "ck"))):
        with pytest.raises(IOError, match="checksum mismatch"):
            mgr.restore(2, like=state)
        step, got = mgr.restore_latest(like=state)
        assert step == 1
        np.testing.assert_array_equal(np.asarray(got["w"]), state["w"])


def test_memmap_leaves_stream_through_the_engine(tmp_path, monkeypatch):
    # Small chunks so the copy takes many engine requests.
    monkeypatch.setattr(tmanager, "_STREAM_CHUNK_BYTES", 4096)
    src = create_npy_memmap(str(tmp_path / "src.npy"), np.uint32, (300, 40))
    src[:] = np.arange(src.size, dtype=np.uint32).reshape(src.shape)
    src.flush()
    writes = []
    real = tmanager.IOEngine.submit_write

    def spy(self, offset, data, auto_reap=False):
        writes.append(offset)
        return real(self, offset, data, auto_reap)

    monkeypatch.setattr(tmanager.IOEngine, "submit_write", spy)
    m = CheckpointManager(str(tmp_path / "ck"))
    m.save(5, {"store": src, "meta": np.arange(3)})
    assert len(writes) == -(-300 // (4096 // (160 * 4)))
    man = json.load(open(tmp_path / "ck" / "step_000000000005" /
                         "manifest.json"))
    assert [a["memmap"] for a in man["arrays"]] == [False, True]
    dst = create_npy_memmap(str(tmp_path / "dst.npy"), np.uint32, (300, 40))
    writes.clear()
    step, got = m.restore_latest(like={"store": dst, "meta": np.zeros(3)})
    assert got["store"] is dst and len(writes) > 1
    np.testing.assert_array_equal(np.asarray(dst), np.asarray(src))
    # The JAX package restores the port's memmap checkpoint in place too.
    monkeypatch.setattr("repro.checkpoint.manager._STREAM_CHUNK_BYTES", 4096)
    dst2 = create_npy_memmap(str(tmp_path / "dst2.npy"), np.uint32,
                             (300, 40))
    JManager(str(tmp_path / "ck")).restore(5, like={"store": dst2,
                                                    "meta": np.zeros(3)})
    np.testing.assert_array_equal(np.asarray(dst2), np.asarray(src))
    bad = create_npy_memmap(str(tmp_path / "bad.npy"), np.uint32, (299, 40))
    with pytest.raises(IOError, match="memmap leaf mismatch"):
        m.restore(5, like={"store": bad, "meta": np.zeros(3)})
