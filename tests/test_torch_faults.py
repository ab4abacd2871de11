"""The port's fault injection, checksum sidecars and I/O sanitizer
(``repro_torch.io.faults``, ``.checksum``, ``.sanitize``) against the JAX
package's (``repro.io``): the same fault spec parses to the same clauses and
fails the same driver calls with the same errnos and counters, the engine
spends the same retries and backoff on them, a sidecar written by either
package verifies under the other, and the sanitizer reports the same races.
"""

from __future__ import annotations

import dataclasses
import errno
import os

import numpy as np
import pytest
import torch

import _jax_ref  # noqa: F401  (the JAX package's import shim)
import repro.core.backing as jbacking
import repro.io as jio
from repro.io.checksum import span_plan as jspan_plan
from repro.io.faults import split_shard_clause as jsplit
from repro_torch import io as tio
from repro_torch.core import PemsConfig, make_backing
from repro_torch.io.checksum import span_plan
from repro_torch.io.faults import split_shard_clause
from repro_torch.pems_apps import psrs_sort

PACKAGES = (("jax", jio), ("port", tio))

GRAMMAR = [
    "seed=7; eio@p0.02:x2; lat@w0-3:0.003; torn@w44:0.25;"
    "enospc@b0-4095; kill@r12; eio@*",
    "eio@r5", "eio@w2-6:x3", "torn@b100-200", "torn@*:1", "lat@p0.5",
    "enospc@w*", "kill@w3", "seed=-4;eio@p0", "eio@p1", " ; eio@0 ;", "",
    None,
]
BAD = ["flip@*", "eio", "eio@z9", "eio@p1.5", "eio@*:k3", "torn@w0:0.0",
       "torn@w0:1.5", "lat@*:-1", "enospc@*:0.5", "kill@*:now", "seed=abc"]


def _clauses(fs):
    return fs.seed, [dataclasses.asdict(c) for c in fs.clauses]


@pytest.mark.parametrize("spec", GRAMMAR)
def test_fault_spec_parses_every_form_as_jax_does(spec):
    assert _clauses(tio.FaultSpec.parse(spec)) \
        == _clauses(jio.FaultSpec.parse(spec))


@pytest.mark.parametrize("bad", BAD)
def test_fault_spec_rejects_the_bad_forms_as_jax_does(bad):
    with pytest.raises(ValueError) as ref:
        jio.FaultSpec.parse(bad)
    with pytest.raises(ValueError) as got:
        tio.FaultSpec.parse(bad)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("spec", ["shard=1;eio@*", "eio@1; shard=0 ;lat@*",
                                  None, "", "seed=3", "shard=x", "shard=-1"])
def test_shard_clause_splits_as_jax_does(spec):
    try:
        ref = jsplit(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            split_shard_clause(spec)
        assert str(got.value) == str(e)
        return
    assert split_shard_clause(spec) == ref


def _drive(mod, path, spec, ops):
    """Run ``ops`` through ``mod``'s faulty driver; each call's outcome
    (bytes or errno), the bytes on disk and the counters."""
    f = mod.open_file(path, 1 << 16, "faulty:buffered", fault_spec=spec)
    trail = []
    try:
        for op, off, n in ops:
            try:
                if op == "w":
                    got = f.pwrite(off, np.full(n, off % 251, np.uint8))
                else:
                    buf = np.empty(n, np.uint8)
                    got = (f.pread_into(off, buf), buf.tobytes())
                trail.append(("ok", got))
            except OSError as e:
                trail.append(("err", e.errno))
        f.flush()
    finally:
        f.close()
    with open(path, "rb") as g:
        disk = g.read()
    return trail, disk, dict(f.injected)


@pytest.mark.parametrize("spec", [
    "seed=11;eio@p0.3;torn@wp0.2:0.4;lat@r1-2:0.0005",
    "eio@w1:x2;enospc@b8192-9000;torn@w5",
    "seed=2;eio@rp0.5:x3;eio@b0-100",
])
def test_faulty_driver_fails_the_same_calls_as_jax(tmp_path, spec):
    rng = np.random.default_rng(4)
    ops = [("w" if rng.random() < 0.6 else "r",
            int(rng.integers(0, 60000)), int(rng.integers(1, 5000)))
           for _ in range(60)]
    ref = _drive(jio, str(tmp_path / "j.bin"), spec, ops)
    got = _drive(tio, str(tmp_path / "t.bin"), spec, ops)
    assert got == ref
    assert any(kind == "err" for kind, _ in got[0])


def _engine(mod, path, spec, retries=2, depth=1):
    f = mod.open_file(path, 1 << 16, "faulty:buffered", fault_spec=spec)
    return f, mod.IOEngine(f, queue_depth=depth, retries=retries)


def _retry_run(mod, tmp_path, name, spec, retries):
    f, eng = _engine(mod, str(tmp_path / name), spec, retries)
    outcome = []
    try:
        for i in range(8):
            try:
                eng.submit_write(i * 4096, np.full(4096, i, np.uint8)).wait()
                outcome.append("ok")
            except OSError as e:
                outcome.append(e.errno)
        try:
            eng.drain()
        except OSError as e:
            outcome.append(("drain", e.errno))
    finally:
        eng.close()
    return (outcome, eng.retries, eng.backoff_s, eng.permanent_errors,
            dict(f.injected))


@pytest.mark.parametrize("spec, retries", [
    ("eio@w0:x2;eio@w5:x1", 2), ("eio@w0:x5", 2), ("eio@w3:x3", 3),
    ("enospc@w*", 3), ("enospc@w2;eio@w4", 1), ("lat@*:0.001", 2)])
def test_engine_retries_and_backoff_match_jax(tmp_path, spec, retries):
    ref = _retry_run(jio, tmp_path, "j.bin", spec, retries)
    got = _retry_run(tio, tmp_path, "t.bin", spec, retries)
    assert got == ref


def test_enospc_is_never_retried(tmp_path):
    f, eng = _engine(tio, str(tmp_path / "e.bin"), "enospc@w*", retries=3)
    try:
        req = eng.submit_write(0, np.zeros(4096, np.uint8))
        with pytest.raises(OSError) as ei:
            req.wait()
        assert ei.value.errno == errno.ENOSPC
        assert "injected ENOSPC" in str(ei.value)
        assert eng.retries == 0 and eng.permanent_errors == 1
        assert f.injected["enospc"] == 1
        with pytest.raises(OSError):
            eng.drain()
    finally:
        eng.close()


def test_drain_timeout_names_the_stuck_requests_under_latency(tmp_path):
    msgs = []
    for name, mod in PACKAGES:
        f, eng = _engine(mod, str(tmp_path / f"{name}.bin"), "lat@*:0.001",
                         depth=2)
        try:
            eng._gate.clear()           # hold workers: requests never finish
            eng.submit_write(8192, np.zeros(4096, np.uint8))
            with pytest.raises(TimeoutError) as ei:
                eng.drain(timeout=0.2)
            assert eng.in_flight == 1
            eng._gate.set()
            eng.drain()                 # and still completes once released
            assert eng.in_flight == 0 and f.injected["lat"] == 1
        finally:
            eng._gate.set()
            eng.close()
        msg = str(ei.value)
        assert f"{name}.bin" in msg and "8192" in msg and "in flight" in msg
        msgs.append(msg.split("age=")[0].replace(f"{name}.bin", "*"))
    assert msgs[0] == msgs[1]


def test_torn_write_is_silent_at_the_driver(tmp_path):
    f = tio.open_file(str(tmp_path / "torn.bin"), 1 << 14, "faulty:buffered",
                      fault_spec="torn@w0:0.25")
    try:
        assert f.pwrite(0, np.full(8192, 0xAB, np.uint8)) == 8192
        out = np.empty(8192, np.uint8)
        f.pread_into(0, out)
        assert (out[:2048] == 0xAB).all() and (out[2048:] == 0).all()
        assert f.injected["torn"] == 1
    finally:
        f.close()


# --------------------------------------------------------------------------- #
# Checksums                                                                    #
# --------------------------------------------------------------------------- #

def test_span_plan_matches_jax():
    rng = np.random.default_rng(8)
    for _ in range(200):
        chk = int(rng.choice([8, 64, 4096]))
        rowbytes = int(rng.integers(1, 6 * chk))
        cuts = np.unique(rng.integers(0, rowbytes + 1, 6))
        ranges = [(int(a), int(b)) for a, b in zip(cuts[::2], cuts[1::2])
                  if b > a]
        assert span_plan(ranges, chk, rowbytes) \
            == jspan_plan(ranges, chk, rowbytes)


def _corrupt(path, off):
    with open(path, "r+b") as f:
        f.seek(off)
        byte = f.read(1)
        f.seek(off)
        f.write(bytes([byte[0] ^ 0xFF]))


@pytest.mark.parametrize("tier", ["memmap", "file"])
def test_integrity_error_names_path_row_and_segment(tmp_path, tier):
    v, words = 8, 40000                 # rowbytes 160000: 3 segments a row
    errs = []
    for name, make in (("j", jbacking.make_backing), ("t", make_backing)):
        path = str(tmp_path / f"{name}.bin")
        bk = make(tier, v, words, path, checksum=True)
        bk.write_block(0, v, np.arange(v * words, dtype=np.uint32)
                       .reshape(v, words))
        bk.flush()
        _corrupt(path, 5 * words * 4 + 70000)
        with pytest.raises(OSError) as ei:
            bk.read_block(0, v)
        getattr(bk, "close", lambda: None)()
        e = ei.value
        assert e.errno == errno.EBADMSG
        assert (e.path, e.row, e.seg) == (path, 5, 1)
        assert path in str(e)
        errs.append(str(e).replace(path, "*"))
    assert isinstance(ei.value, tio.IntegrityError)
    assert errs[0] == errs[1]


@pytest.mark.parametrize("tier", ["memmap", "file"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_sidecar_verifies_under_the_other_package(tmp_path, tier, writer):
    v, words = 4, 20000
    path = str(tmp_path / "x.bin")
    first, second = ((jbacking.make_backing, make_backing) if writer == "jax"
                     else (make_backing, jbacking.make_backing))
    want = np.random.default_rng(1).integers(
        0, 2**32, (v, words), dtype=np.uint64).astype(np.uint32)
    bk = first(tier, v, words, path, checksum=True)
    bk.write_block(0, v, want)
    bk.write_block(1, 3, want[1:3, :7] + 1, cols=np.arange(3, 10))
    bk.flush()
    getattr(bk, "close", lambda: None)()
    want[1:3, 3:10] = want[1:3, :7] + 1
    other = second(tier, v, words, path, checksum=True)
    assert not (other.checksum.fresh)           # reused, not reseeded
    np.testing.assert_array_equal(other.read_block(0, v), want)
    getattr(other, "close", lambda: None)()
    _corrupt(path, 2 * words * 4 + 3)
    other = second(tier, v, words, path, checksum=True)
    with pytest.raises(OSError) as ei:
        other.read_block(2, 3)
    assert ei.value.errno == errno.EBADMSG and ei.value.row == 2
    getattr(other, "close", lambda: None)()


def test_sidecar_refuses_an_unknown_algorithm(tmp_path):
    path = str(tmp_path / "alg.bin")
    make_backing("memmap", 2, 1024, path, checksum=True).flush()
    with open(path + ".crc", "r+b") as f:
        f.seek(12)                      # the header's algorithm field
        f.write(np.uint32(7).tobytes())
    with pytest.raises(tio.IntegrityError, match="written with"):
        tio.ChecksumSidecar(path, 2, 4096)


def test_checksummed_file_backing_detects_an_injected_torn_write(tmp_path):
    v, words = 4, 2048
    b = make_backing("file", v, words, str(tmp_path / "torn.bin"),
                     io_driver="faulty:buffered",
                     fault_spec="torn@wb0-8191:0.3", checksum=True)
    try:
        data = np.arange(v * words, dtype=np.uint32).reshape(v, words)
        b.write_block(0, 1, data[:1])   # row 0's write is torn, silently
        b.write_block(1, v, data[1:])
        with pytest.raises(tio.IntegrityError) as ei:
            b.read_block(0, v)
        assert ei.value.row == 0
        np.testing.assert_array_equal(b.read_block(1, v), data[1:])
        b.recompute_checksums()         # bless what is on disk
        b.read_block(0, v)
    finally:
        b.close()


# --------------------------------------------------------------------------- #
# Configuration                                                                #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kw", [
    dict(tier="file", io_driver="faulty:uring"),
    dict(tier="file", io_driver="buffered", fault_spec="eio@*"),
    dict(tier="file", io_driver="faulty:buffered", fault_spec="flip@*"),
    dict(tier="file", io_driver="sanitize:"),
    dict(tier="file", io_driver="sanitize:buffered", fault_spec="eio@*"),
    dict(tier="host", checksums=True),
    dict(tier="device", checksums=True),
    dict(tier="file", P=2, io_driver="faulty:buffered",
         fault_spec="shard=2;eio@*"),
    dict(tier="host", io_driver="faulty:buffered"),
])
def test_config_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError) as ref:
        _jax_ref.core.PemsConfig(v=4, k=2, **kw)
    with pytest.raises(ValueError) as got:
        PemsConfig(v=4, k=2, **kw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("io_driver", ["faulty:buffered", "sanitize:odirect",
                                       "sanitize:faulty:mmap"])
def test_config_accepts_the_wrapper_chains(io_driver):
    spec = "seed=3;eio@p0.01" if "faulty" in io_driver else None
    cfg = PemsConfig(v=4, k=2, tier="file", io_driver=io_driver,
                     fault_spec=spec, checksums=True)
    assert cfg.io_driver == io_driver


# --------------------------------------------------------------------------- #
# The sanitizer                                                                #
# --------------------------------------------------------------------------- #

def _sanitized(mod, tmp_path, name):
    f = mod.open_file(str(tmp_path / name), 1 << 16, "sanitize:buffered")
    return f, mod.IOEngine(f, queue_depth=4)


def _plant_mutation(eng):
    eng._gate.clear()                   # hold the worker before its I/O
    buf = np.zeros(256, dtype=np.uint8)
    eng.submit_write(0, buf)
    buf[:8] = 7                         # the race under test
    eng._gate.set()
    eng.drain()


def test_a_planted_mutate_after_submit_is_one_finding_naming_the_caller(
        tmp_path):
    f, eng = _sanitized(tio, tmp_path, "s.bin")
    try:
        _plant_mutation(eng)
    finally:
        eng.close()
    assert [x.kind for x in f.findings] == ["mutate-in-flight"]
    assert "_plant_mutation" in f.findings[0].stack
    assert f.format_findings() == f.findings[0].format()
    assert tio.collect_findings(type("B", (), {"file": f})()) == f.findings


@pytest.mark.parametrize("plant", ["overlap-write", "overlap-read", "clean"])
def test_sanitizer_findings_match_jax(tmp_path, plant):
    kinds = []
    for name, mod in PACKAGES:
        f, eng = _sanitized(mod, tmp_path, f"{name}.bin")
        try:
            eng._gate.clear()
            eng.submit_write(0, np.ones(512, np.uint8))
            if plant == "overlap-write":
                eng.submit_write(256, np.full(512, 2, np.uint8))
            elif plant == "overlap-read":
                eng.submit_read(64, np.zeros(64, np.uint8))
            else:
                eng.submit_write(512, np.full(512, 2, np.uint8))
            eng._gate.set()
            eng.drain()
        finally:
            eng._gate.set()
            eng.close()
        kinds.append([(x.kind, x.op, x.offset, x.nbytes, x.detail)
                      for x in f.findings] + [f.tracked])
    assert kinds[0] == kinds[1]
    assert (len(kinds[1]) == 1) == (plant == "clean")


@pytest.mark.parametrize("P", [1, 2])
def test_psrs_under_the_sanitizer_is_race_free_and_matches_jax(tmp_path, P):
    keys = np.random.default_rng(29).integers(-2**31, 2**31 - 1, 1024,
                                              dtype=np.int32)
    out, pems = psrs_sort(torch.from_numpy(keys), v=4, k=2, driver="async",
                          P=P, tier="file", io_driver="sanitize:buffered",
                          io_queue_depth=4, device="cpu",
                          backing_path=str(tmp_path / "ctx.bin"),
                          return_pems=True)
    np.testing.assert_array_equal(out.numpy(), np.sort(keys))
    findings = tio.collect_findings(pems.backing)
    assert findings == [], "\n".join(f.format() for f in findings)
    shards = getattr(pems.backing, "shards", None) or [pems.backing]
    assert all(s.file.tracked > 0 for s in shards)
    ref, jpems = _jax_ref.apps.psrs_sort(
        keys, v=4, k=2, driver="async", P=P, tier="file",
        io_driver="sanitize:buffered", io_queue_depth=4,
        backing_path=str(tmp_path / "j.bin"), return_pems=True)
    assert [s.file.tracked for s in shards] == [
        s.file.tracked for s in getattr(jpems.backing, "shards", None)
        or [jpems.backing]]


def test_faults_on_one_shard_leave_the_others_clean(tmp_path):
    bk = make_backing("file", 8, 16, str(tmp_path / "sh.bin"), P=2,
                      io_driver="sanitize:faulty:buffered",
                      fault_spec="shard=1;eio@w0")
    ref = jbacking.make_backing("file", 8, 16, str(tmp_path / "jsh.bin"),
                                P=2, io_driver="sanitize:faulty:buffered",
                                fault_spec="shard=1;eio@w0")
    try:
        for b in (bk, ref):
            b.write_block(0, 8, np.arange(128, dtype=np.uint32)
                          .reshape(8, 16))
        assert [s.file.driver for s in bk.shards] \
            == [s.file.driver for s in ref.shards] \
            == ["sanitize:buffered", "sanitize:faulty:buffered"]
        assert bk.shards[1].file.inner.injected["eio"] == 1
        assert bk.shards[1].engine.retries == 1
    finally:
        bk.close()
        ref.close()
    with pytest.raises(ValueError, match="targets shard 2"):
        make_backing("file", 8, 16, str(tmp_path / "x.bin"), P=2,
                     io_driver="faulty:buffered", fault_spec="shard=2;eio@*")
    assert not os.path.exists(str(tmp_path / "x.bin.shard0"))
