"""The port's backings and I/O engine (``repro_torch.core.backing``,
``repro_torch.io``) against the JAX package's (``repro.core.backing``,
``repro.io``): the same block operations on both sides give the same words,
the same bytes on disk and the same measured counters.
"""

from __future__ import annotations

import errno
import threading

import numpy as np
import pytest
import torch

import _jax_ref  # noqa: F401  (the JAX package's import shim)
import repro.core.backing as jbacking
import repro.io as jio
from repro.core.iostats import IOLedger as JLedger, TierStats as JStats
from repro_torch import io as tio
from repro_torch.core import (ContextLayout, IOLedger, ShardedBacking,
                              TierStats, TieredStore, make_backing)
from repro_torch.core.backing import _cols_runs, shard_row_ranges

V, WORDS = 8, 40
COLS = {"all": None, "slice": slice(3, 17),
        "runs": np.array([0, 1, 2, 9, 10, 30, 31, 32, 33, 39])}
BACKINGS = [("host", None), ("memmap", None), ("file", "buffered"),
            ("file", "odirect"), ("file", "mmap")]


def _rows(seed, rows, n):
    return np.random.default_rng(seed).integers(
        0, 2**32, size=(rows, n), dtype=np.uint64).astype(np.uint32)


def _pair(tmp_path, tier, io_driver, P=1):
    """A JAX and a port backing of the same shape, each billing its own
    ledger and stats."""
    made = []
    for name, mod, led, st in (("jax", jbacking, JLedger(), JStats()),
                               ("port", None, IOLedger(), TierStats())):
        path = None if tier == "host" else str(tmp_path / f"{name}.bin")
        kw = dict(P=P, io_driver=io_driver, stats=st, ledger=led)
        if P > 1:
            kw.update(shard_stats=[type(st)() for _ in range(P)],
                      shard_ledgers=[type(led)() for _ in range(P)])
        make = mod.make_backing if mod is not None else make_backing
        made.append((make(tier, V, WORDS, path, **kw), led, kw))
    return made


def _disk_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("tier, io_driver", BACKINGS,
                         ids=[f"{t}-{d}" for t, d in BACKINGS])
@pytest.mark.parametrize("cols", list(COLS), ids=list(COLS))
def test_blocks_match_jax(tmp_path, tier, io_driver, cols):
    (jb, jled, _), (tb, tled, _) = _pair(tmp_path, tier, io_driver)
    sel = COLS[cols]
    n = _cols_runs(sel, WORDS)[1]
    jb.write_block(0, V, _rows(0, V, WORDS))
    tb.write_block(0, V, _rows(0, V, WORDS))
    for r0, r1, seed in ((1, 4, 1), (5, 6, 2), (0, 8, 3)):
        value = _rows(seed, r1 - r0, n)
        jb.write_block(r0, r1, value, cols=sel)
        tb.write_block(r0, r1, value, cols=sel)
    # A [1, n] value broadcasts along the rows, as bcast writes it.
    jb.write_block(2, 7, _rows(4, 1, n), cols=sel)
    tb.write_block(2, 7, _rows(4, 1, n), cols=sel)
    for r0, r1 in ((0, V), (3, 5)):
        want = jb.read_block(r0, r1, cols=sel)
        np.testing.assert_array_equal(tb.read_block(r0, r1, cols=sel), want)
        out = np.full((r1 - r0, n), 7, np.uint32)
        assert tb.read_block(r0, r1, cols=sel, out=out) is out
        np.testing.assert_array_equal(out, jb.read_block(r0, r1, cols=sel))
    jb.drain()
    tb.drain()
    jb.flush()
    tb.flush()
    if tier != "host":
        assert _disk_bytes(tb.path) == _disk_bytes(jb.path)
    if tier == "file":
        assert tb.file.fallback == jb.file.fallback
        assert tled.snapshot() == jled.snapshot()
        assert tled.syscall_read_bytes > 0 and tled.syscall_write_bytes > 0


def test_read_block_refuses_a_wrong_out_buffer(tmp_path):
    (_, _, _), (tb, _, _) = _pair(tmp_path, "host", None)
    with pytest.raises(ValueError, match="out="):
        tb.read_block(0, 2, out=np.empty((2, WORDS - 1), np.uint32))
    with pytest.raises(ValueError, match="out="):
        tb.read_block(0, 2, out=np.empty((2, WORDS), np.int32))


@pytest.mark.parametrize("tier, io_driver", [("memmap", None),
                                             ("file", "buffered")])
def test_sharded_backing_splits_global_rows_at_shard_boundaries(
        tmp_path, tier, io_driver):
    (jb, _, jkw), (tb, _, tkw) = _pair(tmp_path, tier, io_driver, P=2)
    assert isinstance(tb, ShardedBacking) and tb.m == V // 2
    assert list(shard_row_ranges(4, 2, 7)) == [(0, 2, 4), (1, 4, 7)]
    sel = COLS["runs"]
    n = _cols_runs(sel, WORDS)[1]
    for b in (jb, tb):
        b.write_block(0, V, _rows(5, V, WORDS))
        b.write_block(2, 7, _rows(6, 5, n), cols=sel)    # straddles shard 0/1
        b.drain()
    want = jb.read_block(1, 8, cols=sel)
    np.testing.assert_array_equal(tb.read_block(1, 8, cols=sel), want)
    out = np.empty((7, n), np.uint32)
    np.testing.assert_array_equal(tb.read_block(1, 8, cols=sel, out=out),
                                  jb.read_block(1, 8, cols=sel))
    for p in range(2):
        assert (_disk_bytes(f"{tb.path}.shard{p}")
                == _disk_bytes(f"{jb.path}.shard{p}"))
    if tier == "file":
        # Each shard's engine bills its own ledger, as in the JAX package.
        assert ([led.snapshot() for led in tkw["shard_ledgers"]]
                == [led.snapshot() for led in jkw["shard_ledgers"]])
        assert tb.shards[1].engine.name == "shard1"


def test_a_backing_file_reopens_with_its_contents(tmp_path):
    """Create-or-reuse: a JAX-written file backing reopens in the port as it
    is (never zeroed), and the other way round."""
    path = str(tmp_path / "reuse.bin")
    words = _rows(7, V, WORDS)
    jb = jbacking.make_backing("file", V, WORDS, path)
    jb.write_block(0, V, words)
    jb.flush()
    jb.close()
    for tier in ("memmap", "file"):
        tb = make_backing(tier, V, WORDS, path)
        np.testing.assert_array_equal(tb.read_block(0, V), words)
        tb.write_block(3, 4, words[:1])
        tb.flush()
        words[3] = words[0]
    jb = jbacking.make_backing("memmap", V, WORDS, path)
    np.testing.assert_array_equal(jb.read_block(0, V), words)


def test_tiered_store_fields_are_cpu_tensors_and_bill_the_ledger(tmp_path):
    lo = (ContextLayout().add("i", (3,), torch.int32)
          .add("f", (2,), torch.float32).add("u", (1,), torch.uint32))
    led = IOLedger()
    st = TieredStore(lo, make_backing("memmap", V, lo.words,
                                      str(tmp_path / "s.bin")), led)
    i = torch.arange(V * 3, dtype=torch.int64).reshape(V, 3) - 5
    st.with_field("i", i)                     # converted to int32
    st.with_field("f", np.full((V, 2), 0.25))  # numpy, float64 -> float32
    st.with_field_rows("u", 2, torch.tensor([[7], [8]], dtype=torch.uint32))
    got = st.field("i")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert torch.equal(got, i.to(torch.int32))
    assert torch.equal(st.field("f"), torch.full((V, 2), 0.25))
    assert st.field_rows("u", 2, 4).view(torch.int32).flatten().tolist() \
        == [7, 8]
    assert st.data.dtype == torch.int32 and st.data.shape == (V, lo.words)
    # One count per physical access: 3 + 2 + 1 words written, 3 + 2 + 1
    # read, a row each.
    assert led.disk_write_bytes == (V * 3 + V * 2 + 2 * 1) * 4
    assert led.disk_read_bytes == (V * 3 + V * 2 + 2 * 1) * 4
    host = TieredStore(lo, make_backing("host", V, lo.words), IOLedger())
    host.with_field("i", i)
    assert host.ledger.disk_write_bytes == 0


@pytest.mark.parametrize("driver", ["faulty:buffered", "sanitize:buffered"])
def test_wrapped_drivers_and_checksums_name_item_6(tmp_path, driver):
    """The wrapped drivers and checksums of ROADMAP.md queue 1 item 6 run as
    the JAX package's: the same wrapper chain and block bytes, the same
    sidecar bytes, and the same ``ValueError`` for an unknown driver or a
    ``fault_spec`` without a faulty driver."""
    spec = "eio@1" if driver.startswith("faulty") else None
    files = [mod.open_file(str(tmp_path / f"{name}.bin"), 4096, driver,
                           fault_spec=spec)
             for name, mod in (("j", jio), ("t", tio))]
    for f in files:
        f.pwrite(128, np.arange(64, dtype=np.uint8))
        f.flush()
    assert files[0].driver == files[1].driver == driver
    assert _disk_bytes(str(tmp_path / "j.bin")) \
        == _disk_bytes(str(tmp_path / "t.bin"))
    for f in files:
        f.close()
    made = [make(tier, V, WORDS, str(tmp_path / f"c{name}.bin"),
                 io_driver=driver, fault_spec=spec, checksum=True)
            for name, make, tier in (("j", jbacking.make_backing, "file"),
                                     ("t", make_backing, "file"))]
    for bk in made:
        bk.write_block(0, V, _rows(5, V, WORDS))
        bk.write_block(1, 3, _rows(6, 2, 5), cols=COLS["runs"][:5])
        bk.flush()
    np.testing.assert_array_equal(made[1].read_block(0, V),
                                  made[0].read_block(0, V))
    for suffix in ("", ".crc"):
        assert _disk_bytes(str(tmp_path / "cj.bin") + suffix) \
            == _disk_bytes(str(tmp_path / "ct.bin") + suffix), suffix
    for bk in made:
        bk.close()
    for mod in (jio, tio):
        with pytest.raises(ValueError, match="unknown io driver"):
            mod.open_file(str(tmp_path / "w.bin"), 4096, "tape")
        with pytest.raises(ValueError, match="requires a 'faulty:"):
            mod.open_file(str(tmp_path / "w.bin"), 4096, "buffered",
                          fault_spec="eio@*")


# --------------------------------------------------------------------------- #
# The engine                                                                   #
# --------------------------------------------------------------------------- #

class _Stub:
    """A driver file in memory whose reads fail with ``code`` the first
    ``fails`` times."""

    align = 1
    driver = "stub"
    path = "stub"

    def __init__(self, fails=0, code=errno.EIO):
        self.data = bytearray(range(256)) * 16
        self.fails = fails
        self.code = code
        self.calls = 0

    def pread_into(self, offset, out):
        self.calls += 1
        if self.calls <= self.fails:
            raise OSError(self.code, "injected")
        mv = memoryview(out).cast("B")
        mv[:] = self.data[offset:offset + len(mv)]
        return len(mv)

    def pwrite(self, offset, data):
        mv = memoryview(np.ascontiguousarray(data)).cast("B")
        self.data[offset:offset + len(mv)] = mv
        return len(mv)

    def flush(self):
        pass

    def close(self):
        pass


def _engines(**kw):
    return [mod.IOEngine(_Stub(**{k: v for k, v in kw.items()
                                  if k in ("fails", "code")}),
                         **{k: v for k, v in kw.items()
                            if k not in ("fails", "code")})
            for mod in (jio, tio)]


@pytest.mark.parametrize("fails, retries", [(0, 2), (2, 2), (3, 2), (1, 0)])
def test_engine_retries_a_transient_errno_as_jax_does(fails, retries):
    results = []
    for eng in _engines(fails=fails, retries=retries, backoff_s=1e-4):
        out = np.zeros(64, np.uint8)
        req = eng.submit_read(100, out)
        try:
            eng.wait([req])
            ok = True
        except OSError as e:
            assert e.errno == errno.EIO
            ok = False
        results.append((ok, eng.retries, eng.backoff_s, eng.permanent_errors,
                        req.attempts, out.tobytes()))
        eng.close()
    assert results[1] == results[0]
    assert results[1][0] == (fails <= retries)


def test_engine_does_not_retry_a_permanent_errno():
    eng = tio.IOEngine(_Stub(fails=1, code=errno.ENOSPC), retries=3)
    with pytest.raises(OSError):
        eng.wait([eng.submit_read(0, np.zeros(8, np.uint8))])
    assert eng.retries == 0 and eng.permanent_errors == 1
    assert errno.ENOSPC not in tio.TRANSIENT_ERRNOS
    eng.close()


def test_engine_bounds_its_queue_and_drains():
    stats = TierStats()
    eng = tio.IOEngine(_Stub(), queue_depth=2, stats=stats)
    eng._gate.clear()                     # hold every request in flight
    bufs = [np.zeros(16, np.uint8) for _ in range(3)]
    reqs = [eng.submit_read(16 * i, bufs[i]) for i in range(2)]
    assert eng.in_flight == 2
    third = []
    t = threading.Thread(target=lambda: third.append(
        eng.submit_read(32, bufs[2])))
    t.start()
    t.join(0.2)
    assert t.is_alive() and not third     # a full queue blocks the submit
    with pytest.raises(TimeoutError, match="still in flight"):
        eng.drain(timeout=0.05)
    eng._gate.set()
    t.join(5)
    assert not t.is_alive()
    eng.drain()
    assert eng.in_flight == 0
    assert all(r.done for r in reqs + third)
    assert stats.max_queue_depth == 2 and stats.queue_stall_s > 0
    assert bufs[1].tobytes() == bytes(range(16, 32))
    # A write's error surfaces at drain, after the waited-for ones.
    eng.file.fails, eng.file.calls = 10, 0
    eng.submit_read(0, np.zeros(4, np.uint8))
    with pytest.raises(OSError):
        eng.drain()
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit_read(0, np.zeros(4, np.uint8))


def test_aligned_pool_recycles_aligned_buffers():
    pool = tio.AlignedPool()
    buf = pool.acquire(5000)
    assert buf.ctypes.data % tio.ALIGN == 0 and buf.nbytes == 8192
    pool.release(buf)
    assert pool.acquire(8000) is buf
    assert tio.align_up(4097) == 8192 and tio.align_down(4097) == 4096
