"""The PEMS2 superstep executor, device tier.

Simulates ``v`` virtual processors on ``P`` real processors with ``k``
concurrently-resident contexts per real processor, exactly the thesis' model
(§3.2): execution proceeds in deterministic ID-ordered rounds of ``P·k``
virtual processors (§6.5); real processor ``p`` runs its ``v/(P·k)`` rounds
over its own contexts ``[p·v/P, (p+1)·v/P)``.  ``P > 1`` needs a
:class:`~.mesh.Mesh` of ``P`` entries: on one device the store is one ``[v,
words]`` tensor whose row blocks are the processes; over a mesh of cards
(:attr:`~.mesh.Mesh.spans_devices`) it is a :class:`~.context.MeshStore`,
process ``p``'s block on card ``p``, where its rounds run, every card at once
(one host thread queues them all, with no synchronisation between them).  A
stage function takes the round's IDs ``rhos [k]`` and a batched
:class:`~.context.Ctx` over the round's ``[k, words]`` block — the explicit
form of the JAX package's ``vmap`` — and returns the context.

Drivers (§5):
  * ``explicit`` — every round swaps the full *live* context in and out.  On
    the device tier the round's block is a view of the store and the stage
    updates it in place.
  * ``sliced``   — the superstep declares which fields it reads/writes; the
    stage sees only the declared read fields (the rest of its view is zero)
    and only the declared write fields land back in the store.
  * ``async``    — double-buffered rounds: round ``r+1``'s block is copied
    into a second buffer on a side CUDA stream while round ``r`` computes,
    and each round's result is copied back (the STXXL-file driver of §5.1).

All drivers produce bit-identical results; they differ in bytes moved (the
ledger) and in schedule.

Backing tiers (:mod:`.backing`): with ``tier="host"``, ``"memmap"`` or
``"file"`` the ``[v, words]`` population lives off the card (host RAM, an
``np.memmap`` file, or a file behind the :mod:`repro_torch.io` engine) and
the round loop becomes a host-driven pipeline (``_run_tiered``): each
round's ``k`` contexts — live or declared words only (§6.6) — are gathered
into a pinned host buffer, copied to the card on a side CUDA stream,
computed, copied back into a pinned buffer and written to the backing.
Under the ``async`` driver (and for a ``stream=True`` stage on a disk
backing under any driver) a prefetch thread reads round ``r+1`` while round
``r`` computes, and on the ``file`` tier the writeback stays in flight on
the engine's queue, so both directions overlap compute (the STXXL-file
driver, §5.1).  With ``P > 1`` the backing is sharded, one shard, engine,
ledger and stats per real processor; no mesh is needed.  The ledger records
the measured traffic beside the modeled counters, ``Pems.tier_stats`` the
wall-clock overlap.  On a disk tier ``checksums`` keeps CRC sidecars on
the backing, ``io_driver="faulty:<inner>"`` with a ``fault_spec`` injects
I/O faults and ``"sanitize:<inner>"`` records in-flight races;
``Pems.cursors`` (durable :class:`~.recovery.SuperstepCursor` objects, one a
process) receive each round's progress note — the recovery protocol of
:func:`repro_torch.pems_apps.psrs_run_recoverable`.  With ``trace=True``
the executor records the JAX package's spans (:mod:`repro_torch.obs`):
supersteps, rounds, engine requests, collective chunks and recovery
windows, exported as one Chrome/Perfetto trace by :meth:`Pems.export_trace`.
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..io.faults import FaultSpec, split_shard_clause
from ..obs import NOOP, Tracer, merge_trace_files, trace_events, write_trace
from .backing import (
    IO_DRIVERS,
    TIERS,
    ColRuns,
    TieredStore,
    make_backing,
    shard_row_ranges,
)
from .context import (
    Ctx,
    ContextLayout,
    ContextStore,
    MeshStore,
    device_scope,
    init_mesh_store,
    init_store,
    resolve_device,
)
from .iostats import IOLedger, TierStats
from .mesh import Mesh, canonical

DRIVERS = ("explicit", "sliced", "async")


@dataclasses.dataclass
class PemsConfig:
    """Simulation parameters (thesis Appendix B.3), for the ported slice.

    * ``v``/``P``/``k`` — total virtual processors, real processors and
      concurrently-resident contexts per real processor.  ``v`` must divide
      by ``P`` and ``v/P`` by ``k``; each real processor runs its ``v/P``
      contexts in ``v/(P·k)`` ID-ordered rounds (§6.5).
    * ``alpha`` — Alltoallv network chunk: how many destination contexts
      are shipped at once (Alg 7.1.3), ``1 <= alpha <= v/P``, or ``None``
      for one unchunked exchange.  ``vp_axis`` names the mesh axis.
    * ``driver`` — round swap strategy: ``explicit`` (full live context),
      ``sliced`` (declared fields only), ``async`` (double-buffered
      prefetch, §5.1).  Bit-identical results; different bytes/schedule.
    * ``tier`` — where the ``[v, words]`` population lives: ``device``
      (one tensor on the card), ``host`` (RAM), ``memmap`` (disk via
      ``np.memmap``), ``file`` (disk via the :mod:`repro_torch.io` engine).
      With ``P > 1`` a backing tier is sharded: process ``p`` owns rows
      ``[p·v/P, (p+1)·v/P)`` in its own backing (``backing_path +
      ".shard<p>"``) with its own ``pems.shard_ledgers[p]``/
      ``shard_stats[p]``, and no mesh is needed.
    * ``backing_path`` — disk tiers: backing file location (created sparse
      at ``v·μ`` bytes; existing contents are reused, never zeroed).
    * ``io_driver``/``io_queue_depth``/``io_retries``/``io_backoff_s`` —
      file tier only: positional-I/O driver (``buffered``/``odirect``/
      ``mmap``, default ``buffered``, optionally wrapped as
      ``"faulty:<driver>"``/``"sanitize:<driver>"``), bounded in-flight
      requests, transient-error retries per request, and base backoff
      seconds (doubles per retry).
    * ``fault_spec`` — what the faulty driver injects (the grammar of
      :mod:`repro_torch.io.faults`).  A ``shard=N`` clause (``0 <= N <
      P``) targets one shard's driver only — the single-disk-failure model.
    * ``checksums`` — disk tiers: per-64 KiB-segment CRC sidecars on the
      backing, verified on every read (torn-write detection).
    * ``block_bytes`` — B, the *modeled* ledger block size (bytes).
    * ``device_cap_bytes`` — device-memory budget (bytes) for the resident
      contexts: ``v·μ`` on the device tier, the in-flight round blocks on a
      backing tier; construction fails if the config cannot fit, and the
      tiered Alltoallv clamps its chunks under it.
    * ``merge_kernel``/``merge_tile`` — app-level merge stages (PSRS): route
      the merge through the tiled k-way merge kernel in ``merge_tile``-wide
      output tiles, instead of the dense re-sort of the received buckets.
      Bit-identical either way; ``merge_tile`` must be a power of two.
    * ``trace``/``trace_path`` — :mod:`repro_torch.obs` span tracing: record
      superstep/round/engine/collective/recovery spans into per-process
      ring buffers (results are bit-identical; off, the path pays one
      attribute check and adds no device synchronisation).  ``trace_path``
      is where :meth:`Pems.export_trace` writes the merged Perfetto JSON
      (and requires ``trace``).

    Raises ``ValueError`` at construction for any invalid combination —
    unknown driver, tier or I/O driver names, ``io_driver`` without
    ``tier="file"``, ``fault_spec`` without a faulty driver or targeting a
    shard ``>= P``, ``checksums`` on a non-disk tier, out-of-range ``io_*``
    knobs, a bad ``merge_tile``, ``trace_path`` without ``trace``,
    indivisible ``v``/``P``/``k``, out-of-range ``alpha``.
    """

    v: int                      # total virtual processors
    k: int = 1                  # concurrently-resident contexts
    P: int = 1                  # real processors
    block_bytes: int = 4096     # B — ledger block size
    driver: str = "explicit"
    alpha: Optional[int] = None
    vp_axis: str = "vp"
    tier: str = "device"
    backing_path: Optional[str] = None
    device_cap_bytes: Optional[int] = None  # device-memory budget for contexts
    io_driver: Optional[str] = None
    io_queue_depth: int = 8
    io_retries: int = 2
    io_backoff_s: float = 0.002
    fault_spec: Optional[str] = None
    checksums: bool = False
    merge_kernel: bool = True   # app merge stages: tiled k-way merge kernel
    merge_tile: int = 256       # k-way merge output tile width (power of two)
    trace: bool = False
    trace_path: Optional[str] = None

    def __post_init__(self):
        if self.driver not in DRIVERS:
            raise ValueError(f"unknown driver {self.driver!r}")
        if self.tier not in TIERS:
            raise ValueError(f"unknown tier {self.tier!r} (choose from {TIERS})")
        # The io knobs fail here, at construction, like every other field.
        if self.tier == "file":
            if self.io_driver is None:
                self.io_driver = "buffered"
            parts = self.io_driver.split(":")
            base, wrappers = parts[-1], parts[:-1]
            if base not in IO_DRIVERS or not all(
                    w in ("faulty", "sanitize") for w in wrappers):
                raise ValueError(
                    f"unknown io_driver {self.io_driver!r} "
                    f"(choose from {IO_DRIVERS}, optionally wrapped as "
                    "'faulty:<driver>' / 'sanitize:<driver>')"
                )
        elif self.io_driver is not None:
            raise ValueError(
                f"io_driver={self.io_driver!r} requires tier='file' "
                f"(got tier={self.tier!r})"
            )
        if self.fault_spec is not None:
            if "faulty" not in (self.io_driver or "").split(":")[:-1]:
                raise ValueError(
                    "fault_spec requires io_driver='faulty:<driver>' on "
                    f"tier='file' (got io_driver={self.io_driver!r}, "
                    f"tier={self.tier!r})"
                )
            shard, rest = split_shard_clause(self.fault_spec)
            if shard is not None and shard >= self.P:
                raise ValueError(
                    f"fault_spec targets shard {shard} but P={self.P} "
                    f"(shard indices are 0..P-1)"
                )
            FaultSpec.parse(rest)   # syntax errors fail here
        if self.checksums and self.tier not in ("memmap", "file"):
            raise ValueError(
                f"checksums=True requires a disk tier ('memmap' or 'file'), "
                f"got tier={self.tier!r}"
            )
        if self.io_retries != int(self.io_retries) or self.io_retries < 0:
            raise ValueError(
                f"io_retries={self.io_retries!r} must be an integer >= 0")
        self.io_retries = int(self.io_retries)
        if self.io_backoff_s < 0:
            raise ValueError(
                f"io_backoff_s={self.io_backoff_s!r} must be >= 0")
        if (self.io_queue_depth != int(self.io_queue_depth)
                or self.io_queue_depth < 1):
            raise ValueError(
                f"io_queue_depth={self.io_queue_depth!r} must be an "
                "integer >= 1"
            )
        self.io_queue_depth = int(self.io_queue_depth)
        if (self.merge_tile != int(self.merge_tile) or self.merge_tile < 2
                or int(self.merge_tile) & (int(self.merge_tile) - 1)):
            raise ValueError(
                f"merge_tile={self.merge_tile!r} must be a power-of-two "
                "integer >= 2 (one k-way merge grid step per tile)"
            )
        self.merge_tile = int(self.merge_tile)
        if self.trace_path is not None and not self.trace:
            raise ValueError(
                f"trace_path={self.trace_path!r} requires trace=True "
                "(nothing records spans to export otherwise)"
            )
        if self.v % self.P:
            raise ValueError("v must be divisible by P")
        if (self.v // self.P) % self.k:
            raise ValueError("v/P must be divisible by k")
        if self.alpha is not None:
            # The Alltoallv network chunk (Alg 7.1.3): validated here so
            # every consumer (network phase, ledger rounds) sees a sane one.
            if self.alpha != int(self.alpha):
                raise ValueError(
                    f"alpha={self.alpha!r} must be an integer chunk size"
                )
            self.alpha = int(self.alpha)
            if not 1 <= self.alpha <= self.v_local:
                raise ValueError(
                    f"alpha={self.alpha} out of range: the Alltoallv "
                    f"network chunk must satisfy 1 <= alpha <= v/P = "
                    f"{self.v_local} (alpha=None means unchunked, one "
                    "chunk of v/P destinations)"
                )

    @property
    def v_local(self) -> int:
        return self.v // self.P

    @property
    def rounds(self) -> int:
        return self.v_local // self.k


class Pems:
    """Executor: superstep engine + I/O ledger, on one device (CUDA unless
    ``device`` names another; the CPU runs the kernels' plain versions).
    ``P > 1`` on the device tier needs a ``mesh`` with ``P`` entries along
    ``cfg.vp_axis``: on that device (:func:`~.mesh.make_mesh`), or a mesh of
    cards whose first is that device (``Mesh(["cuda:0", ..., "cuda:3"])``:
    the store is then a :class:`~.context.MeshStore`); a backing tier
    shards instead.  Collective methods are bound from
    :mod:`repro_torch.core.collectives`."""

    def __init__(self, cfg: PemsConfig, layout: ContextLayout,
                 mesh: Optional[Mesh] = None, device=None):
        self.cfg = cfg
        self.layout = layout
        self.device = resolve_device(device)
        self.mesh = mesh
        self.ledger = IOLedger()
        self.tier_stats = TierStats()
        # Per-process accounting (the parallel disk model, §6.3).  At
        # P == 1 (or on the device tier) the shard lists alias the main
        # ledger/stats; at P > 1 each shard's backing bills its own entry
        # and merged_shard_ledger() recovers the P == 1 totals.
        if cfg.P == 1 or cfg.tier == "device":
            self.shard_ledgers = [self.ledger]
            self.shard_stats = [self.tier_stats]
        else:
            self.shard_ledgers = [IOLedger() for _ in range(cfg.P)]
            self.shard_stats = [TierStats() for _ in range(cfg.P)]
        self.backing = None   # last backing this executor created (tiered)
        self.cursors = None   # optional per-process durable SuperstepCursors:
                              # when set, the tiered round loop notes rounds
        self._bufs = None     # the tiered round loop's staging buffers
        # Span tracing: the main tracer (stage/superstep/collective lanes,
        # pid 0 on export) plus one tracer per process for the round loop
        # and its shard's engine (pid p+1), all on one shared epoch so the
        # merged trace has comparable timestamps.  Disabled, everything
        # aliases the NOOP singleton: instrumented code pays one attribute
        # check, and results are bit-identical either way.
        if cfg.trace:
            self.tracer = Tracer(name="main")
            if cfg.tier == "device":
                self.shard_tracers = [self.tracer]
            else:
                self.shard_tracers = [
                    Tracer(epoch=self.tracer.epoch, name=f"shard{p}")
                    for p in range(cfg.P)
                ]
        else:
            self.tracer = NOOP
            self.shard_tracers = [NOOP] * max(1, cfg.P)
        if cfg.P > 1 and cfg.tier == "device" and mesh is None:
            raise ValueError("P > 1 requires a mesh with the vp axis "
                             "(device tier; backing tiers shard instead)")
        if mesh is not None:
            if mesh.shape.get(cfg.vp_axis) != cfg.P:
                raise ValueError(
                    f"mesh axis {cfg.vp_axis}="
                    f"{mesh.shape.get(cfg.vp_axis)} != P={cfg.P}")
            first = canonical(mesh.devices[0])
            if first != canonical(self.device):
                raise ValueError(
                    f"the mesh lies on {first} but the executor on "
                    f"{self.device}")
        # Over a mesh of cards each process's row block lives on its own
        # card; ``devices`` are the cards the device tier's work runs on.
        self.cards = (mesh is not None and cfg.P > 1
                      and mesh.spans_devices)
        self.devices = list(mesh.devices) if self.cards else [self.device]
        if cfg.device_cap_bytes is not None:
            # The device tier must fit the whole population; a backing tier
            # its in-flight round blocks — input + output, plus the
            # prefetched next block under the double-buffered async driver.
            if cfg.tier == "device":
                need, what = cfg.v * layout.mu_bytes, "v·mu"
            else:
                bufs = 3 if cfg.driver == "async" else 2
                need = bufs * cfg.k * layout.mu_bytes
                what = f"{bufs}·k·mu in-flight round blocks"
            if need > cfg.device_cap_bytes:
                raise ValueError(
                    f"device-resident contexts need {need:,} bytes ({what}) "
                    f"but device_cap_bytes={cfg.device_cap_bytes:,}; "
                    "lower k or use tier='host'/'memmap'/'file'"
                )
        # PEMS2 disk requirement: exactly vμ/P per real processor (§6.3).
        self.ledger.require_disk(cfg.v * layout.mu_bytes // cfg.P)
        for led in self.shard_ledgers:
            led.require_disk(cfg.v * layout.mu_bytes // cfg.P)

    # ------------------------------------------------------ per-process views
    @property
    def cursor(self):
        """The single-process durable cursor (process 0's at ``P > 1``).
        Assigning one here wraps it as a one-element ``cursors`` list."""
        return self.cursors[0] if self.cursors else None

    @cursor.setter
    def cursor(self, cur):
        self.cursors = None if cur is None else [cur]

    def merged_shard_ledger(self) -> IOLedger:
        """Sum of the per-shard ledgers — equals the ``P == 1`` ledger's
        measured counters for the same workload."""
        out = IOLedger()
        for led in self.shard_ledgers:
            out = out.merge(led)
        return out

    def merged_shard_stats(self) -> TierStats:
        out = TierStats()
        for st in self.shard_stats:
            out = out.merge(st)
        return out

    # -------------------------------------------------------- observability
    def device_span(self, name: str, tid: str, cat: Optional[str] = None,
                    **args):
        """A span of the main tracer over work that may run on the device.

        CUDA kernels return before they finish, so on a CUDA executor the
        span begins and ends on a drained stream: it bills its own work on
        the device, not its launches, nor the tail of the work queued
        before it.  With tracing off this is the no-op span and adds no
        synchronisation."""
        span = self.tracer.span(name, tid=tid, cat=cat, **args)
        if self.tracer.enabled and self.device.type == "cuda":
            return _DrainedSpan(span, self.devices)
        return span

    def synchronize(self) -> None:
        """Wait for the work queued on every card the device tier runs on
        (each card of a mesh of cards; nothing to wait for on the CPU)."""
        for dev in self.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def metrics_snapshot(self) -> dict:
        """Flat metric-name dict subsuming ``TierStats`` and ``IOLedger``:
        ``tier.*``/``ledger.*`` are the run totals (per-shard entries merged
        at ``P > 1``), ``shard<p>.tier.*`` the per-process breakdown.
        Embedded under ``"metrics"`` in exported traces, so the report CLI
        can cross-check span-derived numbers against the counters."""
        m = {}
        stats = (self.merged_shard_stats() if len(self.shard_stats) > 1
                 else self.tier_stats)
        m.update(stats.snapshot())
        led = self.ledger
        for sl in self.shard_ledgers:
            if sl is not led:
                led = led.merge(sl)
        m.update(led.snapshot())
        if len(self.shard_stats) > 1:
            for p, st in enumerate(self.shard_stats):
                m.update(st.snapshot(prefix=f"shard{p}.tier"))
        return m

    def export_trace(self, path: Optional[str] = None) -> str:
        """Write the recorded spans as one Perfetto-loadable JSON trace.

        Under a sharded backing each per-process tracer is first written to
        its own ``<path>.p<p>`` part file, then the parts are merged (each
        keeping its own process lane) with the main tracer's events and the
        :meth:`metrics_snapshot` into ``path`` (default: the config's
        ``trace_path``).  Load the result in https://ui.perfetto.dev or
        summarize it with ``python -m repro_torch.obs report <path>`` (or
        the JAX package's ``python -m repro.obs report``)."""
        path = self.cfg.trace_path if path is None else path
        if path is None:
            raise ValueError(
                "export_trace needs a path (argument or "
                "PemsConfig.trace_path)")
        if not self.cfg.trace:
            raise ValueError(
                "export_trace requires PemsConfig(trace=True) — nothing "
                "recorded spans")
        parts = []
        if self.shard_tracers[0] is not self.tracer:
            for p, tr in enumerate(self.shard_tracers):
                pp = f"{path}.p{p}"
                write_trace(pp, trace_events(tr, pid=p + 1,
                                             process_name=tr.name))
                parts.append(pp)
        main_events = trace_events(self.tracer, pid=0, process_name="main")
        out = merge_trace_files(path, parts, extra_events=main_events,
                                metrics=self.metrics_snapshot())
        for pp in parts:                     # merged: the parts are spent
            try:
                os.unlink(pp)
            except OSError:
                pass
        return out

    def _account_disk(self, r0: int, r1: int, row_bytes: int,
                      write: bool) -> None:
        """Bill measured disk traffic for global rows ``[r0, r1)`` to the
        owning shard ledger(s) — the single main ledger at ``P == 1``."""
        if len(self.shard_ledgers) == 1:
            led = self.shard_ledgers[0]
            (led.add_disk_write if write
             else led.add_disk_read)((r1 - r0) * row_bytes)
            return
        for p, a, b in shard_row_ranges(self.cfg.v_local, r0, r1):
            led = self.shard_ledgers[p]
            (led.add_disk_write if write
             else led.add_disk_read)((b - a) * row_bytes)

    # ------------------------------------------------------------------ setup
    def init(self, init_fn=None, tier: Optional[str] = None,
             backing_path: Optional[str] = None
             ) -> ContextStore | MeshStore | TieredStore:
        """Create the zeroed context population: on the executor's device
        (``tier="device"``; a :class:`~.context.MeshStore` over a mesh of
        cards), or in a host/disk backing store
        (:class:`~.backing.TieredStore`).  ``tier`` defaults to the
        config's.  ``init_fn(rhos[n]) -> {field: [n, *shape]}`` fills
        initial fields, batched over the IDs — ``k`` contexts at a time on a
        backing tier, so the device never holds more than a round."""
        tier = self.cfg.tier if tier is None else tier
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r} (choose from {TIERS})")
        if tier != "device":
            return self._init_tiered(init_fn, tier,
                                     backing_path or self.cfg.backing_path)
        if self.cards:
            return init_mesh_store(self.layout, self.cfg.v, self.devices,
                                   init_fn)
        return init_store(self.layout, self.cfg.v, init_fn, self.device)

    def _init_tiered(self, init_fn, tier: str,
                     backing_path: Optional[str]) -> TieredStore:
        cfg, lo = self.cfg, self.layout
        backing = make_backing(tier, cfg.v, lo.words, backing_path,
                               P=cfg.P,
                               io_driver=cfg.io_driver,
                               io_queue_depth=cfg.io_queue_depth,
                               stats=self.tier_stats, ledger=self.ledger,
                               shard_stats=self.shard_stats,
                               shard_ledgers=self.shard_ledgers,
                               checksum=cfg.checksums,
                               fault_spec=cfg.fault_spec,
                               io_retries=cfg.io_retries,
                               io_backoff_s=cfg.io_backoff_s)
        self.backing = backing
        if cfg.trace:
            # Attach each shard's tracer to its engine and down the driver
            # wrapper chain (faulty/sanitize proxies), duck-typed like the
            # note_submit/note_complete hooks.
            shards = getattr(backing, "shards", None) or [backing]
            for p, sh in enumerate(shards):
                tr = self.shard_tracers[min(p, len(self.shard_tracers) - 1)]
                eng = getattr(sh, "engine", None)
                if eng is not None:
                    eng.tracer = tr
                f = getattr(sh, "file", None)
                while f is not None:
                    if hasattr(f, "tracer"):
                        f.tracer = tr
                    f = getattr(f, "inner", None)
        store = TieredStore(lo, backing, self.ledger,
                            shard_ledgers=self.shard_ledgers)
        if init_fn is not None:
            for r0 in range(0, cfg.v, cfg.k):
                blk = init_store(lo, cfg.k,
                                 lambda rhos, r0=r0: init_fn(rhos + r0),
                                 self.device)
                store.load_rows(r0, blk.data.cpu().numpy().view(np.uint32))
        return store

    def store_spec(self) -> tuple:
        """The store's placement as a spec (:mod:`repro_torch.distributed`):
        rows over the virtual-processor axis, words whole."""
        return (self.cfg.vp_axis, None)

    def all_rhos(self) -> torch.Tensor:
        """Every virtual processor's index, int32 on the executor's
        device."""
        return torch.arange(self.cfg.v, dtype=torch.int32, device=self.device)

    # -------------------------------------------------------------- superstep
    def superstep(
        self,
        store: ContextStore | MeshStore | TieredStore,
        fn: Callable[[torch.Tensor, Ctx], Ctx],
        reads: Optional[Sequence[str]] = None,
        writes: Optional[Sequence[str]] = None,
        name: str = "superstep",
        procs: Optional[Sequence[int]] = None,
        stream: bool = False,
    ) -> ContextStore | MeshStore | TieredStore:
        """Run one computation superstep: ``fn(rhos, ctx) -> ctx`` for every
        round of ``k`` virtual processors, updating the store in place.

        ``reads``/``writes`` declare the touched fields for the ``sliced``
        driver (and tighten the ledger); with the ``explicit``/``async``
        drivers the full live context swaps.

        ``procs`` (tiered stores only) restricts the superstep to the named
        processes' shards — contexts ``[p·v/P, (p+1)·v/P)`` per listed
        ``p`` — and raises ``ValueError`` on the device tier, as in the JAX
        package.  ``stream`` (disk backing tiers only) marks an I/O-bound
        stage — PSRS's merge — whose round swap-ins are prefetched while the
        previous round computes under every driver
        (``TierStats.merge_prefetch_events`` counts them); it changes
        nothing elsewhere.  ``name`` labels the superstep's
        ``superstep:<name>`` trace span.
        """
        with self.device_span(f"superstep:{name}", tid="supersteps",
                              cat="superstep", driver=self.cfg.driver,
                              stream=stream):
            return self._superstep_impl(store, fn, reads, writes, procs,
                                        stream)

    def _superstep_impl(self, store, fn, reads, writes, procs, stream):
        cfg = self.cfg
        sliced = (cfg.driver == "sliced" and reads is not None
                  and writes is not None)
        self._ledger_superstep(sliced, reads, writes, procs)
        if isinstance(store, TieredStore):
            self._superstep_tiered(store, fn, reads, writes, sliced, procs,
                                   stream)
            return store
        if procs is not None:
            raise ValueError(
                "procs= is a tiered-store knob (per-shard recovery); the "
                "device tier runs every process in one traced program")
        if sliced:
            body = self._round_body_sliced(fn, list(reads), list(writes))
        else:
            body = self._round_body_full(fn)
        # Each real processor runs its rounds over its own row block, IDs
        # offset by its first context (the JAX shard_map's per-device body).
        # Over a mesh of cards each block's rounds are queued on its card's
        # current stream and nothing waits between processors, so the cards
        # compute at once.
        m = cfg.v_local
        if isinstance(store, MeshStore):
            for p, blk in enumerate(store.blocks):
                with device_scope(blk.device):
                    self._run_rounds(blk, body, p * m)
            return store
        for p in range(cfg.P):
            self._run_rounds(store.data[p * m:(p + 1) * m], body, p * m)
        return store

    # ------------------------------------------------- tiered (host-driven)
    def _superstep_tiered(self, store: TieredStore, fn, reads, writes,
                          sliced: bool, procs=None,
                          stream: bool = False) -> None:
        """Host-driven round pipeline over a backing store: per round, swap
        in the round's ``k`` contexts (live/declared words only), run the
        round body on the device, swap the results out."""
        lo = self.layout
        # The swapped words as contiguous runs (the JAX package's word-index
        # maps, field_word_index, merged): the declared fields under the
        # sliced driver, else the live allocator words (§6.6), None when
        # the whole context is live.
        if sliced:
            in_idx, out_idx = _col_runs(lo, reads), _col_runs(lo, writes)
        else:
            live = lo.live_word_index()
            in_idx = out_idx = (None if live is None
                                else ColRuns.of(live, lo.words))
        if self._bufs is None:
            self._bufs = _RoundBuffers(self.device)
        body = self._tiered_body(fn, in_idx, out_idx)
        for p in (range(self.cfg.P) if procs is None else procs):
            self._run_tiered_proc(store, body, in_idx, out_idx, p, stream)

    def _tiered_body(self, fn, in_idx, out_idx):
        """The round body ``(rhos, blk [k, n_in]) -> [k, n_out]`` on the
        device.  The JAX package jits (and caches) it per stage function;
        the port runs eagerly, so there is nothing to cache.  As in the
        JAX body, the context is zeros with the swapped-in words scattered
        in (undeclared or dead words are not resident), and only the
        ``out_idx`` words go back."""
        lo, k = self.layout, self.cfg.k
        in_runs = None if in_idx is None else in_idx.runs
        out_runs, n_out = (None, lo.words) if out_idx is None \
            else (out_idx.runs, out_idx.n)
        bufs = self._bufs

        def body(rhos, blk):
            if in_runs is None:
                ctx = blk
            else:
                # The context buffer persists across rounds: re-zero it so
                # a word one round wrote is not resident in the next.
                ctx = bufs.get("ctx", 0, (k, lo.words), device=True)
                ctx.zero_()
                for j, w0, nw in in_runs:
                    ctx[:, w0:w0 + nw] = blk[:, j:j + nw]
            out = fn(rhos, Ctx(lo, ctx)).words
            if out_runs is None:
                return out
            dst = bufs.get("out", 0, (k, n_out), device=True)
            for j, w0, nw in out_runs:
                dst[:, j:j + nw] = out[:, w0:w0 + nw]
            return dst

        return body

    def _run_tiered_proc(self, store: TieredStore, body, in_idx, out_idx,
                         p: int, stream: bool = False) -> None:
        """Process ``p``'s ``v/(P·k)`` rounds through its own shard of the
        backing — its own file, engine, ledger and stats."""
        cfg, lo = self.cfg, self.layout
        stats, led = self.shard_stats[p], self.shard_ledgers[p]
        bk = store.backing
        disk = bk.disk
        k = cfg.k
        base = p * cfg.v_local
        rounds = cfg.v_local // k
        n_in = lo.words if in_idx is None else in_idx.n
        n_out = lo.words if out_idx is None else out_idx.n
        # A streamed stage (PSRS merge) prefetches its round swap-ins on a
        # disk backing under every driver: it is I/O bound by construction.
        streamed = stream and disk and rounds > 1
        use_async = (cfg.driver == "async" or streamed) and rounds > 1
        shard = bk.shards[p] if hasattr(bk, "shards") else bk
        # Engine-backed tier + async: leave the writeback in flight on the
        # engine's queue (rounds touch disjoint rows; the drain below
        # orders it), so round r-1's swap-out and round r+1's swap-in both
        # overlap round r's compute.
        async_writeback = (use_async
                           and getattr(shard, "engine", None) is not None)
        bufs = self._bufs
        cuda = bufs.cuda
        main = torch.cuda.current_stream(self.device) if cuda else None
        rho0 = torch.arange(k, dtype=torch.int32, device=self.device)
        # Staging: a pinned host buffer and a device buffer per in-flight
        # swap-in, and a pinned host buffer per in-flight swap-out.  An
        # in-flight writeback reads from its buffer until its requests
        # complete, so each out buffer remembers them and is refilled only
        # after they are waited for.
        n_bufs = 2 if use_async else 1
        host_in = [bufs.get("host_in", i, (k, n_in)) for i in range(n_bufs)]
        dev_in = [bufs.get("dev_in", i, (k, n_in), device=True)
                  for i in range(n_bufs)]
        n_outs = 2 if async_writeback else 1
        host_out = [bufs.get("host_out", i, (k, n_out))
                    for i in range(n_outs)]
        pending = [[] for _ in range(n_outs)]
        # Span lane for this process: the prefetch thread's swap_in spans
        # land on their own tid, so the Perfetto view shows them overlapping
        # the rounds lane's compute spans.  Every complete() below reuses
        # the exact t0/t1 the stats were billed with, so the trace and
        # TierStats can never disagree.
        tracer = self.shard_tracers[min(p, len(self.shard_tracers) - 1)]

        def fetch(r):
            t0 = time.perf_counter()
            r0 = base + r * k
            h, d = host_in[r % n_bufs], dev_in[r % n_bufs]
            bk.read_block(r0, r0 + k, cols=in_idx, out=h.numpy().view(
                np.uint32))
            ready = None
            if cuda:
                with torch.cuda.stream(bufs.side):
                    d.copy_(h, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(bufs.side)
                ready.synchronize()
            else:
                d.copy_(h)
            nbytes = h.numel() * h.element_size()
            led.add_tier_in(nbytes, disk)
            t1 = time.perf_counter()
            stats.swap_in_s += t1 - t0
            tracer.complete("swap_in", t0, t1, tid="prefetch", cat="io",
                            round=r, bytes=nbytes)
            return d, ready

        pool = ThreadPoolExecutor(max_workers=1) if use_async else None
        try:
            nxt = pool.submit(fetch, 0) if use_async else None
            for r in range(rounds):
                t0 = time.perf_counter()
                if use_async:
                    blk, ready = nxt.result()
                    t1 = time.perf_counter()
                    if streamed:
                        stats.merge_stall_s += t1 - t0
                    if r + 1 < rounds:
                        # Overlaps round r's compute and writeback: rounds
                        # touch disjoint context rows.
                        nxt = pool.submit(fetch, r + 1)
                        if streamed:
                            stats.merge_prefetch_events += 1
                else:
                    blk, ready = fetch(r)
                    t1 = time.perf_counter()
                stats.stall_s += t1 - t0
                tracer.complete("stall", t0, t1, tid="rounds", cat="stall",
                                round=r)

                t0 = time.perf_counter()
                if ready is not None:
                    main.wait_event(ready)
                out = body(rho0 + (base + r * k), blk)
                ho = host_out[r % n_outs]
                if pending[r % n_outs]:
                    # The buffer's last writeback must have left it first.
                    # The wait is billed to swap_out_s and, as part of the
                    # compute window, to compute_s: its span nests inside
                    # the round's compute span.
                    w0 = time.perf_counter()
                    shard.engine.wait(pending[r % n_outs])
                    w1 = time.perf_counter()
                    stats.swap_out_s += w1 - w0
                    tracer.complete("writeback_wait", w0, w1, tid="rounds",
                                    cat="io", round=r)
                ho.copy_(out, non_blocking=cuda)
                if cuda:
                    done = torch.cuda.Event()
                    done.record(main)
                    done.synchronize()          # blocks on the compute
                t1 = time.perf_counter()
                stats.compute_s += t1 - t0
                tracer.complete("compute", t0, t1, tid="rounds",
                                cat="compute", round=r)

                t0 = time.perf_counter()
                r0 = base + r * k
                out_h = ho.numpy().view(np.uint32)
                pending[r % n_outs] = bk.write_block(
                    r0, r0 + k, out_h, cols=out_idx,
                    wait=not async_writeback)
                led.add_tier_out(out_h.nbytes, disk)
                t1 = time.perf_counter()
                stats.swap_out_s += t1 - t0
                tracer.complete("swap_out", t0, t1, tid="rounds", cat="io",
                                round=r, bytes=out_h.nbytes)
                stats.rounds += 1
                if self.cursors and p < len(self.cursors):
                    # Advisory progress note (atomic, not fsynced): a resume
                    # restarts the whole in-progress superstep either way.
                    self.cursors[p].note_round(r)
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
            # Quiesce in-flight writebacks before anyone reads the rows
            # back (and so errors surface here, not at a later read).
            shard.drain()

    # ----------------------------------------------------------- round bodies
    def _run_rounds(self, data: torch.Tensor, body, base: int) -> None:
        """Drive ``body(rhos, blk) -> out`` over one real processor's
        ``v/(P·k)`` ID-ordered rounds; ``data`` is its ``[v/P, words]`` row
        block, ``base`` its first context's ID, and ``out`` lands in the
        round's rows of ``data``."""
        cfg = self.cfg
        k, rounds = cfg.k, cfg.rounds
        rho0 = base + torch.arange(k, dtype=torch.int32, device=data.device)

        if cfg.driver != "async" or rounds < 2:
            for r in range(rounds):
                blk = data[r * k:(r + 1) * k]
                out = body(rho0 + r * k, blk)
                if out is not blk:
                    blk.copy_(out)
            return

        # Double-buffered: round r+1's swap-in is issued on a side stream
        # before round r computes, so the copy can overlap the compute.
        side = torch.cuda.Stream(data.device) if data.is_cuda else None
        main = torch.cuda.current_stream(data.device) if data.is_cuda else None
        bufs = [data[0:k].clone(), torch.empty_like(data[0:k])]
        ready = None
        for r in range(rounds):
            if ready is not None:
                main.wait_event(ready)
            cur = bufs[r % 2]
            if r + 1 < rounds:
                nxt = bufs[(r + 1) % 2]
                src = data[(r + 1) * k:(r + 2) * k]
                if side is None:
                    nxt.copy_(src)
                else:
                    # The buffer was round r-1's: wait for its write-back.
                    side.wait_stream(main)
                    with torch.cuda.stream(side):
                        nxt.copy_(src, non_blocking=True)
                        ready = torch.cuda.Event()
                        ready.record(side)
            out = body(rho0 + r * k, cur)
            data[r * k:(r + 1) * k].copy_(out)
        if side is not None:
            main.wait_stream(side)

    def _round_body_full(self, fn):
        lo = self.layout

        def body(rhos, blk):              # blk: [k, words]
            return fn(rhos, Ctx(lo, blk)).words

        return body

    def _round_body_sliced(self, fn, reads: List[str], writes: List[str]):
        lo = self.layout
        # The declared fields' word ranges, merged into contiguous runs: the
        # union the JAX package gathers/scatters with a word-index map.
        read_runs = _runs(lo, reads)
        write_runs = _runs(lo, writes)

        def body(rhos, blk):
            # Only the declared read fields are "swapped in"; the rest of the
            # view is zero (reading undeclared fields is an application bug,
            # as with real mmap-backed paging the bytes would not be
            # resident).
            view = torch.zeros_like(blk)
            for a, b in read_runs:
                view[:, a:b] = blk[:, a:b]
            out = fn(rhos, Ctx(lo, view)).words
            # Only declared writes land back in the store.
            for a, b in write_runs:
                blk[:, a:b] = out[:, a:b]
            return blk

        return body

    # ---------------------------------------------------------------- ledger
    def _ledger_superstep(self, sliced, reads, writes, procs=None):
        cfg, lo = self.cfg, self.layout
        B = cfg.block_bytes
        if sliced:
            rbytes = sum(lo.field_bytes(n) for n in reads)
            wbytes = sum(lo.field_bytes(n) for n in writes)
        else:
            rbytes = wbytes = lo.live_bytes
        # Every VP swaps in its (touched) context and swaps it back out once
        # per virtual superstep (§6.1).
        nctx = cfg.v if procs is None else len(procs) * cfg.v_local
        self.ledger.add_swap_in(rbytes * nctx, B)
        self.ledger.add_swap_out(wbytes * nctx, B)
        self.ledger.add_barrier()


class _DrainedSpan:
    """A span that opens and closes on the drained current CUDA streams of
    ``devices`` (every card of a mesh of cards): the device work queued
    inside it is billed to it, and the work queued before it is not.  Used
    by :meth:`Pems.device_span` with tracing on; an exception closes the
    span at once."""

    __slots__ = ("_span", "_streams")

    def __init__(self, span, devices):
        self._span = span
        self._streams = [torch.cuda.current_stream(d) for d in devices]

    def __enter__(self):
        for s in self._streams:
            s.synchronize()
        return self._span.__enter__()

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            for s in self._streams:
                s.synchronize()
        return self._span.__exit__(exc_type, exc, tb)


class _RoundBuffers:
    """The tiered round loop's staging, kept across supersteps: pinned host
    buffers (plain ones on the CPU) and device buffers by role and index,
    each grown to the largest round block asked of it, and the side stream
    of the host-to-device copies."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.side = torch.cuda.Stream(device) if self.cuda else None
        self._flat = {}

    def get(self, role: str, i: int, shape, device: bool = False):
        """A ``shape`` int32 view of buffer ``(role, i)``: on the device, or
        in pinned host memory."""
        n = shape[0] * shape[1]
        flat = self._flat.get((role, i))
        if flat is None or flat.numel() < n:
            self._flat.pop((role, i), None)     # free before reallocating
            if device:
                flat = torch.empty(n, dtype=torch.int32, device=self.device)
            else:
                flat = torch.empty(n, dtype=torch.int32,
                                   pin_memory=self.cuda)
            self._flat[(role, i)] = flat
        return flat[:n].view(shape)


def _col_runs(lo: ContextLayout, names: Sequence[str]) -> ColRuns:
    """The named fields' words as a :class:`~.backing.ColRuns`: the same
    runs as ``_cols_runs(field_word_index(lo, names))``, without the word
    index."""
    runs, n = [], 0
    for a, b in _runs(lo, names):
        runs.append((n, a, b - a))
        n += b - a
    return ColRuns(runs, n)


def _runs(lo: ContextLayout, names: Sequence[str]) -> List[tuple]:
    """The union of the named fields' word ranges as sorted, merged
    ``(start, stop)`` runs — the same words as :func:`field_word_index`."""
    runs = []
    for a, b in sorted((lo.offset(n), lo.offset(n) + lo.field_words(n))
                       for n in names):
        if runs and a <= runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], b)
        else:
            runs.append([a, b])
    return [tuple(r) for r in runs]


# Bind collective methods (defined in their own module to keep files focused).
from . import collectives as _collectives  # noqa: E402

Pems.alltoallv = _collectives.alltoallv
Pems.bcast = _collectives.bcast
Pems.gather = _collectives.gather
Pems.allgather = _collectives.allgather
Pems.reduce = _collectives.reduce
Pems.allreduce = _collectives.allreduce
