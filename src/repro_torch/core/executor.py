"""The PEMS2 superstep executor, device tier.

Simulates ``v`` virtual processors on ``P`` real processors with ``k``
concurrently-resident contexts per real processor, exactly the thesis' model
(§3.2): execution proceeds in deterministic ID-ordered rounds of ``P·k``
virtual processors (§6.5); real processor ``p`` runs its ``v/(P·k)`` rounds
over its own contexts ``[p·v/P, (p+1)·v/P)``.  ``P > 1`` needs a
:class:`~.mesh.Mesh` of ``P`` entries; the port runs one on a single device,
the store one ``[v, words]`` tensor whose row blocks are the processes.  A
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
ledger) and in schedule.  The backing tiers, recovery and tracing are not
ported yet: their knobs raise ``NotImplementedError`` naming the
``ROADMAP.md`` item that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from .context import (
    Ctx,
    ContextLayout,
    ContextStore,
    init_store,
    resolve_device,
)
from .iostats import IOLedger
from .mesh import Mesh, canonical

DRIVERS = ("explicit", "sliced", "async")
TIERS = ("device", "host", "memmap", "file")

# Knobs of the JAX PemsConfig that this slice does not run yet: their
# defaults, and the ROADMAP.md item that brings them.
_NOT_PORTED = {
    "tier": ("device", "queue 1 item 5 (backing tiers)"),
    "backing_path": (None, "queue 1 item 5 (backing tiers)"),
    "io_driver": (None, "queue 1 item 5 (backing tiers)"),
    "io_queue_depth": (8, "queue 1 item 5 (backing tiers)"),
    "io_retries": (2, "queue 1 item 5 (backing tiers)"),
    "io_backoff_s": (0.002, "queue 1 item 5 (backing tiers)"),
    "fault_spec": (None, "queue 1 item 6 (recovery)"),
    "checksums": (False, "queue 1 item 6 (recovery)"),
    "trace": (False, "queue 1 item 9 (observability)"),
    "trace_path": (None, "queue 1 item 9 (observability)"),
}


def not_ported(knob: str, value, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob}={value!r} is not ported to repro_torch yet; ROADMAP.md "
        f"{item} brings it")


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
    * ``block_bytes`` — B, the *modeled* ledger block size (bytes).
    * ``device_cap_bytes`` — device-memory budget (bytes) for the resident
      contexts; construction fails if ``v·μ`` does not fit.
    * ``merge_kernel``/``merge_tile`` — app-level merge stages (PSRS): route
      the merge through the tiled k-way merge kernel in ``merge_tile``-wide
      output tiles, instead of the dense re-sort of the received buckets.
      Bit-identical either way; ``merge_tile`` must be a power of two.

    The other fields keep the JAX package's names (``docs/TUNING.md``
    documents them) and accept only their defaults here: ``tier`` and the
    backing, I/O, fault, checksum and trace knobs raise
    ``NotImplementedError`` naming the ``ROADMAP.md`` item that ports them.

    Raises ``ValueError`` at construction for any invalid combination —
    unknown driver or tier names, a bad ``merge_tile``, indivisible
    ``v``/``P``/``k``, out-of-range ``alpha``.
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
        for knob, (default, item) in _NOT_PORTED.items():
            value = getattr(self, knob)
            if value != default:
                raise not_ported(knob, value, item)
        if (self.merge_tile != int(self.merge_tile) or self.merge_tile < 2
                or int(self.merge_tile) & (int(self.merge_tile) - 1)):
            raise ValueError(
                f"merge_tile={self.merge_tile!r} must be a power-of-two "
                "integer >= 2 (one k-way merge grid step per tile)"
            )
        self.merge_tile = int(self.merge_tile)
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
    ``P > 1`` needs a ``mesh`` (:func:`~.mesh.make_mesh`) with ``P`` entries
    along ``cfg.vp_axis`` on that device.  Collective methods are bound from
    :mod:`repro_torch.core.collectives`."""

    def __init__(self, cfg: PemsConfig, layout: ContextLayout,
                 mesh: Optional[Mesh] = None, device=None):
        self.cfg = cfg
        self.layout = layout
        self.device = resolve_device(device)
        self.mesh = mesh
        self.ledger = IOLedger()
        if cfg.P > 1 and mesh is None:
            raise ValueError("P > 1 requires a mesh with the vp axis "
                             "(device tier; backing tiers shard instead)")
        if mesh is not None:
            if mesh.shape.get(cfg.vp_axis) != cfg.P:
                raise ValueError(
                    f"mesh axis {cfg.vp_axis}="
                    f"{mesh.shape.get(cfg.vp_axis)} != P={cfg.P}")
            if mesh.device() != canonical(self.device):
                raise ValueError(
                    f"the mesh lies on {mesh.device()} but the executor on "
                    f"{self.device}")
        if cfg.device_cap_bytes is not None:
            # The device tier must fit the whole population.
            need = cfg.v * layout.mu_bytes
            if need > cfg.device_cap_bytes:
                raise ValueError(
                    f"device-resident contexts need {need:,} bytes (v·mu) "
                    f"but device_cap_bytes={cfg.device_cap_bytes:,}; "
                    "lower k or use tier='host'/'memmap'/'file'"
                )
        # PEMS2 disk requirement: exactly vμ/P per real processor (§6.3).
        self.ledger.require_disk(cfg.v * layout.mu_bytes // cfg.P)

    # ------------------------------------------------------------------ setup
    def init(self, init_fn=None, tier: Optional[str] = None,
             backing_path: Optional[str] = None) -> ContextStore:
        """Create the zeroed context population on the executor's device.
        ``init_fn(rhos[v]) -> {field: [v, *shape]}`` fills initial fields."""
        tier = self.cfg.tier if tier is None else tier
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r} (choose from {TIERS})")
        if tier != "device":
            raise not_ported("tier", tier, "queue 1 item 5 (backing tiers)")
        if backing_path is not None:
            raise not_ported("backing_path", backing_path,
                             "queue 1 item 5 (backing tiers)")
        return init_store(self.layout, self.cfg.v, init_fn, self.device)

    # -------------------------------------------------------------- superstep
    def superstep(
        self,
        store: ContextStore,
        fn: Callable[[torch.Tensor, Ctx], Ctx],
        reads: Optional[Sequence[str]] = None,
        writes: Optional[Sequence[str]] = None,
        name: str = "superstep",
        procs: Optional[Sequence[int]] = None,
        stream: bool = False,
    ) -> ContextStore:
        """Run one computation superstep: ``fn(rhos, ctx) -> ctx`` for every
        round of ``k`` virtual processors, updating the store in place.

        ``reads``/``writes`` declare the touched fields for the ``sliced``
        driver (and tighten the ledger); with the ``explicit``/``async``
        drivers the full live context swaps.  ``stream`` marks an I/O-bound
        stage for the disk tiers' merge prefetch and changes nothing on the
        device tier.  ``procs`` is a backing-tier knob (per-shard recovery)
        and raises ``ValueError`` on the device tier, as in the JAX package.
        ``name`` labels the superstep's trace span in the JAX package; the
        port records no spans yet (``ROADMAP.md`` queue 1 item 9).
        """
        cfg = self.cfg
        sliced = (cfg.driver == "sliced" and reads is not None
                  and writes is not None)
        self._ledger_superstep(sliced, reads, writes, procs)
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
        m = cfg.v_local
        for p in range(cfg.P):
            self._run_rounds(store.data[p * m:(p + 1) * m], body, p * m)
        return store

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
