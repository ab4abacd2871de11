"""I/O ledger for the PEMS2 simulation (the port's own copy of the JAX
package's ``core/iostats.py``; pure Python, field for field the same, so the
two ledgers compare counter by counter).

The thesis measures algorithms by *I/O volume* (bytes moved between RAM and
external memory) and *number of I/O operations* (block transfers).  Both are
statically determined by the simulation parameters (v, P, k, mu, omega, B) and
the deterministic ID-ordered round schedule (thesis §6.5), so the ledger is a
pure-Python event counter updated once per superstep or collective call.

The port runs the device tier only; the measured backing-tier counters and
:class:`TierStats` below are kept so the ledgers stay field-for-field equal.

Byte categories mirror the thesis' cost terms:

* ``swap_in`` / ``swap_out``      — context swapping (the ``S`` coefficient)
* ``msg_direct``                  — messages delivered directly to a context on
                                    disk (PEMS2, §6.2)
* ``msg_indirect``                — messages staged through the indirect area
                                    (PEMS1, §2.2) or re-read for late delivery
* ``boundary``                    — boundary-block cache flushes (§6.2)
* ``network``                     — bytes crossing the real-processor network
                                    (the ``g`` coefficient)
* ``disk_space``                  — peak external-memory footprint (§6.3)

With a host/disk backing tier (not ported yet) the swaps are no longer
simulated: the executor's host-driven pipeline records the *measured* traffic
in a second group of counters (``h2d_bytes``/``d2h_bytes`` for PCIe-direction
transfers, ``disk_read_bytes``/``disk_write_bytes`` for the memmap file).
These are real bytes, not modeled blocks, and are deliberately excluded from
``io_total`` so the thesis' closed-form lemmas keep validating unchanged.
:class:`TierStats` carries the wall-clock side of the same pipeline (swap
time, stall time, the async driver's compute/I-O overlap fraction — §5.1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class IOLedger:
    """Byte counters for one simulated program run."""

    swap_in: int = 0
    swap_out: int = 0
    msg_direct: int = 0
    msg_indirect: int = 0
    boundary: int = 0
    network: int = 0
    network_rounds: int = 0   # bulk all-to-all launches of the α-chunked
                              # network phase (Alg 7.1.3; the ``l`` term of
                              # Lemma 7.1.7 counts P· this, point-to-point)
    disk_space: int = 0
    num_ios: int = 0          # block-granular I/O operations
    supersteps: int = 0       # internal superstep barriers (the ``L`` term)

    # Measured backing-tier traffic (host-driven pipeline; real bytes moved,
    # recorded at execution time — excluded from the modeled ``io_total``).
    h2d_bytes: int = 0        # host → device transfers (swap-in)
    d2h_bytes: int = 0        # device → host transfers (swap-out)
    disk_read_bytes: int = 0  # bytes read from the disk backing file
    disk_write_bytes: int = 0  # bytes written to the disk backing file

    # Syscall-level counters from the ``repro.io`` engine (``tier="file"``):
    # the bytes each pread/pwrite actually asked the kernel for.  Under the
    # ``odirect`` driver these are block-aligned and can exceed the logical
    # ``disk_*_bytes`` above (read-modify-write of boundary blocks); they are
    # the numbers to validate against ``os.stat`` block accounting.
    syscall_read_bytes: int = 0
    syscall_write_bytes: int = 0

    # ------------------------------------------------------------------ totals
    @property
    def swap_total(self) -> int:
        return self.swap_in + self.swap_out

    @property
    def message_total(self) -> int:
        return self.msg_direct + self.msg_indirect + self.boundary

    @property
    def io_total(self) -> int:
        """Total external-memory traffic (the thesis' "I/O volume")."""
        return self.swap_total + self.message_total

    # ------------------------------------------------------------------ events
    def add_swap_in(self, nbytes: int, block: int) -> None:
        self.swap_in += nbytes
        self.num_ios += _blocks(nbytes, block)

    def add_swap_out(self, nbytes: int, block: int) -> None:
        self.swap_out += nbytes
        self.num_ios += _blocks(nbytes, block)

    def add_msg_direct(self, nbytes: int, block: int) -> None:
        self.msg_direct += nbytes
        self.num_ios += _blocks(nbytes, block)

    def add_msg_indirect(self, nbytes: int, block: int) -> None:
        self.msg_indirect += nbytes
        self.num_ios += _blocks(nbytes, block)

    def add_boundary(self, nbytes: int, block: int) -> None:
        self.boundary += nbytes
        self.num_ios += _blocks(nbytes, block)

    def add_network(self, nbytes: int) -> None:
        self.network += nbytes

    def add_network_rounds(self, n: int) -> None:
        self.network_rounds += n

    def add_tier_in(self, nbytes: int, disk: bool) -> None:
        """Measured swap-in: host (or disk) → device."""
        self.h2d_bytes += nbytes
        if disk:
            self.disk_read_bytes += nbytes

    def add_tier_out(self, nbytes: int, disk: bool) -> None:
        """Measured swap-out: device → host (or disk)."""
        self.d2h_bytes += nbytes
        if disk:
            self.disk_write_bytes += nbytes

    def add_disk_read(self, nbytes: int) -> None:
        """Measured disk-resident data movement that never crosses to the
        device (host-side collectives over a memmap store)."""
        self.disk_read_bytes += nbytes

    def add_disk_write(self, nbytes: int) -> None:
        self.disk_write_bytes += nbytes

    @property
    def tier_total(self) -> int:
        """Total measured backing-tier traffic (both directions)."""
        return self.h2d_bytes + self.d2h_bytes

    def add_barrier(self, n: int = 1) -> None:
        self.supersteps += n

    def require_disk(self, nbytes: int) -> None:
        self.disk_space = max(self.disk_space, nbytes)

    # ---------------------------------------------------------------- reporting
    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self) | {
            "swap_total": self.swap_total,
            "message_total": self.message_total,
            "io_total": self.io_total,
            "tier_total": self.tier_total,
        }

    def snapshot(self, prefix: str = "ledger") -> Dict[str, int]:
        """Flat metric-name view of :meth:`as_dict` (``"ledger.swap_in"``,
        ...): the names under which these counters appear in the
        ``repro.obs`` metrics snapshot embedded in exported traces."""
        return {f"{prefix}.{k}": v for k, v in self.as_dict().items()}

    def merge(self, other: "IOLedger") -> "IOLedger":
        """Combine two ledgers: byte/op counters sum; ``disk_space`` (a
        per-process requirement, not a flow) takes the max.  Aggregates the
        per-shard ledgers of a ``P > 1`` run back to the ``P == 1`` totals
        — the sharding invariant the tier-1 tests pin."""
        out = IOLedger()
        for f in dataclasses.fields(IOLedger):
            setattr(out, f.name, getattr(self, f.name) + getattr(other, f.name))
        out.disk_space = max(self.disk_space, other.disk_space)
        return out

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        d = self.as_dict()
        return "IOLedger(" + ", ".join(f"{k}={v:,}" for k, v in d.items()) + ")"


def _blocks(nbytes: int, block: int) -> int:
    """Number of block-granular I/O operations for an ``nbytes`` transfer."""
    if nbytes <= 0:
        return 0
    return -(-nbytes // block)


@dataclasses.dataclass
class TierStats:
    """Wall-clock instrumentation of the host-driven swap pipeline.

    ``swap_in_s`` is the time the (pre)fetcher spent reading the backing
    store and uploading to the device; ``stall_s`` is the main-thread time
    actually *blocked* waiting for a swap-in.  Under the synchronous drivers
    the two are equal; under the ``async`` driver the prefetch thread runs
    while the previous round computes, so ``stall_s < swap_in_s`` — the gap
    is the PEMS2 §5.1 compute/I-O overlap.
    """

    rounds: int = 0
    swap_in_s: float = 0.0
    swap_out_s: float = 0.0
    compute_s: float = 0.0    # round compute incl. the blocking D2H readback
    stall_s: float = 0.0
    peak_stage_bytes: int = 0  # largest host staging buffer a tiered
                               # collective allocated (≤ device_cap_bytes
                               # when the cap is set — see _alltoallv_host)

    # repro.io engine instrumentation (tier="file"): measured at the
    # submission/completion queues, not modeled.
    max_queue_depth: int = 0   # high-water mark of in-flight requests
    queue_stall_s: float = 0.0  # submit-side blocking on a full queue
    fsyncs: int = 0            # durability barriers issued by the engine
    rw_overlap_events: int = 0  # submissions that observed the *opposite*
                                # direction already in flight — >0 means
                                # reads and writes genuinely overlapped
    retries: int = 0           # transient-error re-attempts the engine issued
    backoff_s: float = 0.0     # scheduled retry backoff (deterministic sum)
    permanent_errors: int = 0  # requests that errored after retries exhausted
                               # (or a non-transient errno, first attempt)

    # Streamed-stage instrumentation (superstep(..., stream=True) on a disk
    # backing — the k-way merge stage of PSRS): the stage's bucket reads are
    # prefetched through the block API while the previous round's merge
    # computes, regardless of the configured driver.
    merge_prefetch_events: int = 0  # round swap-ins issued ahead of need,
                                    # overlapping the in-flight compute
    merge_stall_s: float = 0.0      # time the streamed stage still blocked
                                    # waiting on a prefetched round

    @property
    def overlap_fraction(self) -> float:
        """Fraction of swap-in time hidden behind compute (0 when nothing
        overlapped, → 1 when swap-ins were entirely free)."""
        if self.swap_in_s <= 0.0:
            return 0.0
        return min(1.0, max(0.0, 1.0 - self.stall_s / self.swap_in_s))

    def reset(self) -> None:
        for f in dataclasses.fields(TierStats):
            setattr(self, f.name, f.default)

    def merge(self, other: "TierStats") -> "TierStats":
        """Combine two pipelines' stats: counters and times sum; high-water
        marks (``peak_stage_bytes``, ``max_queue_depth``) take the max.
        Used to aggregate the per-shard stats of a ``P > 1`` tiered run."""
        out = TierStats()
        for f in dataclasses.fields(TierStats):
            setattr(out, f.name, getattr(self, f.name) + getattr(other, f.name))
        out.peak_stage_bytes = max(self.peak_stage_bytes,
                                   other.peak_stage_bytes)
        out.max_queue_depth = max(self.max_queue_depth, other.max_queue_depth)
        return out

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self) | {
            "overlap_fraction": self.overlap_fraction,
        }

    def snapshot(self, prefix: str = "tier") -> Dict[str, float]:
        """Flat metric-name view of :meth:`as_dict` (``"tier.stall_s"``,
        ...): the names under which these counters appear in the
        ``repro.obs`` metrics snapshot embedded in exported traces."""
        return {f"{prefix}.{k}": v for k, v in self.as_dict().items()}
