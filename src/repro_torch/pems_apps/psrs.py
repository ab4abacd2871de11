"""PSRS — Parallel Sorting by Regular Sampling (thesis Alg 8.3.1) on PEMS.

Four virtual supersteps, exactly the thesis' structure:

  1. local sort + choose v regular samples        (computation)
  2. **Gather** all v² samples at the root
  3. root sorts samples, picks v−1 splitters; **Bcast**
  4. partition local data by splitters; **Alltoallv** counts + buckets
  5. merge received buckets                        (computation)

Duplicate keys are handled by lexicographic (value, global-index) splitters,
which preserves the 2n/v per-receiver bound even for constant inputs.

The stages take the round's ``k`` contexts at once (``rhos [k]``, a batched
:class:`~repro_torch.core.Ctx`); the bitonic local sort, the Alltoallv direct
delivery and the k-way merge tile sort are the hand-written CUDA kernels of
:mod:`repro_torch.kernels` on a CUDA store, their plain PyTorch versions on a
CPU store.  On a backing tier the population lives in host memory or on
disk and each round's contexts visit the device, where the stages (and the
local sort and merge kernels) run; the Alltoallv is then host-side data
movement.  :func:`psrs_run_recoverable` runs the stages on a disk tier
under a durable cursor with pre-stage snapshots, and survives ``kill -9``.
"""

from __future__ import annotations

import os
import signal
from typing import Optional

import numpy as np
import torch

from ..core import (ContextLayout, ContextStore, Pems, PemsConfig,
                    SuperstepCursor, atomic_replace_file, resolve_device)
from ..core.context import MeshStore
from ..kernels.bitonic_sort import bitonic_sort
from ..kernels.kway_merge import kway_merge
from .common import INT_MAX, group_by_dest

_HI = 1 << 32   # (value, gid) -> value·2^32 + gid

# Fields each stage both reads and writes: rerunning such a stage after a
# mid-stage crash would compute from possibly-torn rows, so the recoverable
# runner snapshots them before the stage and restores them on a dirty
# resume.  Stages absent here have disjoint read/write sets and rerun
# idempotently.
STAGE_SNAPSHOT_FIELDS = {
    "sort_sample": ("data",),
    "bcast_splitters": ("gsplit",),
    "merge": ("oflow",),
}


def _build(v: int, k: int, n_v: int, cap, rcap, driver: str,
           mode: str, local_sort, use_kernel: bool = True,
           tier: str = "device", backing_path=None, device_cap_bytes=None,
           P: int = 1, mesh=None, alpha=None,
           io_driver=None, io_queue_depth=None,
           fault_spec=None, checksums: bool = False, io_retries=None,
           io_backoff_s=None, merge_kernel=None, merge_tile=None,
           trace: bool = False, trace_path=None, device=None):
    # One home for the PSRS capacity defaults: the always-safe per-message
    # bound n/v and the 2n/v per-receiver guarantee.
    cap = n_v if cap is None else cap
    rcap = 2 * n_v if rcap is None else rcap
    # Default local sort: the bitonic kernel; use_kernel=False keeps the
    # torch.sort reference.  Both are bit-identical on int32 keys.
    if local_sort is None:
        if use_kernel:
            local_sort = bitonic_sort
        else:
            def local_sort(x):
                return torch.sort(x, dim=-1).values
    lo = (
        ContextLayout()
        .add("data", (n_v,), torch.int32)
        .add("samp", (v, 2), torch.int32)        # (value, global index)
        .add("allsamp", (v, v, 2), torch.int32)
        .add("gsplit", (v, 2), torch.int32)
        .add("bsend", (v, cap), torch.int32)
        .add("bscnt", (v,), torch.int32)
        .add("brecv", (v, cap), torch.int32)
        .add("brcnt", (v,), torch.int32)
        .add("result", (rcap,), torch.int32)
        .add("rcount", (1,), torch.int32)
        .add("oflow", (1,), torch.int32)
    )
    io_kw = {}
    if io_driver is not None:
        io_kw["io_driver"] = io_driver
    if io_queue_depth is not None:
        io_kw["io_queue_depth"] = io_queue_depth
    if fault_spec is not None:
        io_kw["fault_spec"] = fault_spec
    if io_retries is not None:
        io_kw["io_retries"] = io_retries
    if io_backoff_s is not None:
        io_kw["io_backoff_s"] = io_backoff_s
    if checksums:
        io_kw["checksums"] = True
    if merge_kernel is not None:
        io_kw["merge_kernel"] = bool(merge_kernel)
    if merge_tile is not None:
        io_kw["merge_tile"] = merge_tile
    if trace:
        io_kw["trace"] = True
    if trace_path is not None:
        io_kw["trace_path"] = trace_path
    pems = Pems(PemsConfig(v=v, k=k, P=P, driver=driver, tier=tier,
                           backing_path=backing_path, alpha=alpha,
                           device_cap_bytes=device_cap_bytes, **io_kw),
                lo, mesh=mesh, device=device)
    dev = pems.device
    merge_on_kernel = pems.cfg.merge_kernel and use_kernel
    merge_tile = pems.cfg.merge_tile
    # Regular sampling: positions ⌊j·n_v/v⌋, j = 0..v−1 (Shi & Schaeffer).
    samp_idx = _per_card((torch.arange(v, device=dev) * n_v) // v)
    # Splitters at ranks (i+1)·v + v/2 − 1, i = 0..v−2; sentinel at end.
    split_ranks = _per_card(
        (torch.arange(v - 1, device=dev) + 1) * v + v // 2 - 1)
    lane_gid = _per_card(torch.arange(n_v, dtype=torch.int64, device=dev))

    def sort_and_sample(rhos, ctx):
        data = local_sort(ctx.get("data"))                   # [k, n_v]
        idx = samp_idx(data.device)
        gid = rhos[:, None] * n_v + idx.to(torch.int32)
        samp = torch.stack([data[:, idx], gid], dim=-1)
        return ctx.set("data", data).set("samp", samp)

    def pick_splitters(rhos, ctx):
        allsamp = ctx.get("allsamp").reshape(ctx.k, v * v, 2)
        # Lexicographic (value, gid) order: torch has no lexsort, so a
        # stable sort on the secondary key, then on the primary.
        o = torch.sort(allsamp[..., 1], dim=1, stable=True).indices
        s = torch.gather(allsamp, 1, o[..., None].expand(-1, -1, 2))
        o = torch.sort(s[..., 0], dim=1, stable=True).indices
        s = torch.gather(s, 1, o[..., None].expand(-1, -1, 2))
        sentinel = torch.full((ctx.k, 1, 2), INT_MAX, dtype=torch.int32,
                              device=s.device)
        return ctx.set("gsplit", torch.cat(
            [s[:, split_ranks(s.device)], sentinel], dim=1))

    def partition(rhos, ctx):
        data = ctx.get("data")                               # [k, n_v]
        gs = ctx.get("gsplit")                               # [k, v, 2]
        gid = rhos[:, None].to(torch.int64) * n_v + lane_gid(data.device)
        # dest = #splitters (sv, sg) <= (x, gid) lexicographically: one
        # searchsorted of the 64-bit key x·2^32 + gid into the sorted
        # splitter keys (0 <= gid < 2^32 keeps the lexicographic order).
        key = data.to(torch.int64) * _HI + gid
        skey = (gs[:, :-1, 0].to(torch.int64) * _HI
                + gs[:, :-1, 1].to(torch.int64))
        dest = torch.searchsorted(skey.contiguous(), key, right=True)
        msgs, counts, _, ok = group_by_dest(data, dest, v, cap, fill=INT_MAX)
        return (
            ctx.set("bsend", msgs)
            .set("bscnt", counts)
            .set("oflow", (~ok).to(torch.int32)[:, None])
        )

    def merge(rhos, ctx):
        # The boundary mask is fused into delivery (alltoallv fill=INT_MAX):
        # lanes past brcnt arrive as INT_MAX, so the received buckets merge
        # as-is.
        recv = ctx.get("brecv")              # [k, v, cap]
        cnt = ctx.get("brcnt")               # [k, v]
        if merge_on_kernel:
            # Tiled k-way merge with exact splitting: O(n log v) over the
            # already-sorted buckets instead of the O(n log n) re-sort.
            merged, total, over = kway_merge(
                recv, cnt, rcap=rcap, tile=merge_tile, fill=INT_MAX)
        else:
            merged = local_sort(recv.reshape(ctx.k, v * cap))[:, :rcap]
            total = cnt.sum(dim=1, dtype=torch.int32)
            over = (total > rcap).to(torch.int32)
        oflow = ctx.get("oflow") | over[:, None]
        return (
            ctx.set("result", merged)
            .set("rcount", total[:, None])
            .set("oflow", oflow)
        )

    # The program as an explicit stage list: callers (the carry-over tests,
    # resumable jobs) can stop after any stage and resume from a store.
    # ``procs`` (backing tiers) runs a stage for the listed processes'
    # shards alone, and raises on the device tier.
    steps = [
        ("sort_sample", lambda st, procs=None: pems.superstep(
            st, sort_and_sample, reads=["data"], writes=["data", "samp"],
            procs=procs)),
        ("gather_samples", lambda st, procs=None: pems.gather(
            st, "samp", "allsamp", root=0, procs=procs)),
        ("pick_splitters", lambda st, procs=None: pems.superstep(
            st, pick_splitters, reads=["allsamp"], writes=["gsplit"],
            procs=procs)),
        ("bcast_splitters", lambda st, procs=None: pems.bcast(
            st, "gsplit", root=0, procs=procs)),
        ("partition", lambda st, procs=None: pems.superstep(
            st, partition, reads=["data", "gsplit"],
            writes=["bsend", "bscnt", "oflow"], procs=procs)),
        ("alltoallv", lambda st, procs=None: pems.alltoallv(
            st, "bsend", "brecv", "bscnt", "brcnt",
            mode=mode, fill=INT_MAX, use_kernel=use_kernel, procs=procs)),
        ("merge", lambda st, procs=None: pems.superstep(
            st, merge, reads=["brecv", "brcnt", "oflow"],
            writes=["result", "rcount", "oflow"], procs=procs,
            stream=True)),
    ]

    # Stage spans on the main tracer's "stages" lane: one per plan stage,
    # the unit the obs report attributes compute/I-O/stall time to.  On a
    # CUDA executor a traced stage span begins and ends on a drained
    # stream; with tracing off pems.tracer is the no-op singleton, so the
    # wrapper costs one attribute check per stage.
    def _staged(name, fn):
        def run(st, procs=None):
            with pems.device_span(f"stage:{name}", tid="stages",
                                  cat="stage"):
                return fn(st, procs=procs)
        return run

    steps = [(name, _staged(name, fn)) for name, fn in steps]

    def load(data_blocks):                  # [v, n_v] int32
        return pems.init().with_field("data", data_blocks)

    def extract(store):
        return (store.field("result"), store.field("rcount"),
                store.field("oflow"))

    def program(data_blocks):
        store = load(data_blocks)
        for _, step in steps:
            store = step(store)
        return store

    return pems, program, (load, steps, extract)


def _per_card(t: torch.Tensor):
    """``device -> t`` on that device, each copy made once: a stage over a
    mesh of cards runs on each block's card and reads its constants
    there."""
    copies = {t.device: t}

    def on(device):
        if device not in copies:
            copies[device] = t.to(device)
        return copies[device]

    return on


def _result_fields(store) -> list:
    """``[(result, rcount, oflow)]`` of each block of the store: its one
    block, or each card's over a mesh of cards (views there)."""
    blocks = ([ContextStore(store.layout, b) for b in store.blocks]
              if isinstance(store, MeshStore) else [store])
    return [(st.field("result"), st.field("rcount"), st.field("oflow"))
            for st in blocks]


def _sorted_keys(fields, cap=None, rcap=None) -> torch.Tensor:
    """Each context's first ``rcount`` result keys, in context order, from
    :func:`_result_fields`; ``OverflowError`` when a context overflowed
    ``cap``/``rcap``.  Over a mesh of cards the rows are trimmed on each
    block's card, then gathered onto the first card (an explicit copy of
    the sorted keys alone)."""
    if any(bool(oflow.any()) for _, _, oflow in fields):
        raise OverflowError(
            "PSRS message capacity exceeded; raise cap/rcap "
            f"(cap={cap}, rcap={rcap})"
        )
    parts = []
    for result, rcount, _ in fields:
        counts = rcount[:, 0].tolist()
        parts.append(torch.cat([result[i, :c] for i, c in enumerate(counts)]))
    if len(parts) == 1:
        return parts[0]
    return torch.cat([t.to(parts[0].device) for t in parts])


def psrs_plan(
    v: int,
    n_v: int,
    k: int = 1,
    driver: str = "explicit",
    mode: str = "direct",
    cap: Optional[int] = None,
    rcap: Optional[int] = None,
    local_sort=None,
    use_kernel: bool = True,
    tier: str = "device",
    backing_path=None,
    device_cap_bytes=None,
    P: int = 1,
    mesh=None,
    alpha=None,
    io_driver=None,
    io_queue_depth=None,
    fault_spec=None,
    checksums: bool = False,
    io_retries=None,
    io_backoff_s=None,
    merge_kernel: Optional[bool] = None,
    merge_tile: Optional[int] = None,
    trace: bool = False,
    trace_path: Optional[str] = None,
    device=None,
):
    """Stepwise PSRS: returns ``(pems, load, steps, extract)``.

    ``load([v, n_v] int32) -> store`` initialises the population on the
    executor's device (CUDA unless ``device`` names another), or in the
    backing ``tier`` (``backing_path`` reused as it is: a JAX package's
    memmap or file backing resumes here); ``steps`` is a list of named
    ``store -> store`` stages (run them in order, or stop after any stage
    and resume later — :mod:`repro_torch.interop` carries a JAX package
    store over); ``extract(store) -> (result, rcount, oflow)``, CPU tensors
    on a backing tier.  Stages update the store in place; each takes
    ``procs=`` on a backing tier.
    """
    pems, _, (load, steps, extract) = _build(
        v, k, n_v, cap, rcap, driver, mode, local_sort,
        use_kernel=use_kernel, tier=tier, backing_path=backing_path,
        device_cap_bytes=device_cap_bytes, P=P, mesh=mesh, alpha=alpha,
        io_driver=io_driver, io_queue_depth=io_queue_depth,
        fault_spec=fault_spec, checksums=checksums, io_retries=io_retries,
        io_backoff_s=io_backoff_s, merge_kernel=merge_kernel,
        merge_tile=merge_tile,
        trace=trace, trace_path=trace_path, device=device,
    )
    return pems, load, steps, extract


def psrs_sort(
    keys,
    v: int,
    k: int = 1,
    driver: str = "explicit",
    mode: str = "direct",
    cap: Optional[int] = None,
    rcap: Optional[int] = None,
    local_sort=None,
    return_pems: bool = False,
    use_kernel: bool = True,
    tier: str = "device",
    backing_path=None,
    device_cap_bytes=None,
    P: int = 1,
    mesh=None,
    alpha=None,
    io_driver=None,
    io_queue_depth=None,
    fault_spec=None,
    checksums: bool = False,
    io_retries=None,
    io_backoff_s=None,
    merge_kernel: Optional[bool] = None,
    merge_tile: Optional[int] = None,
    trace: bool = False,
    trace_path: Optional[str] = None,
    device=None,
):
    """Sort int32 ``keys`` ([n], n divisible by v) with PSRS on PEMS.

    Same arguments and results as ``repro.pems_apps.psrs_sort``, on the
    device tier.  ``mode`` selects PEMS2 direct delivery or the
    PEMS1 indirect baseline for the final Alltoallv; ``cap`` is the
    per-(sender,dest) message capacity ω (defaults to the always-safe n/v)
    and ``rcap`` the per-receiver capacity (defaults to the PSRS guarantee
    2n/v).  ``use_kernel`` toggles the kernel paths end to end — the fused
    direct delivery, the bitonic local sort and the tiled k-way merge;
    ``False`` keeps the dense/``torch.sort`` routes (bit-identical).
    ``merge_kernel``/``merge_tile`` (defaults from
    :class:`~repro_torch.core.PemsConfig`) control the merge stage alone.
    ``local_sort`` overrides the local-sort primitive; unlike the JAX
    package's, which sorts one context's ``[n_v]`` keys, it sorts each row
    of the round's ``[k, n_v]`` block.

    ``device`` is where the stages run: CUDA by default (the kernels launch
    there), ``"cpu"`` for the kernels' plain PyTorch versions.

    ``tier`` selects where the context population lives: ``"device"`` (one
    tensor on ``device``; the result is a tensor there), or a backing tier
    — ``"host"`` (RAM), ``"memmap"`` (a disk file at ``backing_path``) or
    ``"file"`` (a disk file behind the :mod:`repro_torch.io` engine;
    ``io_driver`` picks ``buffered``/``odirect``/``mmap``, ``io_queue_depth``
    bounds in-flight requests, ``io_retries``/``io_backoff_s`` retry
    transient errors).  On a backing tier only ``k`` contexts visit the
    device at a time (``device_cap_bytes`` enforces the budget), and the
    result is a CPU tensor, because it lives where the population lives.
    All tiers sort bit-identically.

    ``P`` runs the simulation over ``P`` real processors, each owning
    ``v/P`` contexts.  On the device tier ``mesh`` is a
    :func:`~repro_torch.core.make_mesh` of ``P`` entries on ``device``, or a
    mesh of ``P`` cards whose first is ``device``
    (``Mesh(["cuda:0", ..., "cuda:3"])``: each process's contexts live on
    its own card, and the result is gathered onto the first), and the final
    Alltoallv's network phase is α-chunked over it (``alpha``, Alg 7.1.3);
    on a backing tier no mesh is needed: the backing is sharded,
    one file (``backing_path + ".shard<p>"``), engine, ledger and stats per
    process.  The output is bit-identical to the ``P == 1`` run.

    ``checksums`` keeps CRC sidecars on a disk tier's backing;
    ``io_driver="faulty:<driver>"`` with ``fault_spec`` injects I/O faults
    and ``"sanitize:<driver>"`` records in-flight races.

    ``trace=True`` records the JAX package's structured spans for the whole
    run — per stage and per superstep, executor rounds (compute vs
    swap_in/swap_out vs stall), per-request engine I/O, collective chunks —
    in ``pems.tracer`` (on CUDA the stage and superstep spans begin and end
    on a drained stream; results are bit-identical).  With ``trace_path``
    set the merged Chrome/Perfetto trace (plus a metrics snapshot) is
    written there on completion; inspect with ``python -m repro_torch.obs
    report <path>``.

    Raises ``ValueError`` for n not divisible by v (and for any invalid
    :class:`~repro_torch.core.PemsConfig` combination, or ``P > 1`` on the
    device tier without a mesh of ``P`` entries starting on ``device``),
    ``RuntimeError`` when CUDA is asked for and missing, and
    ``OverflowError`` when a bucket exceeds ``cap``/``rcap``.
    """
    dev = resolve_device(device)
    keys = torch.as_tensor(keys).to(device=dev, dtype=torch.int32)
    n = keys.shape[0]
    if n % v:
        raise ValueError(f"n={n} must be divisible by v={v}")
    n_v = n // v
    pems, program, _ = _build(v, k, n_v, cap, rcap, driver, mode, local_sort,
                              use_kernel=use_kernel, tier=tier,
                              backing_path=backing_path,
                              device_cap_bytes=device_cap_bytes,
                              P=P, mesh=mesh, alpha=alpha,
                              io_driver=io_driver,
                              io_queue_depth=io_queue_depth,
                              fault_spec=fault_spec, checksums=checksums,
                              io_retries=io_retries,
                              io_backoff_s=io_backoff_s,
                              merge_kernel=merge_kernel,
                              merge_tile=merge_tile,
                              trace=trace, trace_path=trace_path,
                              device=dev)
    fields = _result_fields(program(keys.reshape(v, n_v)))
    if pems.cfg.trace_path is not None:
        pems.export_trace()
    out = _sorted_keys(fields, cap, rcap)
    if return_pems:
        return out, pems
    return out



def _snapshot_path(state_dir: str, proc: int = 0, nprocs: int = 1) -> str:
    """Process ``proc``'s snapshot file; the bare name at ``nprocs == 1``
    (the JAX package's names, so a state dir resumes in either package)."""
    if nprocs == 1:
        return os.path.join(state_dir, "stage_snapshot.npz")
    return os.path.join(state_dir, f"stage_snapshot.p{proc}.npz")


def _save_snapshot(state_dir: str, stage: int, fields: dict,
                   proc: int = 0, nprocs: int = 1) -> None:
    """Atomically persist the pre-stage copy of the stage's read∩write
    fields (numpy arrays; at ``nprocs > 1`` process ``proc``'s shard rows
    only)."""
    path = _snapshot_path(state_dir, proc, nprocs)
    atomic_replace_file(
        path, lambda f: np.savez(f, __stage__=np.int64(stage), **fields),
        binary=True)


def _load_snapshot(state_dir: str, stage: int,
                   proc: int = 0, nprocs: int = 1):
    """The snapshot's field dict, iff it belongs to ``stage``."""
    try:
        with np.load(_snapshot_path(state_dir, proc, nprocs)) as z:
            if int(z["__stage__"]) != stage:
                return None
            return {k: z[k] for k in z.files if k != "__stage__"}
    except (OSError, ValueError, KeyError):
        return None


def psrs_run_recoverable(
    keys,
    v: int,
    *,
    state_dir: str,
    k: int = 1,
    P: int = 1,
    alpha: Optional[int] = None,
    driver: str = "explicit",
    mode: str = "direct",
    cap: Optional[int] = None,
    rcap: Optional[int] = None,
    local_sort=None,
    use_kernel: bool = True,
    tier: str = "file",
    io_driver=None,
    io_queue_depth=None,
    fault_spec=None,
    checksums: bool = True,
    io_retries=None,
    io_backoff_s=None,
    device_cap_bytes=None,
    crash_after_stage=None,
    crash_in_stage=None,
    return_pems: bool = False,
    merge_kernel: Optional[bool] = None,
    merge_tile: Optional[int] = None,
    trace: bool = False,
    trace_path: Optional[str] = None,
    device=None,
):
    """PSRS with durable superstep recovery: survives ``kill -9``.

    Runs the :func:`psrs_plan` stages against a backing file in
    ``state_dir`` (``ctx.bin``), recording a durable
    :class:`~repro_torch.core.SuperstepCursor` around every stage and an
    atomic pre-stage snapshot of the fields the stage both reads and writes
    (``STAGE_SNAPSHOT_FIELDS``).  Killed at any point — between stages,
    mid-stage, even mid-``pwrite`` — a rerun with the same arguments
    resumes from the last completed stage and returns output bit-identical
    to an uninterrupted run.  The state dir's files (``ctx.bin``, its
    ``.crc`` sidecar, ``cursor*.json``, ``stage_snapshot*.npz``) are the
    JAX package's, so a run killed in one package resumes in the other.

    The stages run on ``device`` (CUDA by default: the local sort and merge
    kernels launch there, ``k`` contexts at a time; ``"cpu"`` runs their
    plain versions) and the result is a CPU tensor.

    ``P > 1`` runs the parallel disk model: the backing is sharded into
    ``P`` per-process files and recovery state is per process — one cursor
    (``cursor.p<p>.json``) and one snapshot per shard, each stage committed
    shard by shard (run with ``procs=[p]``, flushed through the shard's own
    backing).  A failure on one shard's disk (``fault_spec="shard=1;..."``)
    leaves the other processes' cursors at the completed stage, and the
    rerun re-executes only the failed process's stage.

    ``checksums`` (default on) keeps per-block CRCs on the backing file, so
    a torn write in the in-progress stage is detected and healed by the
    rerun; completed stages are flushed before their cursor commits.

    ``crash_after_stage`` / ``crash_in_stage`` (a stage name or index;
    ``"load"`` is stage 0) SIGKILL the process at the stage boundary /
    between the stage's compute and its flush (at ``P > 1``: after the last
    process's compute) — the chaos tests' hooks.

    Raises ``ValueError`` for a non-disk ``tier`` or n not divisible by v,
    ``RuntimeError`` when CUDA is asked for and missing, and
    ``OverflowError`` when a bucket exceeds ``cap``/``rcap``.
    """
    dev = resolve_device(device)
    keys = torch.as_tensor(keys).detach().to(device="cpu", dtype=torch.int32)
    n = keys.numel()
    if n % v:
        raise ValueError(f"n={n} must be divisible by v={v}")
    if tier not in ("memmap", "file"):
        raise ValueError(
            f"recovery needs a disk tier ('memmap' or 'file'), got {tier!r}")
    n_v = n // v
    os.makedirs(state_dir, exist_ok=True)
    backing_path = os.path.join(state_dir, "ctx.bin")
    pems, _, steps, extract = psrs_plan(
        v, n_v, k=k, P=P, alpha=alpha, driver=driver, mode=mode,
        cap=cap, rcap=rcap, local_sort=local_sort, use_kernel=use_kernel,
        tier=tier, backing_path=backing_path,
        device_cap_bytes=device_cap_bytes, io_driver=io_driver,
        io_queue_depth=io_queue_depth, fault_spec=fault_spec,
        checksums=checksums, io_retries=io_retries,
        io_backoff_s=io_backoff_s, merge_kernel=merge_kernel,
        merge_tile=merge_tile, trace=trace, trace_path=trace_path,
        device=dev)

    m_ctx = v // P                        # contexts per process
    data_blocks = keys.reshape(v, n_v).numpy()

    # "load" is stage 0 (idempotent: it rewrites data from the caller's
    # input).  pems.init() runs once below, so load writes the field rather
    # than calling psrs_plan's own load (a second backing on the same file).
    def load_stage(st, procs=None):
        for p in (range(P) if procs is None else procs):
            st = st.with_field_rows(
                "data", p * m_ctx, data_blocks[p * m_ctx:(p + 1) * m_ctx])
        return st

    stages = [("load", load_stage)] + list(steps)

    def _stage_index(which):
        if which is None:
            return None
        if isinstance(which, str):
            for i, (name, _) in enumerate(stages):
                if name == which:
                    return i
            raise ValueError(f"unknown stage {which!r}")
        return int(which)

    crash_after = _stage_index(crash_after_stage)
    crash_in = _stage_index(crash_in_stage)

    cursors = [SuperstepCursor(SuperstepCursor.path_for(state_dir, p, P))
               for p in range(P)]
    for p, cur in enumerate(cursors):
        cur.tracer = pems.tracer
        cur.trace_tid = f"recovery.p{p}" if P > 1 else "recovery"
    pems.cursors = cursors

    store = pems.init()      # create-or-reuse: committed rows are kept
    bk = store.backing
    for p in range(P):
        st = cursors[p].state()
        in_prog = None if st is None else st.get("in_progress")
        if in_prog is None:
            continue
        if bk.checksum is not None:
            # The sidecar records the intended CRCs of writes the crash may
            # have torn; those rows belong to the in-progress stage and are
            # about to be regenerated, so re-bless the bytes on disk — only
            # the dirty process's shard under a sharded backing.
            if hasattr(bk, "shards"):
                bk.recompute_checksums(shard=p)
            else:
                bk.recompute_checksums()
        snap = _load_snapshot(state_dir, int(in_prog), p, P)
        if snap is not None:
            with pems.tracer.span("snapshot:restore", tid="recovery",
                                  cat="recovery", proc=p,
                                  stage=int(in_prog)):
                for fname, val in snap.items():
                    store = store.with_field_rows(fname, p * m_ctx, val)

    for i, (name, fn) in enumerate(stages):
        todo = [p for p in range(P) if i > cursors[p].completed]
        for p in todo:
            fields = STAGE_SNAPSHOT_FIELDS.get(name, ())
            if fields:
                with pems.tracer.span("snapshot:save", tid="recovery",
                                      cat="recovery", proc=p, stage=i):
                    _save_snapshot(
                        state_dir, i,
                        {f: store.field_rows(f, p * m_ctx,
                                             (p + 1) * m_ctx).numpy()
                         for f in fields},
                        p, P)
            cursors[p].mark_in_progress(i, name)
            store = fn(store, procs=[p])
            if crash_in == i and p == todo[-1]:
                os.kill(os.getpid(), signal.SIGKILL)
            # Commit this process's writes only: its shard's backing (and
            # sidecar) flush before its cursor advances.  Stages write
            # nothing outside the listed shard.
            if hasattr(bk, "flush_shard"):
                bk.flush_shard(p)
            else:
                store.flush()
            cursors[p].mark_completed(i, name)
        if todo and crash_after == i:
            os.kill(os.getpid(), signal.SIGKILL)

    if pems.cfg.trace_path is not None:
        pems.export_trace()
    result, rcount, oflow = extract(store)
    if bool(oflow.any()):
        raise OverflowError(
            "PSRS message capacity exceeded; raise cap/rcap "
            f"(cap={cap}, rcap={rcap})"
        )
    counts = rcount[:, 0].tolist()
    out = torch.cat([result[i, :counts[i]] for i in range(v)])
    if return_pems:
        return out, pems
    return out
