#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

What it does, in order; any failure raises and the exit code is non-zero:

1. Requires CUDA (exits 1 at once without it) and prints the card's
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together) and prints the build seconds.
3. Holds each kernel against its plain PyTorch version on the card at edge
   shapes (ragged widths, empty and full counts, extreme, duplicate and
   all-equal keys, rows and tiles up to and past one shared-memory segment,
   where the local sort turns from the bitonic pass to the radix kernel, and
   radix rows of several tiles, strided; for the k-way merge's splitters
   and segment merge, ``KWAY_EDGES``: v of 1 to 64, windows cut inside
   runs of equal keys, counts of 0 and of cap, fill-only segments, total
   past rcap, rcap past v·cap, tiles of 1 to 1024, many segments, and the
   tile sort up to and past the warp-register sort's 1024 keys; for the
   mesh staging, kernel 4, P of 1, 2 and 4, counts of 0, of ω, past ω and
   negative, fills None, -7 and INT_MAX with and without the counts payload,
   α-chunk offsets, a float32 payload, and both destination layouts, the
   contiguous buffer and the receivers' recv rows of the store it reads, at
   send and recv word offsets of every phase mod 4 over a row stride of 2
   mod 4).  Equality is exact.
3b. The same kernels in every dtype their JAX counterparts take
   (``dtype_edge_checks``): the local sort's bitonic pass and radix kernel
   in bool, int8, uint8, int16, uint16, int32, uint32, float16, bfloat16
   and float32 over rows of 1 to 2^17 keys (±0, NaNs of both signs and
   several payloads, ±inf, subnormals, type extremes, all-equal rows),
   strided rows and ``ops.sort`` on ragged widths, bits compared as
   integers against the plain version and ``torch.sort(stable=True)``;
   kernel 3 in uint32 over ``KWAY_EDGES`` (fill 0xFFFFFFFF, keys at and
   past 2^31) and its tile sort; kernels 6 and 7 in bf16 and fp16 at small
   ragged shapes within one output ulp of the plain version (``y`` and
   ``h`` in the operand's dtype, the final states fp32); kernel 5 in fp16
   at the bf16 edge tables (every mask, GQA, decode splits) and at every
   head dim over strided caches, within one fp16 ulp (2^-13 + 2^-10
   |plain|), and kernel 5b in fp16 at ``BWD_EDGES`` for output gradients
   of unit scale and of 2^-16 (``BWD_FP16_TOL``), two runs bit-equal;
   kernels 2 and 4 on bool, int8, uint8, int16, uint16, fp16 and bf16
   payloads (ω of 1, 3, 130 and 257; counts of 0, of ω, past ω and
   negative; fills of None, a value and the type's extremes; with and
   without a narrow counts payload), bit for bit against the plain
   version.  Then (rows ``radix_sort_f32``, ``radix_sort_bf16``,
   ``kway_splitters_u32``, ``kway_merge_segments_u32``,
   ``deliver_tiles_bf16``, ``deliver_tiles_i8``,
   ``assemble_proc_tiles_bf16``, ``ssd_scan_bf16``, ``lru_scan_bf16``,
   ``flash_attention_f16``, ``flash_attention_window_f16``) each at full
   width on the main path's shapes (the delivery rows at rows 2r's and
   4's bytes), driven through its entry point (``ops.sort``,
   ``kway_merge``, ``deliver_fused``, ``assemble_proc_fused``,
   ``ops.ssd_scan``, ``ops.lru_scan``, ``attend``) with the counts reset
   just before, beside its plain version, its bound and its library call.
   Then qwen2-1.5b with ``dtype="float16"`` at full width, cut to its
   first 8 layers, served (8 prompts of 1024, 64 tokens) and trained (2
   steps of 8 x 1024 tokens), kernels 5 and 5b launched and the losses
   finite, and row
   ``flash_attention_bwd_f16`` at its step's last kernel-5b call.  Alone:
   ``python3 chip_smoke.py --dtypes-only`` (the merge rows then on
   synthesized buckets of round 0's shape).
4. Drives the main path once through ``psrs_sort``: 2^27 int32 keys, v = 16,
   k = 4, the async driver, every kernel on; the output must equal
   ``torch.sort``, and the launch count (reset just before) of every kernel
   of the path must be above zero: the local sort, the delivery, and the
   merge's splitters and segment merge (the gathered-tile sort,
   ``merge_tile_grid``, is off the main path and reports its count).
5. Runs the same plan stage by stage (``psrs_plan``) a few times under
   each driver (explicit, sliced, async) with CUDA-event stage times and
   each stage's peak device memory, checks ``rcount``/``oflow``, and times
   each driver's swap cost alone (a superstep whose function changes
   nothing).  Times one ``torch.sort`` of the same keys as a yardstick,
   and then times each kernel, its plain
   version and, where one exists, the one PyTorch call computing the same
   function, on the inputs the async run gave it (the local sort on a fresh
   store's strided rows, as a round hands them over; the merge on round 0's
   received buckets where the store holds them).  Takes the merge stage's
   round 0 apart before and after the fused merge
   (``scripts/merge_stage_split.py``: each phase between CUDA events, and
   each route's device time by kernel from ``torch.profiler``).
5b. The ``P > 1`` path: ``psrs_sort`` on the same keys over ``MESH_P`` (4)
   real processors of a one-card mesh, k = ``MESH_K`` (2), unchunked under
   the async driver and α-chunked (α = 1) under the explicit driver.  Each
   run resets every kernel count just before it; its output must equal
   ``torch.sort`` and the ``P == 1`` run, the local sort, merge and mesh
   staging (kernel 4) counts must be above zero, and kernel 4's launches
   and ``pems.ledger.network_rounds`` must equal the closed form of
   ``repro_torch.core.analysis``.  Times both plans stage by stage, prints
   their ``alltoallv`` stage beside the ``P == 1`` ones, and times kernel 4
   and its plain version on the α = 1 run's first chunk as the main path
   lands it, in the receivers' recv rows (exact against the plain version
   and the buffer layout), with the buffer layout's time beside it, and
   kernel 4 on the unchunked run's one chunk (8 GiB) beside kernel 2 on the
   same words.
5d. The mesh-of-cards route (``run_forced_cards``) forced onto ``MESH_P``
   blocks of the one card (a mesh whose ``spans_devices`` says so): 2^24
   keys, k = 2, unchunked (async) and α = 1 (explicit); the sorted keys and
   every final store word must equal the one-card fused route's, and
   kernel 4 stage once a sender a chunk.  Times kernel 4 as a sender's
   staging kernel into the wire buffer.
5c. Tracing (``run_trace``, ``PemsConfig(trace=True)``): (a) the main path
   traced, 2^27 keys, v = 16 on the device tier at P = 1 under the explicit
   driver, untraced and traced in turns (host clock, synchronised), its
   local sort's launches between CUDA events; the keys must equal the
   untraced run's, every kernel of the path must launch, and the
   ``sort_sample`` span must last at least its kernel-1 launches' CUDA-event
   time (a span closed at launch would not).  (b) The same at P = 4 on the
   one-card mesh (α = 1, kernel 4).  (c) The file tier traced: 2^24 keys,
   k = 2 of v = 16 under the async driver; keys and ledger equal to the
   untraced run's, the report's span-derived overlap equal to
   ``TierStats.overlap_fraction`` within 1e-9 (the spans are billed from
   the same clock readings), engine request spans and ``queue_depth``
   counters present.  (d) Prints ``python -m repro_torch.obs report`` of
   (a) and (c).  Alone: ``python3 chip_smoke.py --trace-only``.
6. Runs a smaller matrix at 2^20 keys: all drivers, direct and indirect,
   random and duplicate-heavy keys, the dense routes, P of 2 and 4 over
   every driver, mode and α in {None, 1}, and CPU-vs-GPU bit-for-bit
   comparisons at 2^14 keys (P = 1, and P = 4 with equal ledgers).
6b. The backing tiers (``run_tiered``): the host link, PSRS at full scale
   with k = 2 of v = 16 contexts on the card under an 8 GiB budget on the
   host and file tiers, and a 2^20 matrix of tiers, drivers, P and I/O
   drivers.
6c. Crash recovery (``run_recovery``): ``psrs_run_recoverable`` on the
   file tier at the tiered phase's shape and half its keys
   (``RECOVERY_LOG_N``, 2^26), (a) with checksum
   sidecars and (b) without, stage by stage with the seconds of snapshots,
   cursor writes, commit flushes and CRCs (``RecoveryClock``); (c) a child
   killed by SIGKILL in the merge stage and (d) its resume in a fresh child.
   (a), (b) and (d) must equal ``torch.sort`` (and (d) (a)), the modeled
   ledger the device tier's, the peak device memory stay under v·μ, and the
   resume rerun the merge alone.  Then a matrix at 2^20 keys, each leg a
   child, the chains side by side: SIGKILL in and after every stage
   (buffered), in one stage under odirect and mmap, seeded EIO absorbed
   (injected equals retries), a torn write healed, the sanitizer clean, and
   at P = 2 a kill on shard 1's disk after which only process 1 reruns.
   Alone: ``python3 chip_smoke.py --recovery-only``.
6d. The other BSP apps and the collectives (``run_apps``).  The prefix sum
   of 2^29 full-range int32 keys (the sums wrap; the store 4 GiB): the
   device tier at v = 16, k = 4 under each driver, then k = 2 of 16
   contexts on the card (the budget 3·k·μ, the least the async driver
   admits) on the host and file tiers, sliced and async; each must equal
   ``torch.cumsum``, each tiered run's modeled ledger the device tier's,
   and sliced must swap less than explicit.  List ranking of 2^25 elements
   (a seeded permutation cut into n/16 lists; the store 12.5 GiB), v = 16,
   k = 4, direct mode under each driver and indirect mode once: the ranks
   exact against the construction's, and kernel 2 launched 2·⌈log₂ n⌉ =
   50 times a direct run; kernel 2 timed at both message shapes (rows 2r,
   2a) against its plain version and its bound.  The Euler tour of a
   46,340-node forest of 4 trees: the CPU run's five arrays bit for bit,
   each tree's edges in DFS order, kernels 1, 3s, 3m and 2 launched.
   ``allgather``, ``reduce`` (add, max, min; root 3) and ``allreduce`` at
   v = 16 on 2^20-word fields in int32, uint32 (past 2^31) and float32 on
   the device tier at P = 1 and 4 and the host tier (with ``procs=``):
   integers equal a plain reference, float32 sums within 1e-6 of the sum
   of their terms' magnitudes, the host tier the device tier's bits, every
   ledger the CPU run's.  Alone: ``python3 chip_smoke.py --apps-only``.
7. The LM serving path.  Holds flash attention, the SSD scan and the LRU
   scan against their plain versions at the CPU tests' edge shapes, at
   qwen2's head dim 128 and at recurrentgemma's sliding window and head dim
   256 (float32, atol 1e-5; SSD within 1e-4 (1 + |plain|), LRU within
   1e-5 (1 + |plain|)), then the same flash calls in bf16, on the
   tensor-core kernel, within 2^-10 + 2^-7 |plain| (``sk_valid`` 0, 1 and
   sk/2 + 1, decode ``q_offset``, windows 1, 16 and 100, prefix-LM masks
   of 1, 37 and 70 keys alone and under a window of 16, at arctic's GQA
   group of 7 and paligemma's group of 8 at head dim 256).  Runs the
   smoke-width qwen2-1.5b, mamba2-130m, recurrentgemma-2b, kimi-k2,
   arctic and paligemma (with 8 patch embeddings) in float32 with TF32
   off on the card and on the CPU from the same parameters (40-token
   prompts, past recurrentgemma's smoke window of 16): prefill logits
   within 1e-4, greedy tokens equal.
8. Serves qwen2-1.5b, mamba2-130m, recurrentgemma-2b, kimi-k2-1t-a32b and
   arctic-480b (each cut to its first ``MOE_DEPTH`` (2) layers: kimi's
   dense first layer and one MoE layer, arctic's two MoE layers, 19.9 and
   27.7 G parameters) and paligemma-3b at full width (bf16, random weights
   from ``--seed``): ``REQUESTS`` (8) prompts of ``PROMPT_LEN`` (1024)
   positions (paligemma: 256 random patch embeddings and 768 tokens,
   through the engine's ``extra_batch``), or ``HYBRID_PROMPT_LEN`` (3072,
   so that its 2048-token window masks keys) for recurrentgemma,
   ``GEN_LEN`` (64) greedy tokens, every kernel's count reset just before
   each run and the model's own kernels (recurrentgemma: the LRU scan and
   flash attention) required above zero after it.  On kimi's MoE layer
   at full width, holds the capacity dispatch against the dense oracle
   on 64 tokens (bf16), with nothing dropped and at the published
   capacity factor, which drops (``moe_oracle_check``).  Prints prefill ms, decode ms per step
   (median), generated tokens/s and peak memory, checks the tokens and that
   the prefill logits keep a cosine of 0.99 with the same model on the
   kernels' plain versions, and times the prefill and one decode step on
   the device alone, layer by layer queued behind a sleep kernel, to give
   the device's busy share.
9. Holds each float kernel against its plain version at the serve shapes
   (flash: qwen2's causal prefill over the cache and a decode call whose
   ``sk_valid`` is no tile multiple, recurrentgemma's windowed ones, and
   kimi's, arctic's and paligemma's prefills, the last under its 256-key
   prefix,
   bf16 within 2^-10 + 2^-7 |plain|: both sum in fp32 and round once, the
   kernel's P entering P·V as bf16 hi + lo, so they differ by one bf16 ulp
   at most; SSD: the prompt length and a ragged
   one; LRU: the prompt length and a ragged one) and times it beside its
   plain version and ``scaled_dot_product_attention`` (never called by the
   port); the short decode calls, and their library calls, on the device
   alone.  Alone, phases 7-9: ``python3 chip_smoke.py --lm-only``.
10. Training (``run_train``).  (a) Kernel 5's lse and kernel 5b (the
   backward, ``csrc/flash_attention_bwd.cu``) against their plain versions
   at ``BWD_EDGES`` in fp32 and bf16: head dims 16, 64, 80, 128 and 256,
   causal, non-causal, the prefix-LM mask, windows, GQA groups 1, 6, 7
   and 8, one query row, ragged lengths, sk_valid, q_offset, forward
   plans that split the keys, the bf16 tensor-core passes' ragged
   64-key and 64-row tiles, and at head dim 256 their row slices (1, 2,
   3 and 11 a key tile) (``BWD_FP32_TOL``, ``BWD_BF16_TOL``,
   ``LSE_TOL``); kernel 5b twice gives the same bits.  Kernels 6b and 7b
   (the SSD and RG-LRU scans' backward, ``csrc/ssd_scan_bwd.cu`` and
   ``csrc/lru_scan_bwd.cu``) against their plain versions at
   ``SSD_BWD_EDGES`` and ``LRU_BWD_EDGES``: one step, lengths shorter than
   their chunks and not multiples of them, every built (N, P), the final
   state's gradient given and None, the model's strided views
   (``SSD_BWD_TOL``, ``LRU_BWD_TOL``); each twice gives the same bits.
   (b) hubert-xlarge whole (48 layers, d 1280, bf16, remat per layer, 0.947
   G parameters) for 5 AdamW steps of 16 x 1024 frames in 2 microbatches,
   through the API ``python -m repro_torch.launch.train`` drives, each
   step's loss, gnorm, ms, frames/s, peak memory and kernel 5 and 5b
   launches and device ms (``KernelClock``: CUDA events around each
   wrapper call of kernels 5, 5b, 6, 6b, 7 and 7b); then 5 steps on one
   fixed batch at peak lr ``FIXED_LR``, whose loss must fall.  (c)
   qwen2-1.5b whole, 3 steps of 8 x 1024 tokens.  (d) mamba2-130m whole
   (24 layers, d 768, 24 SSD heads of 64, state 128), 3 steps of 16 x 2048
   tokens: kernels 6 (twice a layer under remat) and 6b.  (e)
   recurrentgemma-2b whole (26 layers: 18 RG-LRU and 8 local attention of
   10 heads of 256 over one KV head, window 2048; 2.895 G parameters), 3
   steps of 4 x 3072 tokens in 2 microbatches: kernels 7, 7b, 5 and 5b at
   head dim 256 in bf16.  Every step of (b)-(e) must launch each of its
   layers' kernels as often as ``step_launches`` says; each run prints a
   step under ``torch.profiler`` with the device ms by kernel.  (f) One
   full-width layer of each kind in fp32 (TF32 off), ``LAYER_CHECKS``: a
   hubert layer, a mamba2 layer, a recurrentgemma rec layer and its
   local-attention layer (3072 positions, past the window): its gradients
   with the kernels against the layer's mixer differentiated through its
   plain version, every leaf within ``LAYER_GRAD_TOL`` of its largest
   element.  (g) paligemma-3b's, kimi-k2's, mamba2-130m's and
   recurrentgemma-2b's smoke configs, 3 steps on the card and on the CPU
   from the same weights (the prefix-LM mask, the MoE block's backward,
   the SSD and RG-LRU scans' backward), losses within
   ``SMOKE_LOSS_RTOL``.  Then, at the shapes, dtype and mask of the last
   kernel-5b call in a step of hubert, qwen2, paligemma's smoke config
   (prefix 8) and recurrentgemma (bf16, head dim 256, window 2048: kernel
   5b's FMA passes), kernel 5's output and lse against the plain version
   and kernel 5b beside its plain version, its bound,
   ``scaled_dot_product_attention``'s forward plus backward
   (``library_ms``; a boolean mask for the prefix and the window) and its
   backward alone (``library_bwd_ms``, the same function as kernel 5b)
   (rows ``flash_attention_bwd``, ``_qwen2``, ``_prefix``, ``_window``),
   and kernel 5 with lse beside its plain version, its bound and
   ``torch.ops.aten._scaled_dot_product_flash_attention`` (output and
   logsumexp; KV heads expanded) at hubert's and qwen2's shapes (rows
   ``flash_attention_lse``, ``_lse_qwen2``);
   and at the shapes of the last kernel-6b and 7b calls of
   mamba2's and recurrentgemma's steps, kernels 6b and 7b against their
   plain versions, timed beside them and their bounds (no PyTorch call
   computes either: ``library_ms`` null), and kernels 6 and 7's forwards
   at the same shapes (rows ``ssd_scan_bwd``, ``ssd_scan_train``,
   ``lru_scan_bwd``, ``lru_scan_train``).  Alone:
   ``python3 chip_smoke.py --train-only``.
10b. The training driver's checkpoints (``run_resume``): ``main`` of
   ``repro_torch.launch.train`` for mamba2-130m at full width, 6 steps of
   2 × 2048 tokens (kernels 6 and 6b), in children: an uninterrupted run
   (a checkpoint at step 6) beside one with a checkpoint every 2 steps,
   killed by SIGKILL once step 4's has committed, then resumed in a fresh
   child.  The resumed step-6 checkpoint must equal the uninterrupted one
   chunk CRC for chunk CRC (a leaf that differs is named with its largest
   error and fails the phase), steps 5 and 6 print the same loss and
   gradient norm; then the checkpoint restored from a ``meta`` like onto
   ``cuda:0`` by ``placements`` (each leaf's CRCs the uninterrupted
   run's).  Prints the children's timelines, the resume's wall seconds,
   each save's seconds and GB/s and the restores'.  Alone:
   ``python3 chip_smoke.py --resume-only``.
11. The dry run (``repro_torch.launch.dryrun``) held against the card:
   three traces, each in a process of its own on the host's CPU (fake
   tensors, nothing on the card), while the card runs the same steps for
   real.  (a) qwen2-1.5b ``train_4k`` at global batch 4 in 2 microbatches
   and (b) its ``decode_32k`` at batch 8, on a one-device mesh: the traced
   flops equal ``FlopCounterMode`` over one real step and the traced
   argument bytes the real parameters', moments', batch's and cache's
   bytes, exactly; the traced peak within ``DRYRUN_PEAK_RTOL`` of
   ``torch.cuda.max_memory_allocated()`` over the real step; it prints the
   real step's ms beside the trace's ``step_lower_bound_s`` over the
   H100's constants.  (c) mamba2-130m ``train_4k`` on the 16×16 production
   mesh: its per-device GB, dominant term and trace seconds; in the whole
   run its trace starts before the serving phase and runs beside it.
   Alone: ``python3 chip_smoke.py --dryrun-only``.
12. The device tier over a mesh of four cards (``run_cards``), where four
   cards are visible (else one line says it was not run and why; alone:
   ``python3 chip_smoke.py --cards-only``, which exits 1 on fewer): each
   card's name and power limit, ``nvidia-smi topo -m``, peer access; a
   1 GiB card-to-card ``copy_`` and every card to every other at once
   (the yardstick); PSRS over ``Mesh(["cuda:0", ..., "cuda:3"])`` at 2^27
   keys (k 2, explicit α = 1 and async unchunked, as 5b) and at 2^29 (a
   store past one card; k 1, α = 1 and unchunked): keys equal to
   ``torch.sort``, ``rcount``/``oflow``, the modeled ledger the one-card
   mesh's, kernel counts by card, block p on card p, stage ms and each
   card's peak (at 2^29 under α = 1 within 1.5 × v·μ/P), the exchange's
   bytes and GB/s; kernel 4 as a sender's staging kernel on card 1 (row
   ``assemble_proc_tiles_wire``); the five collectives on 2^20-word fields
   bit for bit against a one-card mesh.
12b. Elastic checkpoints over cards (``run_elastic``, with phase 12;
   alone: ``python3 chip_smoke.py --elastic-only``): qwen2-1.5b's train
   state at full width (bf16 weights, fp32 moments) laid out over a
   ``(data 1, model 4)`` mesh by ``param_placements`` and
   ``opt_placements`` (``shardings_for``), saved from DTensors by four NCCL
   rank processes (rank 0 writes every leaf whole), then restored over
   ``(data 1, model 2)`` by two from a ``meta`` like: every local shard
   bit for bit its slice of the state rebuilt from the seed; the bytes,
   save and restore GB/s, each rank's host and card peaks.
13. Prints the stage and kernel times, peak device memory, one ``kernels``
   JSON line, and last ``{"ok": true, "device": {...}}``.

A kernel's bound is the larger of two times: the bytes the function must
move (each input read once, each output written once) over the H100 SXM's
3.35 TB/s of HBM bandwidth, and the operations it must do over the card's
rate for their type: int32 16.7 T/s (132 SMs x 64 int32 lanes x 1.98 GHz;
the data sheet gives no int32 figure), bf16 989 TFLOP/s on the tensor
cores, fp32 67 TFLOP/s outside them, and fp32 to fp32 accuracy on the
tensor cores as 3xTF32 (three TF32 products a product, the SSD kernel's
way) at a third of dense TF32's 494.7 TFLOP/s.  For a sort the operations
are the comparisons any comparison sort needs, log2(n!) per row of n; the
k-way merge tiles' bitonic network's own min/max count describes the
algorithm, not the function, and is printed beside it for information.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import itertools
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
INT_MIN, INT_MAX = -2**31, 2**31 - 1
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.7e12
BF16_FLOPS_PER_S = 989e12   # dense bf16 on the tensor cores
FP32_FLOPS_PER_S = 67e12    # fp32 outside the tensor cores
TF32_FLOPS_PER_S = 494.7e12  # dense TF32 on the tensor cores
# fp32 work done as 3xTF32: three TF32 products for each one
TF32X3_FLOPS_PER_S = TF32_FLOPS_PER_S / 3


# Kernel 4 (the P > 1 mesh staging) edge shapes, as assemble_words takes
# them: (m, P, nq, s0, s, c0, d, ww) — P of 1, 2 and 4, ragged ω and ω past
# one block's 1024-word chunk, α-chunk offsets s0, c0 != 0.
ASSEMBLE_EDGES = [(1, 1, 1, 0, 1, 0, 1, 1), (4, 2, 2, 0, 4, 0, 4, 127),
                  (4, 4, 4, 2, 2, 1, 1, 300), (4, 4, 3, 1, 3, 2, 2, 1030),
                  (2, 4, 4, 0, 2, 0, 2, 1)]
# Kernel 4's destination phases: (send offset, recv offset) mod 4 words
# over a store row stride of 2 mod 4 words, as PSRS's store has it.
ASSEMBLE_PHASES = [(1, 3), (2, 2), (3, 1), (0, 2), (1, 1)]
# The P > 1 path: real processors on the one card, and contexts resident
# per real processor.
MESH_P, MESH_K = 4, 2
# The device's peak memory over the script, kept across reset_peak().
SCRIPT_PEAK = [0]
# The tiered phase: contexts resident per real processor, the device budget
# for them (the population is v·μ ≈ 17.5 GiB at 2^27 keys), real
# processors of the sharded runs, and where the disk backings go (inside
# the checkout, git-ignored).
TIER_K, TIER_CAP, TIER_P = 2, 8 << 30, 4
TIER_DIR = ROOT / "build" / "tiered"
# PSRS's four supersteps' declared (reads, writes), as
# src/repro_torch/pems_apps/psrs.py declares them: what the sliced driver
# swaps.
PSRS_DECLARED = [(["data"], ["data", "samp"]), (["allsamp"], ["gsplit"]),
                 (["data", "gsplit"], ["bsend", "bscnt", "oflow"]),
                 (["brecv", "brcnt", "oflow"], ["result", "rcount", "oflow"])]
# The IOLedger counters a backing tier measures; every other one is
# modeled and equals the device tier's.
IO_NAMES = ("buffered", "odirect", "mmap")
MEASURED = ("h2d_bytes", "d2h_bytes", "disk_read_bytes", "disk_write_bytes",
            "syscall_read_bytes", "syscall_write_bytes", "tier_total")
# The fused k-way merge's edges, (k, v, cap, keys, counts, rcap, tile,
# segment tiles), as tests/test_torch_gpu.py has them: v of 1, 16, 33 and 64
# (one and two warps of buckets, odd merge levels), windows cut inside runs
# of equal keys, all-equal buckets, one bucket a segment, counts of 0 and of
# cap, fill-only segments, total past rcap, rcap past v·cap and ragged,
# tiles of 1 to 1024, many segments, the built size (32 tiles of 256) and
# twice it.
KWAY_EDGES = [(2, 1, 300, "dups", "random", 600, 256, 1),
              (3, 16, 300, "dups", "random", 600, 8, 4),
              (2, 16, 300, "equal", "full", 2000, 2, 64),
              (2, 33, 100, "extremes", "random", 1500, 8, 8),
              (2, 16, 1000, "random", "zero", 1000, 256, 2),
              (2, 16, 4096, "random", "random", 8192, 256, 32),
              (2, 16, 4096, "dups", "random", 9000, 256, 64),
              (2, 4, 5000, "presorted", "full", 20000, 256, 64),
              (2, 16, 300, "random", "full", 1000, 256, 2),
              (2, 16, 64, "dups", "random", 999, 1024, 4),
              (1, 64, 50, "dups", "random", 3000, 16, 16),
              (2, 8, 40, "extremes", "random", 333, 1, 32)]
# Each kernel's launch counter on the PSRS paths: (module, attribute).
COUNTERS = {"radix_sort": ("bitonic", "LAUNCHES"),
            "alltoallv_deliver": ("deliver", "LAUNCHES"),
            "kway_splitters": ("kway", "SPLIT_LAUNCHES"),
            "kway_merge_segments": ("kway", "SEGMENT_LAUNCHES"),
            "kway_merge_tiles": ("kway", "LAUNCHES"),
            "assemble_proc_tiles": ("deliver", "ASSEMBLE_LAUNCHES")}


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def child_env() -> dict:
    """The environment of this script's children: ours, ``src`` importable."""
    import os
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def rand_int32(shape, gen, kind="random"):
    dev = gen.device
    if kind == "random":
        x = torch.randint(INT_MIN, INT_MAX + 1, shape, generator=gen,
                          device=dev, dtype=torch.int64)
    elif kind == "dups":
        x = torch.randint(0, 4, shape, generator=gen, device=dev,
                          dtype=torch.int64)
    elif kind == "equal":                   # one bin holds the whole row
        x = torch.full(shape, -3, device=dev, dtype=torch.int64)
    else:                                   # extremes
        pool = torch.tensor([INT_MIN, INT_MIN + 1, -1, 0, 1, INT_MAX - 1,
                             INT_MAX], device=dev)
        x = pool[torch.randint(0, len(pool), shape, generator=gen,
                               device=dev)]
    return x.to(torch.int32)


def kway_inputs(gen, k, v, cap, kind, cnt_kind):
    """Sorted buckets ``[k, v, cap]`` whose lanes past the counts hold random
    words, as strided views of wider rows, and their counts (a view too)."""
    dev = gen.device
    if kind == "presorted":                   # bucket j below bucket j + 1
        b = torch.arange(k * v * cap, device=dev, dtype=torch.int32)
        b = b.reshape(k, v, cap)
    else:
        b = torch.sort(rand_int32((k, v, cap), gen, kind), dim=-1).values
    c = {"random": torch.randint(0, cap + 1, (k, v), generator=gen,
                                 device=dev, dtype=torch.int32),
         "full": torch.full((k, v), cap, device=dev, dtype=torch.int32),
         "zero": torch.zeros((k, v), device=dev, dtype=torch.int32)}[cnt_kind]
    if cnt_kind == "random":
        c[0, 0], c[-1, -1] = 0, cap
    lane = torch.arange(cap, device=dev)
    b = torch.where(lane < c[..., None], b, rand_int32((k, v, cap), gen))
    rows = torch.zeros((k, v * cap + v + 40), dtype=torch.int32, device=dev)
    rows[:, 24:24 + v * cap] = b.reshape(k, -1)
    rows[:, 24 + v * cap:24 + v * cap + v] = c
    return (rows[:, 24:24 + v * cap].view(k, v, cap),
            rows[:, 24 + v * cap:24 + v * cap + v])


def set_counts(kern, value: int = 0) -> None:
    for mod, attr in COUNTERS.values():
        setattr(kern[mod], attr, value)


def read_counts(kern, names) -> dict:
    return {n: getattr(kern[COUNTERS[n][0]], COUNTERS[n][1]) for n in names}


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls (after one warm-up
    call), between CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def same(a, b, what: str) -> int:
    """Exact equality of two int32 tensors; returns the max |a - b| (0).
    Only the differing elements are widened, so an 8 GiB operand costs one
    byte per element of scratch."""
    torch.cuda.synchronize()
    check(a.shape == b.shape, f"{what}: shapes {a.shape} vs {b.shape}")
    ne = a != b
    err = 0
    if bool(ne.any()):
        err = int((a[ne].to(torch.int64) - b[ne].to(torch.int64)).abs().max())
    check(err == 0, f"{what}: max |kernel - plain| = {err}")
    return err


def network_ops(rows: int, n: int) -> int:
    """min + max operations of the bitonic network over [rows, n]."""
    L = n.bit_length() - 1
    return 2 * rows * (n // 2) * L * (L + 1) // 2


def sort_ops(rows: int, n: int) -> float:
    """Comparisons any comparison sort needs for [rows, n]: log2(n!) a row."""
    return rows * math.lgamma(n + 1) / math.log(2)


def bound(nbytes: int, ops: float = 0, rate: float = INT32_OPS_PER_S):
    """(ms, what bounds it): the larger of the bytes over the HBM rate and
    the operations over ``rate``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def edge_checks(gen, kern) -> None:
    bs, km, dv = kern["bitonic"], kern["kway"], kern["deliver"]
    from repro_torch.kernels.bitonic_sort import bitonic_sort
    from repro_torch.kernels.kway_merge import kway_merge, kway_merge_ref
    # The local sort: one shared-memory bitonic pass up to 2^13 keys a row,
    # the radix kernel past it (2^14), over several tiles (2^16, 2^17).
    for rows, n in [(1, 1), (1, 2), (3, 8), (2, 1024), (2, 8192),
                    (2, 16384), (3, 1 << 16), (3, 1 << 17)]:
        for kind in ("random", "dups", "extremes", "equal"):
            x = rand_int32((rows, n), gen, kind)
            y = bs.bitonic_sort_rows(x)
            same(y, bs.radix_sort_plain(x), f"local sort {rows}x{n} {kind}")
            same(y, torch.sort(x, dim=-1).values,
                 f"local sort ref {rows}x{n} {kind}")
    for n in (2048, 1 << 16):                           # strided rows
        wide = rand_int32((3, n + 300), gen)[:, 100:100 + n]
        same(bs.bitonic_sort_rows(wide), bs.radix_sort_plain(wide),
             f"local sort strided n={n}")
        same(bs.bitonic_sort_rows(wide), torch.sort(wide, dim=-1).values,
             f"local sort strided ref n={n}")
    x = rand_int32((2, 1000), gen, "extremes")          # padded to 1024
    same(bitonic_sort(x), torch.sort(x, dim=-1).values, "ops.sort n=1000")
    # The tile sort: warp registers up to 1024 keys, the bitonic passes past.
    for tile in (1, 2, 8, 256, 1024, 2048, 8192, 16384):
        t = rand_int32((max(1, (1 << 16) // tile), tile), gen, "extremes")
        same(km.merge_tile_grid(t), km.sort_tile_rows(t), f"tile {tile}")
    for v, cap, rcap, tile in [(4, 16, 20, 8), (4, 16, 64, 2),
                               (4, 16, 100, 8), (16, 300, 600, 256),
                               (16, 300, 600, 2048)]:
        b = torch.sort(rand_int32((3, v, cap), gen, "dups"), dim=-1).values
        c = torch.randint(0, cap + 1, (3, v), generator=gen,
                          device=gen.device, dtype=torch.int32)
        m, _, _ = kway_merge(b, c, rcap=rcap, tile=tile, fill=INT_MAX)
        same(m, kway_merge_ref(b, c, rcap=rcap, fill=INT_MAX),
             f"kway_merge v={v} cap={cap} rcap={rcap} tile={tile}")
    # The fused merge's two kernels against their plain versions, on
    # buckets laid out as the merge stage finds them (strided views).
    for k, v, cap, kind, cnts, rcap, tile, S in KWAY_EDGES:
        b, c = kway_inputs(gen, k, v, cap, kind, cnts)
        ranks = km.coarse_ranks(rcap, tile, S, v * cap, gen.device)
        what = f"kway k={k} v={v} cap={cap} {kind} {cnts} rcap={rcap} " \
               f"tile={tile} S={S}"
        starts = km.exact_splitters(b, c, ranks)
        same(starts, km.exact_splitters_plain(b, c, ranks), what + " starts")
        got = km.merge_segments(b, c, starts, rcap=rcap, tile=tile,
                                seg_tiles=S)
        same(got, km.merge_segments_plain(b, c, starts, rcap=rcap, tile=tile,
                                          seg_tiles=S), what)
        same(got, kway_merge_ref(b, c, rcap=rcap, fill=INT_MAX),
             what + " == kway_merge_ref")
    for v, ww in [(1, 1), (3, 100), (4, 129), (16, 1000)]:
        src = rand_int32((v, v * ww + 7), gen)
        cnt = torch.randint(-2, ww + 3, (v, v + 2), generator=gen,
                            device=gen.device, dtype=torch.int32)
        cnt[0, 0], cnt[-1, 1 % v] = 0, ww
        for fill in (None, INT_MAX, -5):
            for payload in (False, True):
                outs = []
                for fn in (dv.deliver_words, dv.deliver_words_plain):
                    dst = torch.zeros((v, v * ww + 11), dtype=torch.int32,
                                      device=gen.device)
                    ct = torch.zeros((v, v + 3), dtype=torch.int32,
                                     device=gen.device)
                    fn(src, 7, dst, 11 - 11 % 2, v, ww,
                       None if fill is None else cnt, 2, fill,
                       cnt if payload else None, 1, ct if payload else None,
                       3)
                    outs += [dst, ct]
                what = f"deliver v={v} ww={ww} fill={fill} ct={payload}"
                same(outs[0], outs[2], what)
                same(outs[1], outs[3], what + " counts")
    for m, P, nq, s0, s, c0, d, ww in ASSEMBLE_EDGES:
        v = m * P
        src = rand_int32((v, 9 + v * ww), gen)
        cnt = torch.randint(-2, ww + 3, (v, v + 4), generator=gen,
                            device=gen.device, dtype=torch.int32)
        # Counts of 0, of ω, past ω and negative.
        cnt[0, 4:8] = torch.tensor([0, ww, ww + 5, -3],
                                   device=gen.device)[:v]
        for fill in (None, -7, INT_MAX):
            for payload in (False, True):
                outs = []
                for fn in (dv.assemble_words, dv.assemble_words_plain):
                    out = torch.zeros(nq * P * d * s * ww, dtype=torch.int32,
                                      device=gen.device)
                    ct = torch.zeros(nq * P * d * s, dtype=torch.int32,
                                     device=gen.device)
                    fn(src, 9, m, P, nq, s0, s, c0, d, ww, out,
                       None if fill is None else cnt, 4, fill,
                       cnt if payload else None, 4, ct if payload else None)
                    outs += [out, ct]
                what = (f"assemble m={m} P={P} nq={nq} s0={s0} s={s} "
                        f"c0={c0} d={d} ww={ww} fill={fill} ct={payload}")
                same(outs[0], outs[2], what)
                same(outs[1], outs[3], what + " counts")
    # Both destination layouts at every phase: a buffer that starts off a
    # 16-byte boundary, and the recv rows of the store the chunk reads.
    for m, P, nq, s0, s, c0, d, ww in ASSEMBLE_EDGES:
        v = m * P
        for ps, pr in ASSEMBLE_PHASES:
            off_s = 4 + ps
            off_r = off_s + v * ww + (pr - ps - v * ww) % 4 + 4
            off_c = off_r + v * ww
            W = off_c + 2 * v + 1
            W += (2 - W) % 4
            store = rand_int32((v, W), gen)
            cnt = torch.randint(-2, ww + 3, (v, v), generator=gen,
                                device=gen.device, dtype=torch.int32)
            cnt.view(-1)[:4] = torch.tensor([0, ww, ww + 5, -3],
                                            device=gen.device)[:v * v]
            store[:, off_c:off_c + v] = cnt
            for fill in (None, -7, INT_MAX):
                for payload in (False, True):
                    for layout in ("buffer", "rows"):
                        outs = []
                        for fn in (dv.assemble_words,
                                   dv.assemble_words_plain):
                            st = store.clone()
                            if layout == "rows":
                                rows = st[:, off_r:off_r + v * ww].view(
                                    P, m, P, m, ww)
                                rc = st[:, off_c + v:off_c + 2 * v].view(
                                    P, m, P, m)
                                out = rows[:, c0:c0 + d, :nq, s0:s0 + s]
                                out = out.permute(2, 0, 1, 3, 4)
                                ct = rc[:, c0:c0 + d, :nq, s0:s0 + s]
                                ct = ct.permute(2, 0, 1, 3)
                            else:
                                n = nq * P * d * s
                                out = torch.zeros(pr + n * ww,
                                                  dtype=torch.int32,
                                                  device=gen.device)[pr:]
                                ct = torch.zeros(n, dtype=torch.int32,
                                                 device=gen.device)
                            fn(st, off_s, m, P, nq, s0, s, c0, d, ww, out,
                               None if fill is None else st, off_c, fill,
                               st if payload else None, off_c,
                               ct if payload else None)
                            outs.append((st, out, ct))
                        what = (f"assemble {layout} m={m} P={P} nq={nq} "
                                f"s0={s0} s={s} c0={c0} d={d} ww={ww} "
                                f"phases={ps},{pr} fill={fill} ct={payload}")
                        for a, b, part in zip(outs[0], outs[1],
                                              ("store", "out", "counts")):
                            same(a, b, f"{what} {part}")
    # The array form, float32 payload and counts payload, a float fill.
    from repro_torch.kernels.alltoallv_deliver.ref import assemble_proc_ref
    msgs = torch.randn((2, 4, 3, 300), generator=gen, device=gen.device)
    cnt = torch.randint(-2, 303, (2, 4, 3), generator=gen, device=gen.device,
                        dtype=torch.int32)
    got = dv.assemble_proc_tiles(msgs, cnt, cnt.float(), fill=-1.5)
    want = assemble_proc_ref(msgs, cnt, cnt.float(), fill=-1.5)
    for g, w in zip(got, want):
        same(g.view(torch.int32), w.view(torch.int32), "assemble float32")


def merge_rows(km, recv, cnt, rcap: int, tile: int, launches, reps,
               fill=INT_MAX) -> list:
    """Kernel 3's fused merge on the main path's received buckets (round 0,
    ``recv [k, v, cap]`` and ``cnt [k, v]`` as the store holds them): the
    splitters and the segment merge, each held exactly against its plain
    version and timed beside it, with its bound.  The segments' library
    call is one ``torch.sort`` of the count-masked ``[k, v·cap]`` rows, as
    ``kway_merge_ref`` does (the mask made outside the timed call; uint32
    buckets as their int32 images ``x ^ 2^31``, ``fill`` their maximum)."""
    from repro_torch.kernels.kway_merge import kway_merge
    k, v, cap = recv.shape
    dtype = str(recv.dtype).replace("torch.", "")
    S = km.segment_tiles(v, tile)
    ranks = km.coarse_ranks(rcap, tile, S, v * cap, recv.device)
    R = ranks.numel()
    starts = km.exact_splitters(recv, cnt, ranks)
    err = same(starts, km.exact_splitters_plain(recv, cnt, ranks),
               "splitters main path")
    # A search reads about log2(cap + 1) keys of a bucket for each rank and
    # writes the starts.
    probes = k * R * v * math.ceil(math.log2(cap + 1))
    b_ms, b_by = bound(4 * (probes + k * v + k * R * v) + 8 * R, probes)
    rows = [dict(
        name="kway_splitters", route="cuda",
        source="src/repro_torch/csrc/kway_merge.cu",
        replaces="src/repro/kernels/kway_merge/kway_merge.py:65",
        launches=launches["kway_splitters"], max_abs_err=err,
        ms=cuda_ms(lambda: km.exact_splitters(recv, cnt, ranks), reps),
        plain_ms=cuda_ms(lambda: km.exact_splitters_plain(recv, cnt, ranks),
                         2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"[{k}, {v}, {cap}] {dtype} buckets, strides {recv.stride()}, "
              f"{R} coarse ranks (S {S})")]

    def segments():
        return km.merge_segments(recv, cnt, starts, rcap=rcap, tile=tile,
                                 seg_tiles=S)

    got = segments()
    err = same_bits(got, km.merge_segments_plain(recv, cnt, starts,
                                                 rcap=rcap, tile=tile,
                                                 seg_tiles=S),
                    "segments main path")
    masked = km.mask_buckets(km.biased(recv), cnt).reshape(k, v * cap)
    same(km.biased(got), torch.sort(masked, dim=-1).values[:, :rcap],
         "fused merge main path == torch.sort of the masked rows")
    # Reads the valid keys of rank below rcap, writes k·rcap keys;
    # n·log2(v) comparisons merge them.
    valid = int(torch.clamp(cnt.to(torch.int64), 0, cap).sum(dim=1)
                .clamp(max=rcap).sum())
    b_ms, b_by = bound(4 * (valid + k * rcap + starts.numel() + k * v),
                       valid * math.log2(max(v, 2)))
    rows.append(dict(
        name="kway_merge_segments", route="cuda",
        source="src/repro_torch/csrc/kway_merge.cu",
        replaces="src/repro/kernels/kway_merge/kway_merge.py:65",
        launches=launches["kway_merge_segments"], max_abs_err=err,
        ms=cuda_ms(segments, reps),
        plain_ms=cuda_ms(lambda: km.merge_segments_plain(
            recv, cnt, starts, rcap=rcap, tile=tile, seg_tiles=S), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.sort(masked, dim=-1), reps),
        shape=f"[{k}, {v}, {cap}] {dtype} buckets, {valid} valid keys below "
              f"rcap, merged [{k}, {rcap}], tile {tile}, S {S}"))
    del masked, got
    whole = cuda_ms(lambda: kway_merge(recv, cnt, rcap=rcap, tile=tile,
                                       fill=fill), reps)
    print(f"kway_merge of round 0, {dtype} (both launches and the totals): "
          f"{whole:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
    return rows


# ---------------------------------------------------------------------------
# Kernels 1, 3, 6 and 7 in every dtype their JAX counterparts take.
# ---------------------------------------------------------------------------

# The sort's key dtypes with the signed view of each one's width.
SORT_DTYPES = {torch.bool: torch.int8, torch.int8: torch.int8,
               torch.uint8: torch.int8, torch.int16: torch.int16,
               torch.uint16: torch.int16, torch.int32: torch.int32,
               torch.uint32: torch.int32, torch.float16: torch.int16,
               torch.bfloat16: torch.int16, torch.float32: torch.int32}
U32_MAX = 2**32 - 1
NARROW_EPS = {torch.bfloat16: 2**-7, torch.float16: 2**-10}
# The scans' small ragged shapes in narrow dtypes: SSD (b, h, s, p, n) and
# LRU (b, s, d), both LRU paths (the last at ONE_PASS_CHANNELS and past).
SSD_NARROW_EDGES = [(1, 1, 1, 16, 16), (2, 3, 37, 16, 16), (1, 2, 50, 32, 32),
                    (1, 2, 65, 64, 128), (1, 2, 129, 64, 128)]
LRU_NARROW_EDGES = [(1, 1, 1), (2, 37, 64), (2, 33, 100), (3, 17, 2560),
                    (8, 33, 2560)]


def dtype_keys(shape, gen, dtype, kind="special"):
    """Keys of ``dtype`` on the generator's device: random values with
    (floats) ±0, NaNs of both signs and several payloads, ±inf, subnormals
    and the largest finite value, or (integers) the type's extremes, at a
    third of the places; ``equal``: one value repeated."""
    dev = gen.device
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=gen, device=dev).bool()
    view = SORT_DTYPES[dtype]
    width = view.itemsize * 8
    if kind == "equal":
        return torch.full(shape, 3, dtype=view, device=dev).view(dtype) \
            if not dtype.is_floating_point else \
            torch.full(shape, -0.5, dtype=dtype, device=dev)
    if dtype.is_floating_point:
        x = (torch.randn(shape, generator=gen, device=dev) * 4).to(dtype)
        sign = -2**(width - 1)
        inf = {torch.float32: 0x7F800000, torch.float16: 0x7C00,
               torch.bfloat16: 0x7F80}[dtype]
        special = [0, sign, inf, sign | inf, inf | 1, inf | (inf >> 1),
                   sign | inf | 5, sign | inf | (inf >> 1), 1, sign | 3,
                   inf - 1]
    else:
        info = torch.iinfo(dtype)
        x = torch.randint(-2**(width - 1), 2**(width - 1), shape,
                          generator=gen, device=dev,
                          dtype=torch.int64).to(view).view(dtype)
        special = [v - (1 << width) if v >= 1 << (width - 1) else v
                   for v in (info.min, info.min + 1, 0, 1, info.max - 1,
                             info.max)]
    pool = torch.tensor(special, dtype=torch.int64, device=dev).to(view)
    pick = pool[torch.randint(0, len(special), shape, generator=gen,
                              device=dev)]
    at = torch.rand(shape, generator=gen, device=dev) < 1 / 3
    return torch.where(at, pick, x.view(view)).view(dtype)


def key_bits(x):
    return x.view(torch.int8) if x.dtype == torch.bool else \
        x.view(SORT_DTYPES[x.dtype])


def stable_sort(x):
    """``torch.sort(stable=True)`` of the keys on the CPU, whose order is
    ``jnp.sort``'s (NaNs tie after +inf, ±0 tie): the card's ``torch.sort``
    (2.11) puts negative NaNs first and orders NaN payloads by their bits,
    so it is the yardstick of time only (on NaN-free keys)."""
    return torch.sort(x.cpu(), dim=-1, stable=True).values.to(x.device)


def same_bits(a, b, what: str) -> int:
    return same(key_bits(a), key_bits(b), what)


def narrow_close(got, want, dtype, tol: float, what: str) -> float:
    """``got`` in ``dtype`` within one of its ulps of ``want`` (fp32) rounded,
    plus ``tol`` (1 + |want|) for the fp32 sums' order: eps |want| + tol (1 +
    |want|)."""
    torch.cuda.synchronize()
    check(got.dtype == dtype and got.shape == want.shape,
          f"{what}: {got.dtype} {tuple(got.shape)}")
    want = want.float()
    diff = (got.float() - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ok = bool((diff <= NARROW_EPS[dtype] * want.abs()
               + tol * (1 + want.abs())).all())
    check(ok and math.isfinite(err), f"{what}: max |kernel - plain| = {err}")
    return err


def u32_buckets(b, cnt):
    """int32 buckets' bits as uint32 buckets in place (the layout kept), each
    valid prefix sorted in uint32 order: keys at and past 2^31 last."""
    img = b.view(torch.int32) ^ INT_MIN
    valid = torch.arange(b.shape[-1], device=b.device) < cnt[..., None]
    srt = torch.sort(torch.where(valid, img, INT_MAX), dim=-1).values
    b.copy_(torch.where(valid, srt ^ INT_MIN, b))
    return b.view(torch.uint32)


# Kernels 2 and 4 on 1- and 2-byte payloads: the dtypes and message widths
# ω (1 and 3 elements: ragged rows, byte or halfword addressing; 130 and
# 257: several vectors, a ragged tail).
NARROW_PAYLOADS = (torch.bool, torch.int8, torch.uint8, torch.int16,
                   torch.uint16, torch.float16, torch.bfloat16)
NARROW_OMEGAS = (1, 3, 130, 257)
# Kernel 5 in fp16 beyond the bf16 edge tables, at every head dim the kernel
# is built for, (b, sq, sk, hq, hkv): a prefill at a q_offset and a decode
# call whose keys the launch plan splits, each over K and V as strided views
# of one [B, S, 2, Hkv, d] cache.
F16_CACHE_EDGES = [(2, 70, 150, 12, 2), (8, 1, 300, 12, 2)]


def narrow_fills(dtype):
    """None, a value and the type's extremes (floats: -inf and NaN too)."""
    if dtype == torch.bool:
        return [None, True, False]
    if dtype.is_floating_point:
        fi = torch.finfo(dtype)
        return [None, -1.5, fi.min, fi.max, -math.inf, math.nan]
    ii = torch.iinfo(dtype)
    return [None, 5, ii.min, ii.max]


def narrow_payload(shape, dtype, gen):
    """Random bits of ``dtype`` (bool: 0 or 1) on the generator's device."""
    dev = gen.device
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=gen, device=dev).bool()
    view = SORT_DTYPES[dtype]
    width = 8 * view.itemsize
    return torch.randint(-2**(width - 1), 2**(width - 1), shape,
                         generator=gen, device=dev,
                         dtype=torch.int32).to(view).view(dtype)


def narrow_delivery_checks(gen, dv) -> int:
    """Kernels 2 and 4 (``deliver_tiles``, ``assemble_proc_tiles``) on every
    1- and 2-byte payload at ``NARROW_OMEGAS``: counts of 0, of ω, past ω
    and negative; each fill of :func:`narrow_fills`, in turn without a
    counts payload, with one of the payload's dtype and with one of the
    other width; the bits exactly the plain version's (the CPU path), one
    launch a call.  Returns the number of calls."""
    n = 0
    for dtype, omega in itertools.product(NARROW_PAYLOADS, NARROW_OMEGAS):
        other = torch.int8 if dtype.itemsize == 2 else torch.int16
        for shape, fn, counter in (((4, 4), dv.deliver_tiles, "LAUNCHES"),
                                   ((3, 2, 2), dv.assemble_proc_tiles,
                                    "ASSEMBLE_LAUNCHES")):
            msgs = narrow_payload((*shape, omega), dtype, gen)
            cnt = torch.randint(-2, omega + 3, shape, generator=gen,
                                device=gen.device, dtype=torch.int32)
            cnt.view(-1)[:4] = torch.tensor([0, omega, omega + 5, -3],
                                            device=gen.device)
            for i, fill in enumerate(narrow_fills(dtype)):
                cp = (None, narrow_payload(shape, dtype, gen),
                      narrow_payload(shape, other, gen))[i % 3]
                what = (f"{fn.__name__} {dtype} ω={omega} fill={fill} "
                        f"ct={None if cp is None else cp.dtype}")
                before = getattr(dv, counter)
                got = fn(msgs, cnt, cp, fill=fill)
                check(getattr(dv, counter) == before + 1,
                      f"{what}: one launch")
                want = fn(msgs.cpu(), cnt.cpu(),
                          None if cp is None else cp.cpu(), fill=fill)
                check(got[0].dtype == dtype, f"{what}: dtype")
                same_bits(got[0], want[0].to(got[0].device), what)
                if cp is not None:
                    check(got[1].dtype == cp.dtype, f"{what}: ct dtype")
                    same_bits(got[1], want[1].to(got[1].device),
                              what + " counts")
                n += 1
    return n


def fp16_flash_edge_checks(gen, fa) -> tuple:
    """Kernel 5 in fp16 at the bf16 edge tables (``flash_edge_checks``) and
    at ``F16_CACHE_EDGES`` for every head dim, within one fp16 ulp of the
    plain version; kernel 5 with lse and kernel 5b in fp16 at
    ``BWD_EDGES`` for output gradients of unit scale and of 2^-16, two runs
    of 5b bit-equal.  Returns the numbers of forward and backward calls."""
    n = flash_edge_checks(gen, fa, torch.float16, F16_RTOL, F16_ATOL)
    for d, (b, sq, sk, hq, hkv) in itertools.product(fa.HEAD_DIMS,
                                                     F16_CACHE_EDGES):
        q = torch.randn((b, sq, hq, d), generator=gen,
                        device=gen.device).half()
        cache = torch.randn((b, sk + 24, 2, hkv, d), generator=gen,
                            device=gen.device).half()
        k, v = cache[:, :sk, 0], cache[:, :sk, 1]
        off = sk - 8 if sq == 1 else sk - sq - 10
        kw = dict(causal=True, sk_valid=off + sq, q_offset=off)
        if sq == 1:
            splits = fa._plan(fa._sms(q.device), q.dtype, b,
                              sq * (hq // hkv), hkv, d, sk=sk,
                              sk_valid=off + 1, q_offset=off)[2]
            check(splits > 1, f"fp16 decode d={d}: the plan splits the keys")
        close(fa.attend(q, k, v, **kw), fa.attend_plain(q, k, v, **kw),
              F16_RTOL, F16_ATOL, f"flash fp16 strided cache d={d} {kw}")
        n += 1
    m = bwd_edge_checks(gen, fa, (torch.float16,), (1.0, 2**-16))
    return n, m


def dtype_edge_checks(gen, kern) -> None:
    bs, km = kern["bitonic"], kern["kway"]
    from repro_torch.kernels.bitonic_sort import bitonic_sort
    from repro_torch.kernels.kway_merge import kway_merge, kway_merge_ref
    ss = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
    ls = importlib.import_module("repro_torch.kernels.lru_scan.lru_scan")
    n_sorts = 0
    for dtype in SORT_DTYPES:
        for rows, n in [(1, 1), (1, 2), (3, 8), (2, 1024), (2, 8192),
                        (2, 16384), (3, 1 << 17)]:
            for kind in ("special", "equal") if n in (8, 16384) else \
                    ("special",):
                x = dtype_keys((rows, n), gen, dtype, kind)
                y = bs.bitonic_sort_rows(x)
                what = f"sort {dtype} {rows}x{n} {kind}"
                same_bits(y, bs.radix_sort_plain(x), what)
                same_bits(y, stable_sort(x), what + " == torch.sort")
                n_sorts += 1
        wide = dtype_keys((3, (1 << 16) + 300), gen, dtype)
        for n in (2048, 1 << 16):                         # strided rows
            v = wide[:, 100:100 + n]
            same_bits(bs.bitonic_sort_rows(v), stable_sort(v),
                      f"sort {dtype} strided n={n}")
        for n in (1000, 20000):                          # padded rows
            same_bits(bitonic_sort(wide[:, :n]), stable_sort(wide[:, :n]),
                      f"ops.sort {dtype} n={n}")
    for tile in (8, 1024, 2048):
        t = dtype_keys(((1 << 16) // tile, tile), gen, torch.uint32)
        same_bits(km.merge_tile_grid(t), km.sort_tile_rows(t),
                  f"tile {tile} uint32")
    for k, v, cap, kind, cnts, rcap, tile, S in KWAY_EDGES:
        b, c = kway_inputs(gen, k, v, cap, kind, cnts)
        b = u32_buckets(b, c)
        ranks = km.coarse_ranks(rcap, tile, S, v * cap, gen.device)
        what = f"kway uint32 k={k} v={v} cap={cap} {kind} {cnts} " \
               f"rcap={rcap} tile={tile} S={S}"
        starts = km.exact_splitters(b, c, ranks)
        same(starts, km.exact_splitters_plain(b, c, ranks), what + " starts")
        got = km.merge_segments(b, c, starts, rcap=rcap, tile=tile,
                                seg_tiles=S)
        check(got.dtype == torch.uint32, what + " dtype")
        same_bits(got, km.merge_segments_plain(b, c, starts, rcap=rcap,
                                               tile=tile, seg_tiles=S), what)
        same_bits(got, kway_merge_ref(b, c, rcap=rcap, fill=U32_MAX),
                  what + " == kway_merge_ref")
        same_bits(kway_merge(b, c, rcap=rcap, tile=tile, fill=U32_MAX)[0],
                  got, what + " kway_merge")
    for dtype in NARROW_EPS:
        for shape in SSD_NARROW_EDGES:
            args = [t.to(dtype) for t in ssd_inputs(gen, *shape)]
            y, s_fin = ss.ssd_scan_chunked(*args)
            y_p, s_p = ss.ssd_chunked_plain(*args, 128)
            narrow_close(y, y_p, dtype, SSD_TOL, f"ssd {dtype} y {shape}")
            close(s_fin, s_p, SSD_TOL, SSD_TOL, f"ssd {dtype} S_fin {shape}")
        for shape in LRU_NARROW_EDGES:
            a, x = (t.to(dtype) for t in lru_inputs(gen, *shape))
            h, h_fin = ls.lru_scan_chunked(a, x)
            h_p, fin_p = ls.lru_chunked_plain(a, x, 256)
            narrow_close(h, h_p, dtype, LRU_TOL, f"lru {dtype} h {shape}")
            close(h_fin, fin_p, LRU_TOL, LRU_TOL,
                  f"lru {dtype} h_fin {shape}")
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    n_fwd, n_bwd = fp16_flash_edge_checks(gen, fa)
    n_del = narrow_delivery_checks(gen, kern["deliver"])
    print(f"dtype edge checks: {n_sorts} sorts in {len(SORT_DTYPES)} dtypes, "
          f"{len(KWAY_EDGES)} uint32 merges, "
          f"{2 * (len(SSD_NARROW_EDGES) + len(LRU_NARROW_EDGES))} narrow "
          f"scans, {n_fwd} fp16 flash calls and {n_bwd} fp16 5b calls, "
          f"{n_del} narrow deliveries and stagings")


def sort_rows_float(gen, bs, k: int, n_v: int, reps: int) -> list:
    """Kernel 1 on float32 and bfloat16 keys at the local sort's shape,
    ``[k, n_v]`` strided rows (a context's row stride apart), driven through
    ``ops.sort`` with the count reset just before: rows ``radix_sort_f32``
    and ``radix_sort_bf16``."""
    from repro_torch.kernels.bitonic_sort import bitonic_sort
    rows = []
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        wide = torch.randn((k, n_v + 1024), generator=gen,
                           device=gen.device).to(dtype)
        x = wide[:, 512:512 + n_v]
        bs.LAUNCHES = 0
        got = bitonic_sort(x)
        launches = bs.LAUNCHES
        check(launches > 0, f"ops.sort {dtype} launched kernel 1")
        err = max(same_bits(got, bs.radix_sort_plain(x), f"radix {dtype}"),
                  same_bits(got, stable_sort(x), f"radix {dtype} torch.sort"))
        del got
        # Reads and writes each key once; log2(n!) comparisons a row, at
        # the fp32 rate (the keys' type outside the tensor cores).
        b_ms, b_by = bound(2 * x.element_size() * x.numel(),
                           sort_ops(k, n_v), FP32_FLOPS_PER_S)
        rows.append(dict(
            name=f"radix_sort_{tag}", route="cuda",
            source="src/repro_torch/csrc/radix_sort.cu",
            replaces="src/repro/kernels/bitonic_sort/bitonic_sort.py:44",
            launches=launches, max_abs_err=err,
            ms=cuda_ms(lambda: bs.bitonic_sort_rows(x), reps),
            plain_ms=cuda_ms(lambda: bs.radix_sort_plain(x), 2),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: torch.sort(x, dim=-1, stable=True),
                               reps),
            shape=f"[{k}, {n_v}] {str(dtype)[6:]}, row stride {x.stride(0)}"))
        del wide, x
    return rows


def merge_rows_u32(km, recv, cnt, rcap: int, tile: int, reps) -> list:
    """Kernel 3's splitters and segment merge on uint32 buckets of round 0's
    shape: the main path's received buckets' images ``x ^ 2^31`` (their
    order kept, half the keys at or past 2^31), driven through
    ``kway_merge`` with the counts reset just before, each held against its
    plain version and timed beside it: rows ``kway_splitters_u32`` and
    ``kway_merge_segments_u32``."""
    from repro_torch.kernels.kway_merge import kway_merge
    k, v, cap = recv.shape
    b = (recv.view(torch.int32) ^ INT_MIN).view(torch.uint32)
    km.SPLIT_LAUNCHES = km.SEGMENT_LAUNCHES = 0
    merged, _, _ = kway_merge(b, cnt, rcap=rcap, tile=tile, fill=U32_MAX)
    launches = {"kway_splitters": km.SPLIT_LAUNCHES,
                "kway_merge_segments": km.SEGMENT_LAUNCHES}
    check(all(launches.values()) and merged.dtype == torch.uint32,
          f"kway_merge uint32 launched its kernels: {launches}")
    del merged
    rows = merge_rows(km, b, cnt, rcap, tile, launches, reps, fill=U32_MAX)
    for r in rows:
        r["name"] += "_u32"
        r["shape"] += " (round 0's int32 buckets' images x ^ 2^31)"
    return rows


def narrow_delivery_rows(gen, dv, reps: int) -> list:
    """Kernels 2 and 4 on narrow payloads at the bytes of rows 2r and 4,
    each driven alone through its entry point (``deliver_fused``,
    ``assemble_proc_fused``) with its count reset just before, held against
    its plain version bit for bit and timed beside it, its bound and the one
    PyTorch call that computes the same function: rows ``deliver_tiles_bf16``
    (2h: ``[16, 16, 2^22]`` bf16, no fill, the int32 counts transposed, as
    list ranking's exchange is), ``deliver_tiles_i8`` (2b: ``[16, 16,
    2^23]`` int8) and ``assemble_proc_tiles_bf16`` (4h: a chunk ``[s 8, P
    4, d 1, 2^24]`` bf16, 32 messages as row 4's, about a sixteenth of each
    valid, the rest filled, the counts transposed)."""
    from repro_torch.kernels.alltoallv_deliver import (assemble_proc_fused,
                                                       deliver_fused)
    rows, v, dev = [], 16, gen.device
    for dtype, omega, tag, row in ((torch.bfloat16, 1 << 22, "bf16", "2h"),
                                   (torch.int8, 1 << 23, "i8", "2b")):
        msgs = narrow_payload((v, v, omega), dtype, gen)
        cp = torch.randint(0, omega + 1, (v, v), generator=gen, device=dev,
                           dtype=torch.int32)
        dv.LAUNCHES = 0
        out, ct = deliver_fused(msgs, None, cp)
        launches = dv.LAUNCHES
        check(launches == 1, f"deliver_fused {dtype} launched kernel 2")
        elems = msgs.view(SORT_DTYPES[dtype]).reshape(v, v * omega)
        plain_out, plain_ct = torch.empty_like(elems), torch.empty_like(cp)

        def plain():
            dv.deliver_words_plain(elems, 0, plain_out, 0, v, omega, None, 0,
                                   None, cp, 0, plain_ct, 0)

        plain()
        err = max(same_bits(out, plain_out.view(dtype).reshape(out.shape),
                            f"row {row}"),
                  same(ct, plain_ct, f"row {row} counts"))
        del out, ct
        b_ms, b_by = bound(2 * msgs.numel() * msgs.element_size()
                           + 2 * 4 * cp.numel())
        rows.append(dict(
            name=f"deliver_tiles_{tag}", route="cuda",
            source="src/repro_torch/csrc/alltoallv_deliver.cu",
            replaces="src/repro/kernels/alltoallv_deliver/"
                     "alltoallv_deliver.py:79",
            launches=launches, max_abs_err=err,
            ms=cuda_ms(lambda: deliver_fused(msgs, None, cp), reps),
            plain_ms=cuda_ms(plain, 2),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: msgs.transpose(0, 1).contiguous(),
                               reps),
            shape=f"row {row}: [{v}, {v}, {omega}] {tag}, the int32 counts "
                  "transposed, no fill (whole lanes)"))
        del msgs, elems, plain_out, plain_ct
        torch.cuda.empty_cache()
    s, pn, d, omega, dtype = 8, 4, 1, 1 << 24, torch.bfloat16
    msgs = narrow_payload((s, pn, d, omega), dtype, gen)
    cnt = torch.randint(omega // 16 - 4096, omega // 16 + 4096, (s, pn, d),
                        generator=gen, device=dev, dtype=torch.int32)
    fill = float(torch.finfo(dtype).max)
    dv.ASSEMBLE_LAUNCHES = 0
    out, ct = assemble_proc_fused(msgs, cnt, cnt, fill=fill)
    launches = dv.ASSEMBLE_LAUNCHES
    check(launches == 1, "assemble_proc_fused bf16 launched kernel 4")
    elems = msgs.view(torch.int16).reshape(s, pn * d * omega)
    fill_bits = int(torch.tensor(fill, dtype=dtype).view(torch.int16))
    plain_out = torch.empty((pn, d, s, omega), dtype=torch.int16, device=dev)
    plain_ct = torch.empty((pn, d, s), dtype=torch.int32, device=dev)
    flat = cnt.reshape(s, pn * d)

    def plain():
        dv.assemble_words_plain(elems, 0, d, pn, 1, 0, s, 0, d, omega,
                                plain_out, flat, 0, fill_bits, flat, 0,
                                plain_ct)

    plain()
    err = max(same_bits(out, plain_out.view(dtype), "row 4h"),
              same(ct, plain_ct, "row 4h counts"))
    del out, ct
    lane = torch.arange(omega, device=dev)
    fill_t = torch.tensor(fill, dtype=dtype, device=dev)
    cnt_t = cnt.permute(1, 2, 0)[..., None]
    staged = msgs.permute(1, 2, 0, 3)
    nmsg = s * pn * d
    valid = int(cnt.clamp(0, omega).sum())
    b_ms, b_by = bound(2 * (valid + nmsg * omega) + 4 * 3 * nmsg)
    rows.append(dict(
        name="assemble_proc_tiles_bf16", route="cuda",
        source="src/repro_torch/csrc/alltoallv_deliver.cu",
        replaces="src/repro/kernels/alltoallv_deliver/"
                 "alltoallv_deliver.py:163",
        launches=launches, max_abs_err=err,
        ms=cuda_ms(lambda: assemble_proc_fused(msgs, cnt, cnt, fill=fill),
                   reps),
        plain_ms=cuda_ms(plain, 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.where(lane < cnt_t, staged, fill_t),
                           reps),
        shape=f"row 4h: [s={s}, P={pn}, d={d}, {omega}] bf16, {valid} "
              "valid, the rest the fill, the int32 counts transposed"))
    del msgs, elems, plain_out, staged
    torch.cuda.empty_cache()
    return rows


def run_dtypes(dev, args) -> list:
    """``--dtypes-only``: the dtype edge checks and the dtype rows, the
    merge rows on synthesized buckets of round 0's shape ([k, v, n/v]
    sorted random keys, counts about n/v²)."""
    kern = kernel_modules()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    dtype_edge_checks(gen, kern)
    print(f"dtype edge checks: passed in {time.perf_counter() - t0:.2f} s")
    n, v, k = 1 << args.log_n, args.v, args.k
    n_v = n // v
    rows = sort_rows_float(gen, kern["bitonic"], k, n_v, args.reps)
    recv = torch.sort(rand_int32((k, v, n_v), gen), dim=-1).values
    cnt = torch.randint(n_v // v - 4096, n_v // v + 4096, (k, v),
                        generator=gen, device=dev, dtype=torch.int32)
    rows += merge_rows_u32(kern["kway"], recv, cnt, 2 * n_v, 256, args.reps)
    del recv
    rows += narrow_delivery_rows(gen, kern["deliver"], args.reps)
    rows += lm_dtype_rows(gen, args)
    print_rows(rows)
    return [{key: r[key] for key in r if key != "shape"} for r in rows]


def lm_dtype_rows(gen, args) -> list:
    """Kernels 6 and 7 in bf16 at the serve path's shapes (mamba2-130m's x
    [8, 24, 1024, 64], recurrentgemma-2b's [8, 3072, 2560]), each driven
    through its entry point (``ops.ssd_scan``, ``ops.lru_scan``) with the
    count reset just before, held against its plain version within one
    bf16 ulp (plus the fp32 checks' tolerance) and timed beside it: rows
    ``ssd_scan_bf16`` and ``lru_scan_bf16``; then kernels 5 and 5b in
    float16 (:func:`fp16_lm_rows`)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.lru_scan.ops import lru_scan
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    ss = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
    ls = importlib.import_module("repro_torch.kernels.lru_scan.lru_scan")
    reps, bf = args.reps, torch.bfloat16
    mamba, rg = get_config("mamba2-130m"), get_config("recurrentgemma-2b")
    b, s = REQUESTS, PROMPT_LEN
    h, p, n = mamba.ssm_heads, mamba.ssm_headdim, mamba.ssm_state
    ops = [t.to(bf) for t in ssd_inputs(gen, b, h, s, p, n)]
    ss.LAUNCHES = 0
    y = ssd_scan(*ops)
    launches = ss.LAUNCHES
    check(launches > 0 and y.dtype == bf, "ops.ssd_scan bf16 on kernel 6")
    err = narrow_close(y, ss.ssd_chunked_plain(*ops, 128)[0], bf, SSD_TOL,
                       "ssd bf16 serve shape")
    x, dt, A, B, C = ops
    nbytes = 2 * (2 * x.numel() + dt.numel() + A.numel() + B.numel()
                  + C.numel()) + 4 * b * h * n * p
    # The recurrence's 4 N P operations a step and head, on bf16 operands:
    # the bf16 tensor-core rate.
    b_ms, b_by = bound(nbytes, 4 * n * p * b * h * s, BF16_FLOPS_PER_S)
    rows = [dict(
        name="ssd_scan_bf16", route="cuda",
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:78",
        launches=launches, max_abs_err=err,
        ms=cuda_ms(lambda: ss.ssd_scan_chunked(*ops), reps),
        plain_ms=cuda_ms(lambda: ss.ssd_chunked_plain(*ops, 128), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"x [{b}, {h}, {s}, {p}], dt, A, B/C [{b}, {s}, {n}] bf16, "
              f"y bf16, S_fin fp32")]
    del y, ops, x, dt, A, B, C
    s, width = HYBRID_PROMPT_LEN, rg.lru_width
    a, x = (t.to(bf) for t in lru_inputs(gen, b, s, width))
    ls.LAUNCHES = 0
    hh = lru_scan(a, x)
    launches = ls.LAUNCHES
    check(launches > 0 and hh.dtype == bf, "ops.lru_scan bf16 on kernel 7")
    err = narrow_close(hh, ls.lru_chunked_plain(a, x, 256)[0], bf, LRU_TOL,
                       "lru bf16 serve shape")
    del hh
    b_ms, b_by = bound(2 * 3 * a.numel() + 4 * b * width, 2 * a.numel(),
                       FP32_FLOPS_PER_S)
    rows.append(dict(
        name="lru_scan_bf16", route="cuda",
        source="src/repro_torch/csrc/lru_scan.cu",
        replaces="src/repro/kernels/lru_scan/lru_scan.py:57",
        launches=launches, max_abs_err=err,
        ms=cuda_ms(lambda: ls.lru_scan_chunked(a, x), reps),
        plain_ms=cuda_ms(lambda: ls.lru_chunked_plain(a, x, 256), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"a, b [{b}, {s}, {width}] bf16, h bf16, h_fin fp32"))
    del a, x
    return rows + fp16_lm_rows(gen, args)


# The float16 qwen2-1.5b run: its first layers at full width (the whole
# script's 1200 s leave it no more), and its training steps of 8 x 1024
# tokens.
F16_QWEN_DEPTH = 8
F16_QWEN_RUN = dict(steps=2, seq=1024, batch=8, microbatches=1)


def fp16_lm_rows(gen, args) -> list:
    """Kernels 5 and 5b in float16.  Rows ``flash_attention_f16`` (5h,
    qwen2's prefill shape) and ``flash_attention_window_f16`` (5wh,
    recurrentgemma's windowed prefill at head dim 256), each driven alone
    through ``attend`` with the count reset just before.  Then qwen2-1.5b
    with ``dtype="float16"`` (``dataclasses.replace`` of its config, as the
    JAX package allows) at full width, cut to its first ``F16_QWEN_DEPTH``
    layers: served through ``Model`` and ``ServeEngine.generate`` (``REQUESTS`` prompts of ``PROMPT_LEN``,
    ``GEN_LEN`` tokens; kernel 5's count reset just before, above zero
    after) and trained ``F16_QWEN_RUN`` steps through ``make_train_step``
    (each step's kernel-5 and 5b counts reset just before and equal to
    ``step_launches`` after, its loss and gnorm finite); row
    ``flash_attention_bwd_f16`` (5bh) at the shapes and mask of the last
    kernel-5b call of its step."""
    from repro_torch.configs import get_config
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    f16, dev, reps = torch.float16, gen.device, args.reps
    rg = get_config("recurrentgemma-2b")
    rows = [flash_model_row(gen, fa, "flash_attention_f16", "qwen2-1.5b",
                            None, reps, dtype=f16)[0],
            flash_model_row(gen, fa, "flash_attention_window_f16",
                            "recurrentgemma-2b", None, reps,
                            prompt_len=HYBRID_PROMPT_LEN,
                            window=rg.local_window, dtype=f16)[0]]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve_full(dev, "qwen2-1.5b", ("flash_attention",),
               {"flash_attention": fa}, args, depth=F16_QWEN_DEPTH,
               changes=dict(dtype="float16"))
    clock = KernelClock()
    try:
        res = train_full(dev, "qwen2-1.5b", F16_QWEN_RUN, clock, args.seed,
                         changes=dict(dtype="float16",
                                      n_layers=F16_QWEN_DEPTH))
    finally:
        clock.close()
    steps = res["steps"]
    check(all(r["launches"]["5"] > 0 and r["launches"]["5b"] > 0
              for r in steps), "qwen2-1.5b float16: kernels 5 and 5b "
                               "launched in every step")
    print(f"qwen2-1.5b float16 served and trained in "
          f"{time.perf_counter() - t0:.2f} s; losses "
          f"{[round(r['loss'], 4) for r in steps]}")
    row = bwd_row(gen, fa, "flash_attention_bwd_f16", "qwen2-1.5b",
                  steps[-1], reps)
    print(f"kernel {row['name']} {row['shape']}: sdpa backward alone "
          f"{row['library_bwd_ms']:.4f} ms, forward with lse "
          f"{row['fwd_ms']:.4f} ms (plain {row['fwd_plain_ms']:.4f}, bound "
          f"{row['fwd_bound_ms']:.4g} ms, library {row['fwd_library_ms']}), "
          f"max |out - plain| {row['fwd_err'][0]:.3g}")
    fwd = ("fwd_err", "fwd_plain_ms", "fwd_bound_ms", "fwd_bound_by",
           "fwd_library_ms")
    rows.append({key: row[key] for key in row if key not in fwd})
    torch.cuda.empty_cache()
    return rows


def print_rows(rows) -> None:
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernel {r['name']} {r['shape']}: {r['ms']:.4f} ms, launches "
              f"{r['launches']}, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib} ms, "
              f"max |kernel - plain| {r['max_abs_err']:.3g}")


def merge_split(recv, cnt, rcap: int, result) -> None:
    """The merge stage's round 0 taken apart on the card, before and after
    the fused merge (``scripts/merge_stage_split.py``): the gather route's
    phases (mask, splitter search, gather, tile sort, result copy) and the
    fused route's, each between CUDA events, and each route's device time
    by kernel (``torch.profiler``)."""
    import merge_stage_split as mss
    km = importlib.import_module("repro_torch.kernels.kway_merge.kway_merge")
    ops = importlib.import_module("repro_torch.kernels.kway_merge.ops")
    k = recv.shape[0]

    def gather_round():
        tiles, _, _ = ops.gather_tiles(recv, cnt, rcap=rcap, tile=mss.TILE,
                                       fill=INT_MAX)
        result.copy_(km.merge_tile_grid(tiles).reshape(k, -1)[:, :rcap])

    def fused_round():
        m, _, _ = ops.kway_merge(recv, cnt, rcap=rcap, tile=mss.TILE,
                                 fill=INT_MAX)
        result.copy_(m)

    for route, split, whole in (
            ("gather (before)", mss.gather_route_split, gather_round),
            ("fused (after)", mss.fused_route_split, fused_round)):
        ms = split(recv, cnt, rcap, result)
        print(f"merge round 0, {route} route: " + ", ".join(
            f"{name} {t:.3f} ms" for name, t in ms.items())
            + f"; sum {sum(ms.values()):.3f} ms")
        print(f"merge round 0, {route} route, device ms by kernel "
              "(torch.profiler; ms, launches, kernel):")
        for name, t, n in mss.by_kernel(whole):
            print(f"  {t:9.3f} {n:5d}  {name[:100]}")


def reset_peak() -> None:
    """Reset the device's peak-memory counter, keeping the script's peak so
    far in ``SCRIPT_PEAK``."""
    SCRIPT_PEAK[0] = max(SCRIPT_PEAK[0], torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()


def staged(load, steps, extract, keys, v, reps, ref, what):
    """Run a ``psrs_plan`` ``reps`` times stage by stage with CUDA-event
    times and each stage's peak device memory; check its output against
    ``ref``.  Returns ``({stage: [ms]}, {stage: peak bytes}, the last run's
    store)``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n_v = keys.numel() // v
    ms = {name: [] for name in ["load"] + [nm for nm, _ in steps]}
    peaks = dict.fromkeys(ms, 0)
    store = None
    for _ in range(reps):
        store = None                              # free the last run's store
        for name, fn in [("load", lambda _: load(keys.reshape(v, n_v)))] \
                + list(steps):
            reset_peak()
            start.record()
            store = fn(store)
            end.record()
            end.synchronize()
            ms[name].append(start.elapsed_time(end))
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
    result, rcount, oflow = extract(store)
    check(int(rcount.sum()) == keys.numel(),
          f"{what}: rcount sums to n ({int(rcount.sum())})")
    check(int(oflow.sum()) == 0, f"{what}: no overflow")
    counts = rcount[:, 0].tolist()
    check(torch.equal(torch.cat([result[i, :counts[i]] for i in range(v)]),
                      ref), f"{what}: staged plan output == torch.sort")
    return ms, peaks, store


def print_stages(what, ms, peaks):
    totals = [sum(t) for t in zip(*ms.values())]
    peaks = dict(peaks, total=max(peaks.values()))
    for name, ts in list(ms.items()) + [("total", totals)]:
        print(f"stage {what} {name}: median "
              f"{statistics.median(ts):.3f} ms (min {min(ts):.3f}, "
              f"max {max(ts):.3f}, {len(ts)} runs), peak "
              f"{peaks[name] / 2**30:.2f} GiB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n", type=int, default=27,
                    help="log2 of the main run's key count (default 27)")
    ap.add_argument("--v", type=int, default=16)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed calls per kernel")
    ap.add_argument("--stage-reps", type=int, default=3,
                    help="staged PSRS runs timed stage by stage")
    ap.add_argument("--tiered-only", action="store_true",
                    help="build and run the backing-tier phase alone (no "
                         "kernels line, no ok line)")
    ap.add_argument("--recovery-only", action="store_true",
                    help="build and run the recovery phase alone (no "
                         "kernels line, no ok line)")
    ap.add_argument("--apps-only", action="store_true",
                    help="build and run the other BSP apps and collectives "
                         "phase alone (no kernels line, no ok line)")
    ap.add_argument("--trace-only", action="store_true",
                    help="build and run the tracing phase alone (no "
                         "kernels line, no ok line)")
    ap.add_argument("--lm-only", action="store_true",
                    help="build and run the LM serving phase alone (no "
                         "kernels line, no ok line)")
    ap.add_argument("--train-only", action="store_true",
                    help="build and run the training phase alone (no "
                         "kernels line, no ok line)")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="run the dry-run phase alone (no kernels line, no "
                         "ok line)")
    ap.add_argument("--dtypes-only", action="store_true",
                    help="build and run the dtype checks and rows alone "
                         "(their own kernels line, no ok line)")
    ap.add_argument("--cards-only", action="store_true",
                    help="build and run the mesh-of-cards phase alone on "
                         f"{CARDS} cards (its own kernels line, no ok line); "
                         f"exits 1 with fewer than {CARDS}")
    ap.add_argument("--resume-only", action="store_true",
                    help="build and run the training driver's kill -9 and "
                         "resume phase alone (no kernels line, no ok line)")
    ap.add_argument("--elastic-only", action="store_true",
                    help="build and run the elastic checkpoint phase alone "
                         f"on {CARDS} cards (no kernels line, no ok line); "
                         f"exits 1 with fewer than {CARDS}")
    ap.add_argument("--elastic-rank", metavar="SPEC",
                    help="one rank of the elastic phase (a JSON spec); the "
                         "phase starts these itself")
    ap.add_argument("--dryrun-child", metavar="CELL",
                    help="one trace of the dry-run phase (a, b or c); the "
                         "phase starts these itself")
    ap.add_argument("--recovery-child", metavar="SPEC",
                    help="one leg of the recovery phase (a JSON spec); the "
                         "phase starts these itself")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "scripts"))
    if args.dryrun_child:
        return dryrun_child(args.dryrun_child)
    if args.recovery_child:
        return recovery_child(json.loads(args.recovery_child))
    if args.elastic_rank:
        return elastic_rank(json.loads(args.elastic_rank))
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    if ((args.cards_only or args.elastic_only)
            and torch.cuda.device_count() < CARDS):
        print(f"chip_smoke: --cards-only and --elastic-only need {CARDS} "
              f"CUDA cards, {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {so.name}")
    dev = torch.device("cuda")
    if args.tiered_only:
        run_tiered(dev, args)
        return 0
    if args.recovery_only:
        run_recovery(dev, args)
        return 0
    if args.apps_only:
        run_apps(dev, args)
        return 0
    if args.trace_only:
        run_trace(dev, args, card)
        return 0
    if args.lm_only:
        run_lm(dev, args)
        return 0
    if args.train_only:
        run_train(dev, args)
        return 0
    if args.resume_only:
        run_resume(dev)
        return 0
    if args.elastic_only:
        run_elastic(args)
        return 0
    if args.dryrun_only:
        run_dryrun(dev, args, card)
        return 0
    if args.cards_only:
        rows = run_cards(args)
        run_elastic(args)
        print(json.dumps({"kernels": rows}))
        return 0
    if args.dtypes_only:
        print(json.dumps({"kernels": run_dtypes(dev, args)}))
        return 0
    rows = run(dev, args)
    torch.cuda.empty_cache()
    run_trace(dev, args, card)
    torch.cuda.empty_cache()
    run_tiered(dev, args)
    torch.cuda.empty_cache()
    run_recovery(dev, args)
    torch.cuda.empty_cache()
    rows += run_apps(dev, args)
    torch.cuda.empty_cache()
    # The dry run's production-mesh trace takes a minute of the host's CPU:
    # it runs beside the serving and training phases.
    early = {"c": spawn_dryrun("c")}
    try:
        rows += run_lm(dev, args)
        torch.cuda.empty_cache()
        rows += run_train(dev, args)
        torch.cuda.empty_cache()
        run_resume(dev)
        run_dryrun(dev, args, card, early)
    finally:
        stop(early.values())
    torch.cuda.empty_cache()
    if torch.cuda.device_count() >= CARDS:
        rows += run_cards(args)
        run_elastic(args)
    else:
        print(f"cards and elastic phases: not run: they need {CARDS} CUDA "
              f"cards for a mesh of cards, {torch.cuda.device_count()} "
              "visible (the mesh-of-cards route ran forced onto one card, "
              "phase 5d; a checkpoint restored by placements, phase 10b)")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(dev: torch.device, args) -> list:
    """Every phase after the build, on ``dev``; returns the ``kernels``
    rows."""
    from repro_torch.core import make_mesh
    from repro_torch.kernels.kway_merge.ops import gather_tiles
    from repro_torch.pems_apps import psrs_plan, psrs_sort
    kern = kernel_modules()
    bs, km, dv = kern["bitonic"], kern["kway"], kern["deliver"]
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    t0 = time.perf_counter()
    edge_checks(gen, kern)
    print(f"edge checks: passed in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    dtype_edge_checks(gen, kern)
    print(f"dtype edge checks: passed in {time.perf_counter() - t0:.2f} s")

    # ---- main path: psrs_sort at full scale, counts reset just before ----
    n, v, k = 1 << args.log_n, args.v, args.k
    n_v, tile = n // v, 256
    keys = rand_int32((n,), gen)
    ref = torch.sort(keys).values
    set_counts(kern)
    torch.cuda.synchronize()
    reset_peak()
    t0 = time.perf_counter()
    out = psrs_sort(keys, v=v, k=k, driver="async", use_kernel=True,
                    merge_kernel=True, device=dev)
    torch.cuda.synchronize()
    sort_s = time.perf_counter() - t0
    launches = read_counts(kern, COUNTERS)
    peak = torch.cuda.max_memory_allocated()
    check(torch.equal(out, ref), "psrs_sort output == torch.sort")
    # The merge stage runs the fused merge (splitters and segments); the
    # gathered-tile sort runs only for tiles past 1024 keys.
    path = ("radix_sort", "alltoallv_deliver", "kway_splitters",
            "kway_merge_segments")
    check(all(launches[name] > 0 for name in path),
          f"every kernel of the main path launched: {launches}")
    out_p1 = out
    del out
    print(f"psrs_sort n=2^{args.log_n} v={v} k={k} async: {sort_s:.3f} s "
          f"host clock (first call), launches {launches}, peak "
          f"{peak / 2**30:.2f} GiB")

    # ---- the same plan, stage by stage, under each driver ---------------
    # Async runs last: its finished store feeds the kernel timings below.
    # Each driver's swap cost is also timed alone, as a superstep whose
    # function changes nothing (explicit: none; sliced: a zeroed view of
    # each round; async: each round copied into a buffer and written back).
    stage_ms, stage_peak, swap_ms = {}, {}, {}
    for driver in ("explicit", "sliced", "async"):
        store = None                              # free the last plan's store
        pems, load, steps, extract = psrs_plan(v, n_v, k=k, driver=driver,
                                               device=dev)
        ms, stage_peak[driver], store = staged(
            load, steps, extract, keys, v, args.stage_reps, ref, driver)
        swap_ms[driver] = cuda_ms(
            lambda: pems.superstep(store, lambda rhos, ctx: ctx, reads=[],
                                   writes=[]), args.reps)
        stage_ms[driver] = ms
    for driver, ms in stage_ms.items():
        print_stages(driver, ms, stage_peak[driver])
        print(f"swap {driver}: {swap_ms[driver]:.3f} ms per superstep "
              f"({args.reps} no-op supersteps)")
    # Yardstick for the whole path: one library sort of the same keys.
    print(f"torch.sort of the same {n} keys: "
          f"{cuda_ms(lambda: torch.sort(keys), args.reps):.3f} ms")

    # ---- each kernel on the inputs the main path gave it --------------
    rows = []
    reps = args.reps

    lo = pems.layout
    rcap = 2 * n_v
    recv, rcnt = store.field("brecv")[:k], store.field("brcnt")[:k]
    rows += merge_rows(km, recv, rcnt, rcap, tile, launches, reps)
    dtype_rows = merge_rows_u32(km, recv, rcnt, rcap, tile, reps)
    merge_split(recv, rcnt, rcap, store.field("result")[:k])
    tiles, _, _ = gather_tiles(recv, rcnt, rcap=rcap, tile=tile, fill=INT_MAX)
    err = same(km.merge_tile_grid(tiles), km.sort_tile_rows(tiles),
               "kway tiles main path")
    b_ms, b_by = bound(8 * tiles.numel(), sort_ops(*tiles.shape))
    rows.append(dict(
        name="kway_merge_tiles", route="cuda",
        source="src/repro_torch/csrc/kway_merge.cu",
        replaces="src/repro/kernels/kway_merge/kway_merge.py:65",
        launches=launches["kway_merge_tiles"], max_abs_err=err,
        ms=cuda_ms(lambda: km.merge_tile_grid(tiles), reps),
        plain_ms=cuda_ms(lambda: km.sort_tile_rows(tiles), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.sort(tiles, dim=-1), reps),
        shape=f"[{tiles.shape[0]}, {tile}] int32, the gather route's tiles "
              "(off the main path since the fused merge)",
        network=network_ops(*tiles.shape)))
    del tiles, recv, rcnt

    data = store.data
    ww = n_v                                  # cap words per message
    off_s, off_r = lo.offset("bsend"), lo.offset("brecv")
    off_c, off_rc = lo.offset("bscnt"), lo.offset("brcnt")

    def deliver(fn):
        return lambda: fn(data, off_s, data, off_r, v, ww, data, off_c,
                          INT_MAX, data, off_c, data, off_rc)

    deliver(dv.deliver_words)()
    got = store.field_words_view("brecv").clone()
    got_ct = store.field_words_view("brcnt").clone()
    deliver(dv.deliver_words_plain)()
    err = max(same(got, store.field_words_view("brecv"), "deliver main"),
              same(got_ct, store.field_words_view("brcnt"), "deliver ct"))
    del got, got_ct
    valid = int(store.field("bscnt").sum())
    b_ms, b_by = bound(4 * (valid + v * v * ww + 3 * v * v))
    # The one PyTorch call computing the same function: the masked
    # transpose of the send words, torch.where(lane < counts, msgs^T, fill).
    msgs_t = data[:, off_s:off_s + v * ww].unflatten(1, (v, ww)).transpose(
        0, 1)
    cnt_t = data[:, off_c:off_c + v].transpose(0, 1)[..., None]
    lane = torch.arange(ww, device=dev)
    fill_t = torch.tensor(INT_MAX, dtype=torch.int32, device=dev)
    rows.append(dict(
        name="alltoallv_deliver", route="cuda",
        source="src/repro_torch/csrc/alltoallv_deliver.cu",
        replaces="src/repro/kernels/alltoallv_deliver/"
                 "alltoallv_deliver.py:79",
        launches=launches["alltoallv_deliver"], max_abs_err=err,
        ms=cuda_ms(deliver(dv.deliver_words), reps),
        plain_ms=cuda_ms(deliver(dv.deliver_words_plain), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.where(lane < cnt_t, msgs_t, fill_t),
                           reps),
        shape=f"v={v}, ww={ww} int32 words, {valid} valid"))
    del msgs_t, cnt_t
    store = data = result = rcount = oflow = None

    # The local sort's input as round 0 of sort_sample sees it: the "data"
    # field of the first k contexts of a freshly loaded store, rows one
    # context (the store's row stride) apart.
    store = load(keys.reshape(v, n_v))
    x = store.field("data")[:k]
    check(x.stride(0) == lo.words, f"strided rows ({x.stride()})")
    got = bs.bitonic_sort_rows(x)
    err = max(same(got, bs.radix_sort_plain(x), "radix main path"),
              same(got, torch.sort(x, dim=-1).values,
                   "radix main path == torch.sort"))
    del got
    b_ms, b_by = bound(8 * x.numel(), sort_ops(k, n_v))
    rows.insert(0, dict(
        name="radix_sort", route="cuda",
        source="src/repro_torch/csrc/radix_sort.cu",
        replaces="src/repro/kernels/bitonic_sort/bitonic_sort.py:44",
        launches=launches["radix_sort"], max_abs_err=err,
        ms=cuda_ms(lambda: bs.bitonic_sort_rows(x), reps),
        plain_ms=cuda_ms(lambda: bs.radix_sort_plain(x), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.sort(x, dim=-1), reps),
        shape=f"[{k}, {n_v}] int32, row stride {x.stride(0)}"))
    del store, x, pems, load, steps, extract
    torch.cuda.empty_cache()

    rows += sort_rows_float(gen, bs, k, n_v, reps) + dtype_rows
    rows += narrow_delivery_rows(gen, dv, reps)
    rows.append(run_mesh(dev, args, keys, ref, out_p1, kern, stage_ms))
    del out_p1
    torch.cuda.empty_cache()
    run_forced_cards(dev, args, kern)
    torch.cuda.empty_cache()

    # ---- smaller matrix ------------------------------------------------
    t0 = time.perf_counter()
    m = 1 << min(20, args.log_n)
    for kind in ("random", "dups"):
        mk = rand_int32((m,), gen, kind)
        mref = torch.sort(mk).values
        for driver in ("explicit", "sliced", "async"):
            for mode in ("direct", "indirect"):
                got = psrs_sort(mk, v=v, k=k, driver=driver, mode=mode,
                                device=dev)
                check(torch.equal(got, mref),
                      f"psrs 2^20 {kind} {driver} {mode}")
        for uk, mkn in ((False, True), (True, False)):
            got = psrs_sort(mk, v=v, k=k, use_kernel=uk, merge_kernel=mkn,
                            device=dev)
            check(torch.equal(got, mref),
                  f"psrs 2^20 {kind} use_kernel={uk} merge_kernel={mkn}")
        # P > 1 on the one card: P real processors of v/P contexts each.
        for P in (2, MESH_P):
            mesh = make_mesh(P, device=dev)
            for driver in ("explicit", "sliced", "async"):
                for mode in ("direct", "indirect"):
                    for alpha in (None, 1):
                        got = psrs_sort(mk, v=v, k=MESH_K, P=P, mesh=mesh,
                                        alpha=alpha, driver=driver,
                                        mode=mode, device=dev)
                        check(torch.equal(got, mref),
                              f"psrs 2^20 {kind} P={P} {driver} {mode} "
                              f"alpha={alpha}")
            got = psrs_sort(mk, v=v, k=MESH_K, P=P, mesh=mesh, alpha=1,
                            use_kernel=False, device=dev)
            check(torch.equal(got, mref),
                  f"psrs 2^20 {kind} P={P} use_kernel=False")
    small = rand_int32((1 << 14,), gen, "extremes")
    check(torch.equal(psrs_sort(small, v=8, k=2, device=dev).cpu(),
                      psrs_sort(small.cpu(), v=8, k=2, device="cpu")),
          "psrs 2^14 GPU == CPU plain versions")
    kw = dict(v=v, k=MESH_K, P=MESH_P, alpha=1, return_pems=True)
    got, gp = psrs_sort(small, mesh=make_mesh(MESH_P, device=dev),
                        device=dev, **kw)
    want, cp = psrs_sort(small.cpu(), mesh=make_mesh(MESH_P, device="cpu"),
                         device="cpu", **kw)
    check(torch.equal(got.cpu(), want)
          and gp.ledger.snapshot() == cp.ledger.snapshot(),
          f"psrs 2^14 P={MESH_P} GPU == CPU plain versions, equal ledgers")
    print(f"matrix at 2^20: passed in {time.perf_counter() - t0:.2f} s")

    # ---- report ----------------------------------------------------------
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
        print(f"kernel {r['name']} {r['shape']}: {r['ms']:.3f} ms, "
              f"launches {r['launches']}, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"library {lib} ms")
        if "network" in r:
            print(f"  tile bitonic network: {r['network']:.4g} min/max, "
                  f"{r['network'] / INT32_OPS_PER_S * 1e3:.4f} ms at the "
                  "int32 rate (the algorithm's work, not the function's)")
    script_peak = max(SCRIPT_PEAK[0], torch.cuda.max_memory_allocated())
    print(f"peak device memory (main path): {peak / 2**30:.2f} GiB; "
          f"whole script: {script_peak / 2**30:.2f} GiB")
    return [{key: r[key] for key in r if key not in ("shape", "network")}
            for r in rows]


def run_mesh(dev, args, keys, ref, out_p1, kern, stage_ms_p1) -> dict:
    """The ``P > 1`` path on the one card: ``psrs_sort`` over ``MESH_P``
    real processors (row blocks of one store, a one-device mesh) on the main
    path's keys, unchunked under the async driver and α-chunked (α = 1)
    under the explicit driver, each with every kernel count reset just
    before it; then the same plans stage by stage, and kernel 4 timed on the
    α = 1 run's first chunk.  Returns kernel 4's ``kernels`` row."""
    from repro_torch.core import analysis, make_mesh
    from repro_torch.pems_apps import psrs_plan, psrs_sort
    dv = kern["deliver"]
    n, v, P, k = keys.numel(), args.v, MESH_P, MESH_K
    n_v, m = n // v, v // MESH_P
    mesh = make_mesh(P, device=dev)
    runs = (("async", None), ("explicit", 1))
    launches = {}
    for driver, alpha in runs:
        set_counts(kern)
        torch.cuda.synchronize()
        reset_peak()
        t0 = time.perf_counter()
        out, pems = psrs_sort(keys, v=v, k=k, P=P, mesh=mesh, alpha=alpha,
                              driver=driver, device=dev, return_pems=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = read_counts(kern, ("radix_sort", "kway_splitters",
                                 "kway_merge_segments",
                                 "assemble_proc_tiles"))
        what = f"P={P} {driver} alpha={alpha}"
        check(torch.equal(out, ref), f"psrs_sort {what} == torch.sort")
        check(torch.equal(out, out_p1), f"psrs_sort {what} == the P=1 run")
        check(all(c > 0 for c in got.values()),
              f"every kernel of the P > 1 path launched ({what}): {got}")
        rounds = analysis.pems2_alltoallv_par_network_rounds(v, P, k, alpha)
        check(pems.ledger.network_rounds == rounds
              == got["assemble_proc_tiles"],
              f"{what}: network_rounds {pems.ledger.network_rounds}, "
              f"closed form {rounds}, kernel 4 launches "
              f"{got['assemble_proc_tiles']}")
        launches[(driver, alpha)] = got
        print(f"psrs_sort n=2^{args.log_n} v={v} k={k} {what}: {secs:.3f} s "
              f"host clock (first call), launches {got}, network_rounds "
              f"{rounds}, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del out, pems

    stage_ms, stage_peak = {}, {}
    for driver, alpha in runs:
        store = None                              # free the last plan's store
        pems, load, steps, extract = psrs_plan(v, n_v, k=k, P=P, mesh=mesh,
                                               alpha=alpha, driver=driver,
                                               device=dev)
        what = f"P={P} {driver} alpha={alpha}"
        stage_ms[what], stage_peak[what], store = staged(
            load, steps, extract, keys, v, args.stage_reps, ref, what)
    for what, ms in stage_ms.items():
        print_stages(what, ms, stage_peak[what])
    med = {what: statistics.median(ms["alltoallv"])
           for what, ms in list(stage_ms_p1.items()) + list(stage_ms.items())}
    print("alltoallv stage, median ms: " + ", ".join(
        f"{'P=1 ' + w if 'P=' not in w else w} {t:.3f}"
        for w, t in med.items()) + " (at P > 1 kernel 4 lands each chunk "
        "in the receivers' rows: no exchange copy, no network)")

    # Kernel 4 on the α = 1 run's first chunk: source round 0 (s = k rows of
    # every sender), destination chunk 0 (d = 1 context of every process),
    # landing in the receivers' recv rows of the store as the main path
    # lands it, and into a contiguous buffer (the layout a mesh over several
    # cards would ship).
    lo, data = pems.layout, store.data
    off_s, off_c = lo.offset("bsend"), lo.offset("bscnt")
    off_r, off_rc = lo.offset("brecv"), lo.offset("brcnt")
    rows = data[:, off_r:off_r + v * n_v].view(P, m, P, m, n_v)
    rc = data[:, off_rc:off_rc + v].view(P, m, P, m)
    s, d = k, 1
    nmsg = P * P * d * s

    def landing(s, d):
        return (rows[:, :d, :, :s].permute(2, 0, 1, 3, 4),
                rc[:, :d, :, :s].permute(2, 0, 1, 3))

    def stage(fn, s, d, out, ct):
        return lambda: fn(data, off_s, m, P, P, 0, s, 0, d, n_v, out,
                          data, off_c, INT_MAX, data, off_c, ct)

    out, ct = landing(s, d)
    stage(dv.assemble_words, s, d, out, ct)()
    got, got_ct = out.clone(), ct.clone()
    stage(dv.assemble_words_plain, s, d, out, ct)()
    err = max(same(got, out, "assemble main path, recv rows"),
              same(got_ct, ct, "assemble main path counts, recv rows"))
    bufs = [torch.empty(nmsg * n_v, dtype=torch.int32, device=dev)
            for _ in range(2)]
    cts = [torch.empty(nmsg, dtype=torch.int32, device=dev)
           for _ in range(2)]
    stage(dv.assemble_words, s, d, bufs[0], cts[0])()
    stage(dv.assemble_words_plain, s, d, bufs[1], cts[1])()
    err = max(err, same(bufs[0], bufs[1], "assemble main path, buffer"),
              same(cts[0], cts[1], "assemble main path counts, buffer"),
              same(bufs[0].view(got.shape), got, "buffer == recv rows"),
              same(cts[0].view(got_ct.shape), got_ct,
                   "buffer counts == recv rows counts"))
    del got, got_ct
    # The chunk's valid words: counts of rows q·m + j (j < s) for the
    # destinations p·m (d = 1), clamped to [0, ω].
    cnt = store.field("bscnt").reshape(P, m, P, m)[:, :s, :, :d]
    valid = int(cnt.clamp(0, n_v).sum())
    b_ms, b_by = bound(4 * (valid + nmsg * n_v + 3 * nmsg))
    # The one PyTorch call computing the same function: torch.where(lane <
    # counts, the chunk's permuted view [q, p, dl, j, ω], fill).
    sent = data[:, off_s:off_s + v * n_v].view(P, m, P, m, n_v)
    sent = sent[:, :s, :, :d].permute(0, 2, 3, 1, 4)
    sent_cnt = data[:, off_c:off_c + v].view(P, m, P, m)[:, :s, :, :d]
    sent_cnt = sent_cnt.permute(0, 2, 3, 1)[..., None]
    lane = torch.arange(n_v, device=dev)
    fill_t = torch.tensor(INT_MAX, dtype=torch.int32, device=dev)
    row = dict(
        name="assemble_proc_tiles", route="cuda",
        source="src/repro_torch/csrc/alltoallv_deliver.cu",
        replaces="src/repro/kernels/alltoallv_deliver/"
                 "alltoallv_deliver.py:163",
        launches=launches[("explicit", 1)]["assemble_proc_tiles"],
        max_abs_err=err,
        ms=cuda_ms(stage(dv.assemble_words, s, d, out, ct), args.reps),
        plain_ms=cuda_ms(stage(dv.assemble_words_plain, s, d, out, ct), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.where(lane < sent_cnt, sent,
                                               fill_t), args.reps),
        shape=f"P={P} senders x [s={s}, P={P}, d={d}, ww={n_v}] int32 "
              f"words landing in the recv rows, {valid} valid")
    del sent, sent_cnt
    buf_ms = cuda_ms(stage(dv.assemble_words, s, d, bufs[0], cts[0]),
                     args.reps)
    print("kernel 4 launches per run: " + ", ".join(
        f"P={P} {dr} alpha={a}: {c['assemble_proc_tiles']}"
        for (dr, a), c in launches.items()))
    print(f"alltoallv P={P} alpha=1 first chunk: kernel 4 landing in the "
          f"recv rows {row['ms']:.3f} ms (the main path, no exchange), into "
          f"a buffer {buf_ms:.3f} ms, for {nmsg * n_v * 4 / 2**30:.2f} GiB")
    del bufs, cts, out, ct
    # The unchunked run's one chunk (s = d = m, 8 GiB at 2^27): kernel 4
    # landing and into a buffer, beside kernel 2 on the same words (message
    # (s -> d) from row s into row d: the same function).
    out, ct = landing(m, m)
    ms = cuda_ms(stage(dv.assemble_words, m, m, out, ct), args.reps)
    whole = torch.empty(P * P * m * m * n_v, dtype=torch.int32, device=dev)
    whole_ct = torch.empty(P * P * m * m, dtype=torch.int32, device=dev)
    whole_ms = cuda_ms(stage(dv.assemble_words, m, m, whole, whole_ct),
                       args.reps)
    del whole, whole_ct
    k2_ms = cuda_ms(lambda: dv.deliver_words(
        data, off_s, data, off_r, v, n_v, data, off_c, INT_MAX, data, off_c,
        data, off_rc), args.reps)
    print(f"kernel 4 on the unchunked chunk [P={P}, P={P}, {m}, {m}, {n_v}] "
          f"({P * P * m * m * n_v * 4 / 2**30:.2f} GiB written): landing in "
          f"the recv rows {ms:.3f} ms, into a buffer {whole_ms:.3f} ms; "
          f"kernel 2 on the same words {k2_ms:.3f} ms")
    return row


# --------------------------------------------------------------------------- #
# The mesh of cards: each process's row block on its own card.                #
# --------------------------------------------------------------------------- #

# The cards phase: cards it needs, its runs as (log2 of the keys, driver,
# alpha, k) — 2^27 as the one-card P = 4 runs have it, 2^29 (a store of
# v·μ ≈ 70 GiB, past one card) at k = 1, where a card's partition
# temporaries stay under half its block — and the card-to-card yardstick's
# bytes.  On one card the route is forced onto four blocks of that card at
# 2^24 keys.
CARDS = 4
CARDS_RUNS = [(27, "explicit", 1, 2), (27, "async", None, 2),
              (29, "explicit", 1, 1), (29, "explicit", None, 1)]
CARDS_FORCED_LOG_N = 24
CARDS_COPY_BYTES = 1 << 30
# At 2^29 under α = 1 a card's peak memory must stay within this share of
# its block (v·μ/P).
CARDS_PEAK_SHARE = 1.5


def forced_cards(P: int, card: torch.device):
    """A mesh of ``P`` entries on one card whose predicate says it spans
    cards: the mesh-of-cards route (a block per process, each its own
    allocation, the exchange through ``Mesh.all_to_all``) on ``card``."""
    from repro_torch.core import Mesh

    class OneCardAsCards(Mesh):
        spans_devices = True

    return OneCardAsCards([card] * P)


def plan_run(keys, v: int, **kw):
    """``psrs_plan`` run stage by stage: ``(sorted keys, the final store's
    words on the first card, pems, store)``."""
    from repro_torch.core.context import MeshStore
    from repro_torch.pems_apps import psrs_plan
    from repro_torch.pems_apps.psrs import _result_fields, _sorted_keys
    pems, load, steps, _ = psrs_plan(v, keys.numel() // v, **kw)
    store = load(keys.reshape(v, -1))
    for _, step in steps:
        store = step(store)
    pems.synchronize()
    words = store.gather() if isinstance(store, MeshStore) else store.data
    return _sorted_keys(_result_fields(store)), words, pems, store


def staging_row(dv, blk, lo, P, k, n_v, launches, reps, where) -> dict:
    """Kernel 4 as a sender's staging kernel (row 4x): one sender's first
    α = 1 chunk (its first ``k`` sources to context 0 of every process,
    ``[P, 1, k, ω]`` words and counts) from its block ``blk`` into a
    contiguous wire buffer on its card, against the plain version; its
    bound is the valid words read, the buffer's words written and three
    words a message, over the HBM rate."""
    m = blk.shape[0]
    off_s, off_c = lo.offset("bsend"), lo.offset("bscnt")
    wires = [torch.empty((P, 1, k, n_v), dtype=torch.int32,
                         device=blk.device) for _ in range(2)]
    cts = [torch.empty((P, 1, k), dtype=torch.int32, device=blk.device)
           for _ in range(2)]

    def stage(fn, i):
        return lambda: fn(blk, off_s, m, P, 1, 0, k, 0, 1, n_v, wires[i],
                          blk, off_c, INT_MAX, blk, off_c, cts[i])

    with torch.cuda.device(blk.device):
        stage(dv.assemble_words, 0)()
        stage(dv.assemble_words_plain, 1)()
        err = max(same(wires[0], wires[1], f"kernel 4 staging {where}"),
                  same(cts[0], cts[1], f"kernel 4 staging counts {where}"))
        cnt = blk[:k, off_c:off_c + P * m].reshape(k, P, m)[:, :, 0]
        valid = int(cnt.clamp(0, n_v).sum())
        nmsg = P * k
        b_ms, b_by = bound(4 * (valid + nmsg * n_v + 3 * nmsg))
        # The one PyTorch call computing the same function: torch.where
        # over the chunk's permuted view [p, 1, j, ω].
        sent = blk[:k, off_s:off_s + P * m * n_v].view(k, P, m, n_v)
        sent = sent[:, :, :1].permute(1, 2, 0, 3)
        sent_cnt = cnt[:, :, None].permute(1, 2, 0)[..., None]
        lane = torch.arange(n_v, device=blk.device)
        fill_t = torch.tensor(INT_MAX, dtype=torch.int32, device=blk.device)
        return dict(
            name="assemble_proc_tiles_wire", route="cuda",
            source="src/repro_torch/csrc/alltoallv_deliver.cu",
            replaces="src/repro/kernels/alltoallv_deliver/"
                     "alltoallv_deliver.py:163",
            launches=launches, max_abs_err=err,
            ms=cuda_ms(stage(dv.assemble_words, 0), reps),
            plain_ms=cuda_ms(stage(dv.assemble_words_plain, 1), 2),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: torch.where(lane < sent_cnt, sent,
                                                   fill_t), reps),
            shape=f"one sender {where}: [P={P}, d=1, s={k}, ww={n_v}] int32 "
                  f"words into the wire buffer, {valid} valid")


def run_forced_cards(dev, args, kern) -> None:
    """Phase 5d: the mesh-of-cards route forced onto ``MESH_P`` blocks of
    the one card (``forced_cards``), 2^24 keys, k = ``MESH_K``, unchunked
    under the async driver and α = 1 under the explicit driver: the sorted
    keys and every final store word equal the one-card fused route's (the
    same plan on a one-card mesh), the local sort and merge launch, and
    kernel 4 stages once a sender a chunk (P × the network rounds).  Times
    kernel 4 as the sender's staging kernel on block 1."""
    from repro_torch.core import analysis, make_mesh
    t_phase = time.perf_counter()
    dv = kern["deliver"]
    n, v, P, k = 1 << CARDS_FORCED_LOG_N, args.v, MESH_P, MESH_K
    gen = torch.Generator(device=dev).manual_seed(args.seed + 70)
    keys = rand_int32((n,), gen)
    ref = torch.sort(keys).values
    card = torch.device("cuda", torch.cuda.current_device())
    row = None
    for driver, alpha in (("async", None), ("explicit", 1)):
        kw = dict(k=k, P=P, alpha=alpha, driver=driver, device=dev)
        what = f"forced cards P={P} {driver} alpha={alpha}"
        want, want_words, _, _ = plan_run(
            keys, v, mesh=make_mesh(P, device=dev), **kw)
        set_counts(kern)
        got, words, pems, store = plan_run(keys, v,
                                           mesh=forced_cards(P, card), **kw)
        launches = read_counts(kern, COUNTERS)
        rounds = analysis.pems2_alltoallv_par_network_rounds(v, P, k, alpha)
        check(pems.cards and len({b.data_ptr() for b in store.blocks}) == P,
              f"{what}: a block a process, each its own allocation")
        check(torch.equal(got, ref) and torch.equal(got, want),
              f"{what}: keys == torch.sort == the one-card fused route")
        check(torch.equal(words, want_words),
              f"{what}: every final store word == the one-card fused route's")
        check(launches["assemble_proc_tiles"] == P * rounds
              and all(launches[x] > 0 for x in (
                  "radix_sort", "kway_splitters", "kway_merge_segments")),
              f"{what}: kernel 4 once a sender a chunk ({P} x {rounds}), "
              f"every kernel of the path launched: {launches}")
        print(f"{what}, n=2^{CARDS_FORCED_LOG_N}: keys and final store == the "
              f"one-card fused route's; launches {launches}")
        if alpha == 1:
            row = staging_row(dv, store.blocks[1], pems.layout, P, k,
                              n // v, launches["assemble_proc_tiles"],
                              args.reps, "block 1 of the one card")
        del want, want_words, got, words, pems, store
    print(f"kernel 4x {row['shape']}: {row['ms']:.3f} ms, plain "
          f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}), library {row['library_ms']:.4f} ms")
    print(f"forced cards phase: {time.perf_counter() - t_phase:.2f} s")


class CardLaunches:
    """Kernel launches by card: each PSRS kernel module's ``launch`` counted
    by (its card, the entry it calls), beside the modules' own counters."""

    def __init__(self, kern):
        self.counts = {}
        self._orig = {}
        for mod in kern.values():
            self._orig[mod] = launch = mod.launch

            def counted(name, device, *a, launch=launch):
                key = (device.index, name)
                self.counts[key] = self.counts.get(key, 0) + 1
                return launch(name, device, *a)

            mod.launch = counted

    def by_card(self) -> dict:
        out = {}
        for (card, name), n in sorted(self.counts.items()):
            out.setdefault(card, {})[name.removeprefix("repro_")] = n
        return out

    def restore(self) -> None:
        for mod, launch in self._orig.items():
            mod.launch = launch


def meta_ledger(v, n_v, P, k, alpha, driver) -> dict:
    """The one-card mesh's modeled ledger of a PSRS run (direct mode):
    ``psrs_plan`` on a one-device mesh with its store on the meta device
    (shapes, no data), so a size no card holds is billed too.  The ledger
    depends on the layout and the calls, not on the data: the partition's
    grouping, whose output size depends on its data, is replaced by its
    shapes for this run."""
    import repro_torch.pems_apps.psrs as psrs_mod
    from repro_torch.core import make_mesh

    def shapes(data, dest, v_, cap, fill=0):
        rows, dev = data.shape[0], data.device
        return (torch.empty((rows, v_, cap), dtype=data.dtype, device=dev),
                torch.empty((rows, v_), dtype=torch.int32, device=dev), None,
                torch.empty((rows,), dtype=torch.bool, device=dev))

    grouping = psrs_mod.group_by_dest
    psrs_mod.group_by_dest = shapes
    try:
        pems, load, steps, _ = psrs_mod.psrs_plan(
            v, n_v, k=k, P=P, alpha=alpha, driver=driver,
            mesh=make_mesh(P, device="meta"), use_kernel=False,
            device="meta")
        store = load(torch.empty((v, n_v), dtype=torch.int32, device="meta"))
        for _, step in steps:
            store = step(store)
    finally:
        psrs_mod.group_by_dest = grouping
    return pems.ledger.snapshot()


def cards_staged(pems, load, steps, keys, v, reps, ref_host, what, devs):
    """``staged`` over a mesh of cards: each stage's time on the host clock
    from all cards drained to all cards drained (a stage ends when every
    card has finished), each stage's peak memory over the cards and each
    card's peak.  The keys lie on card 0, as ``psrs_sort`` has them, so the
    load stage copies each block's rows to its card; the reference sort is
    on the host.  Returns ``({stage: [ms]}, {stage: peak}, {card: peak},
    the last store)``."""
    from repro_torch.pems_apps.psrs import _result_fields, _sorted_keys
    n_v = keys.numel() // v
    ms = {name: [] for name in ["load"] + [nm for nm, _ in steps]}
    peaks = dict.fromkeys(ms, 0)
    card_peak = dict.fromkeys(range(len(devs)), 0)
    store = None
    for _ in range(reps):
        store = None                              # free the last run's store
        for name, fn in [("load", lambda _: load(keys.reshape(v, n_v)))] \
                + list(steps):
            for d in devs:
                torch.cuda.reset_peak_memory_stats(d)
            pems.synchronize()
            t0 = time.perf_counter()
            store = fn(store)
            pems.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            for i, d in enumerate(devs):
                peak = torch.cuda.max_memory_allocated(d)
                card_peak[i] = max(card_peak[i], peak)
                peaks[name] = max(peaks[name], peak)
    check(int(store.field("rcount").sum()) == keys.numel()
          and int(store.field("oflow").sum()) == 0,
          f"{what}: rcount sums to n, no overflow")
    check(torch.equal(_sorted_keys(_result_fields(store)).cpu(), ref_host),
          f"{what}: staged plan output == torch.sort")
    return ms, peaks, card_peak, store


def card_info(n: int) -> None:
    """Each card's name and power limit, the topology and peer access."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for line in smi.splitlines():
        print(f"card {line}")
    for cmd in (["topo", "-m"], ["nvlink", "--status", "-i", "0"]):
        got = subprocess.run(["nvidia-smi"] + cmd, capture_output=True,
                             text=True)
        print(f"nvidia-smi {' '.join(cmd)}:\n"
              + (got.stdout + got.stderr).rstrip())
    print("peer access: " + ", ".join(
        f"{i}->{j} {torch.cuda.can_device_access_peer(i, j)}"
        for i in range(n) for j in range(n) if i != j))


def copy_yardstick(devs, reps: int) -> dict:
    """The card-to-card yardstick: one ``CARDS_COPY_BYTES`` ``copy_`` from
    card 0 to card 1 between CUDA events on card 0's stream (where the copy
    runs), and every card sending that much to every other card at once
    through ``Mesh.all_to_all`` on the host clock, all cards drained.
    Returns ms and GB/s of each."""
    from repro_torch.core import Mesh
    words = CARDS_COPY_BYTES // 4
    src = torch.full((words,), 7, dtype=torch.int32, device=devs[0])
    dst = torch.empty(words, dtype=torch.int32, device=devs[1])
    with torch.cuda.device(devs[0]):
        ms = cuda_ms(lambda: dst.copy_(src), reps)
    check(torch.equal(dst.to(devs[0]), src), "the yardstick's copy landed")
    del src, dst
    n = len(devs)
    send = [torch.full((n, words), q, dtype=torch.int32, device=d)
            for q, d in enumerate(devs)]
    recv = [torch.empty((n, words), dtype=torch.int32, device=d)
            for d in devs]
    mesh = Mesh(devs)
    times = []
    for _ in range(reps + 1):
        for d in devs:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        mesh.all_to_all(send, recv)
        for d in devs:
            torch.cuda.synchronize(d)
        times.append(time.perf_counter() - t0)
    for p in range(n):
        check(all(int(recv[p][q][0]) == q and int(recv[p][q][-1]) == q
                  for q in range(n)), f"all_to_all landed on card {p}")
    a2a = statistics.median(times[1:])
    off_card = n * (n - 1) * CARDS_COPY_BYTES
    out = {"one_ms": ms, "one_gbs": CARDS_COPY_BYTES / ms / 1e6,
           "all_ms": a2a * 1e3, "all_gbs": off_card / a2a / 1e9}
    print(f"yardstick: 1 GiB card 0 -> card 1 copy_ {ms:.3f} ms "
          f"({out['one_gbs']:.1f} GB/s); every card to every other at once "
          f"({off_card / 2**30:.0f} GiB off-card, Mesh.all_to_all) "
          f"{out['all_ms']:.3f} ms ({out['all_gbs']:.1f} GB/s), host clock")
    return out


def cards_collectives(devs, args, gen) -> None:
    """bcast, gather, allgather, reduce (add, max, min) and allreduce at
    v = 16 on 2^20-word fields in int32, uint32 and float32 over the mesh
    of cards, bit for bit against the same calls on a one-card mesh of card
    0 (float32 sums included), with equal ledgers; ms a call on the host
    clock, every card drained."""
    from repro_torch import interop
    from repro_torch.core import ContextLayout, Mesh, Pems, PemsConfig, \
        make_mesh
    v, w, P = args.v, APPS_COLL_WORDS, len(devs)
    calls = [("bcast", ("x",), dict(root=5)),
             ("gather", ("y", "g"), dict(root=9)),
             ("allgather", ("x", "g"), {})]
    for op in ("add", "max", "min"):
        calls += [("reduce", ("x", "o"), dict(op=op, root=3)),
                  ("allreduce", ("x", "o"), dict(op=op))]
    ms = {}
    for dtype in (torch.int32, torch.uint32, torch.float32):
        lo = (ContextLayout().add("x", (w,), dtype).add("y", (w,), dtype)
              .add("o", (w,), dtype).add("g", (v, w), dtype))
        words = rand_int32((v, lo.words), gen)
        if dtype == torch.float32:
            words[:, :2 * w] = torch.randn(
                (v, 2 * w), generator=gen, device=gen.device).view(
                    torch.int32)
        words = words.cpu().numpy().view("uint32")
        outs = {}
        for name, mesh in (("one card", make_mesh(P, device=devs[0])),
                           ("cards", Mesh(devs))):
            pems = Pems(PemsConfig(v=v, k=2, P=P), lo, mesh=mesh,
                        device=devs[0])
            store = interop.store_from_numpy(lo, words, devs[0], mesh=mesh)
            got = []
            for call, a, kw in calls:
                pems.synchronize()
                t0 = time.perf_counter()
                store = getattr(pems, call)(store, *a, **kw)
                pems.synchronize()
                if name == "cards":
                    key = f"{call} {kw.get('op', '')}".strip()
                    ms.setdefault(key, []).append(
                        (time.perf_counter() - t0) * 1e3)
                got.append(interop.store_to_numpy(store).copy())
            outs[name] = (got, pems.ledger.snapshot())
            del store, pems
        for (call, _, kw), a, b in zip(calls, outs["one card"][0],
                                       outs["cards"][0]):
            check((a == b).all(), f"collective {call} {kw} {dtype} over "
                                  "cards == one card, bit for bit")
        check(outs["one card"][1] == outs["cards"][1],
              f"collectives {dtype}: ledger over cards == one card's")
    print(f"collectives over {P} cards at v={v} on 2^20-word fields, ms a "
          "call over int32, uint32 and float32 (median, min, max), each "
          "equal to the one-card mesh's bit for bit:")
    for key, t in ms.items():
        print(f"  {key}: {statistics.median(t):.3f} ({min(t):.3f}, "
              f"{max(t):.3f})")


def run_cards(args) -> list:
    """Phase 13, the device tier over a mesh of ``CARDS`` cards (``python3
    chip_smoke.py --cards-only`` on four cards; the whole script runs it
    where four are visible): the cards, topology and peer access; the
    card-to-card yardstick; PSRS over ``Mesh(["cuda:0", ..., "cuda:3"])``
    at ``CARDS_RUNS`` (keys made on card 0 from ``--seed``): each run once
    through ``psrs_sort`` with every kernel count reset just before it,
    then ``--stage-reps`` times stage by stage.  Checks: the keys equal one
    ``torch.sort`` on card 0; ``rcount`` sums to n, no ``oflow``; the
    modeled ledger equals the one-card mesh's at the same v, k, P, α
    (``meta_ledger``; at the smaller size, under α = 1, that also equals a
    real one-card run's); every kernel of the path launched, on every card,
    kernel 4 once a sender a chunk; block p on card p; at the larger size
    under α = 1 each card's peak within ``CARDS_PEAK_SHARE`` of v·μ/P.
    Prints each stage's ms and the peaks by card, the exchange's bytes (the
    ledger's Alltoallv network term) and GB/s beside the yardstick; then
    kernel 4 as a sender's staging kernel on card 1 (row 4x) and the
    collectives.  Returns row 4x."""
    from repro_torch.core import Mesh, analysis, make_mesh
    from repro_torch.pems_apps import psrs_plan, psrs_sort
    t_phase = time.perf_counter()
    P, v = CARDS, args.v
    devs = [torch.device("cuda", i) for i in range(P)]
    mesh = Mesh(devs)
    card_info(torch.cuda.device_count())
    kern = kernel_modules()
    yard = copy_yardstick(devs, args.reps)
    by_card = CardLaunches(kern)
    row = None
    sizes = sorted({r[0] for r in CARDS_RUNS})
    try:
        for log_n in sizes:
            n = 1 << log_n
            n_v, m = n // v, v // P
            gen = torch.Generator(device=devs[0]).manual_seed(
                args.seed + log_n)
            keys = rand_int32((n,), gen)
            ref = torch.sort(keys).values
            runs = [r[1:] for r in CARDS_RUNS if r[0] == log_n]
            launches = {}
            for driver, alpha, k in runs:
                what = f"cards P={P} n=2^{log_n} k={k} {driver} alpha={alpha}"
                set_counts(kern)
                by_card.counts.clear()
                for d in devs:
                    torch.cuda.reset_peak_memory_stats(d)
                t0 = time.perf_counter()
                out, pems = psrs_sort(keys, v=v, k=k, P=P, mesh=mesh,
                                      alpha=alpha, driver=driver,
                                      return_pems=True)
                pems.synchronize()
                secs = time.perf_counter() - t0
                sort_peak = [torch.cuda.max_memory_allocated(d) / 2**30
                             for d in devs]
                launches[what] = got = read_counts(kern, COUNTERS)
                rounds = analysis.pems2_alltoallv_par_network_rounds(
                    v, P, k, alpha)
                check(torch.equal(out, ref), f"{what}: == torch.sort")
                check(got["assemble_proc_tiles"] == P * rounds
                      and all(got[x] > 0 for x in (
                          "radix_sort", "kway_splitters",
                          "kway_merge_segments")),
                      f"{what}: kernel 4 once a sender a chunk ({P} x "
                      f"{rounds}), every kernel launched: {got}")
                cards_launched = by_card.by_card()
                check(sorted(cards_launched) == list(range(P)),
                      f"{what}: kernels launched on every card: "
                      f"{cards_launched}")
                led = pems.ledger.snapshot()
                check(led == meta_ledger(v, n_v, P, k, alpha, driver),
                      f"{what}: ledger == the one-card mesh's (meta)")
                del out, pems
                if log_n == sizes[0] and alpha == 1:
                    _, one = psrs_sort(keys, v=v, k=k, P=P,
                                       mesh=make_mesh(P, device=devs[0]),
                                       alpha=alpha, driver=driver,
                                       return_pems=True)
                    check(one.ledger.snapshot() == led,
                          f"{what}: ledger == a real one-card run's")
                    del one
                print(f"psrs_sort {what}: {secs:.3f} s host clock (first "
                      f"call), launches {got}, network_rounds {rounds}, by "
                      f"card {cards_launched}, peak GiB by card "
                      + ", ".join(f"{p:.2f}" for p in sort_peak)
                      + " (card 0 also holds the input, the reference and "
                      "the output)")
            ref_host = ref.cpu()
            del ref
            for driver, alpha, k in runs:
                what = f"cards P={P} n=2^{log_n} k={k} {driver} alpha={alpha}"
                plan, load, steps, _ = psrs_plan(
                    v, n_v, k=k, P=P, mesh=mesh, alpha=alpha, driver=driver)
                ms, peaks, card_peak, store = cards_staged(
                    plan, load, steps, keys, v, args.stage_reps, ref_host,
                    what, devs)
                check([b.device for b in store.blocks] == devs,
                      f"{what}: block p on card p")
                share = v * plan.layout.mu_bytes / P
                print_stages(what, ms, peaks)
                print(f"peak GiB by card, {what} (staged; card 0 also holds "
                      "the input): " + ", ".join(
                          f"{card_peak[i] / 2**30:.2f}" for i in range(P))
                      + f"; v·mu/P {share / 2**30:.2f} GiB, the largest "
                      f"{max(card_peak.values()) / share:.3f} of it")
                if log_n == sizes[-1] and alpha == 1:
                    check(max(card_peak.values())
                          <= CARDS_PEAK_SHARE * share,
                          f"{what}: each card's peak within "
                          f"{CARDS_PEAK_SHARE} x v·mu/P")
                net = (v - m) * plan.layout.field_bytes("bsend")
                a2a = statistics.median(ms["alltoallv"])
                print(f"exchange {what}: {net / 2**30:.3f} GiB off-card "
                      f"(the ledger's Alltoallv network term), alltoallv "
                      f"median {a2a:.3f} ms, {net / a2a / 1e6:.1f} GB/s; "
                      f"yardstick one copy {yard['one_gbs']:.1f} GB/s, all "
                      f"pairs at once {yard['all_gbs']:.1f} GB/s")
                if log_n == sizes[0] and alpha == 1:
                    row = staging_row(
                        kern["deliver"], store.blocks[1], plan.layout, P, k,
                        n_v, launches[what]["assemble_proc_tiles"],
                        args.reps, "on card 1")
                del store, plan, load, steps
                for d in devs:
                    with torch.cuda.device(d):
                        torch.cuda.empty_cache()
            del keys, ref_host
    finally:
        by_card.restore()
    gen = torch.Generator(device=devs[0]).manual_seed(args.seed + 80)
    cards_collectives(devs, args, gen)
    print(f"kernel 4x {row['shape']}: {row['ms']:.3f} ms, launches "
          f"{row['launches']}, plain {row['plain_ms']:.3f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}), library "
          f"{row['library_ms']:.4f} ms")
    print(f"cards phase: {time.perf_counter() - t_phase:.2f} s")
    return [{key: row[key] for key in row if key != "shape"}]


# --------------------------------------------------------------------------- #
# The backing tiers: PSRS with its population off the card.                   #
# --------------------------------------------------------------------------- #

# The tracing phase's file-tier run: log2 of its key count, and where its
# backing goes (inside the checkout, git-ignored).
TRACE_FILE_LOG_N = 24
TRACE_DIR = ROOT / "build" / "trace"
# The kernels of PSRS's path on the device tier at P == 1, and at P > 1.
PATH_P1 = ("radix_sort", "alltoallv_deliver", "kway_splitters",
           "kway_merge_segments")
PATH_MESH = ("radix_sort", "assemble_proc_tiles", "kway_splitters",
             "kway_merge_segments")


def traced_sort(dev, kern, keys, trace_path=None, **kw):
    """``psrs_sort`` with tracing on when ``trace_path`` is given, its
    local sort's kernel launches between CUDA events, every kernel count
    reset just before it.  Returns ``(keys, pems, host ms, the local
    sort's CUDA-event ms, launches)``."""
    from repro_torch.kernels.bitonic_sort import bitonic_sort
    from repro_torch.pems_apps import psrs_sort
    events = []

    def timed_sort(x):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        y = bitonic_sort(x)
        b.record()
        events.append((a, b))
        return y

    if trace_path is not None:
        kw.update(trace=True, trace_path=trace_path)
    set_counts(kern)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, pems = psrs_sort(keys, local_sort=timed_sort, return_pems=True,
                          device=dev, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts(kern, COUNTERS)
    return out, pems, ms, sum(a.elapsed_time(b) for a, b in events), launches


def stage_spans(trace) -> dict:
    """{stage: ms} of a trace's ``stage:`` spans."""
    return {e["name"].split(":", 1)[1]: e["dur"] / 1e3
            for e in trace["traceEvents"] if e.get("cat") == "stage"}


def trace_pair(dev, kern, keys, ref, tp, path, what, turns=2, backing=None,
               **kw):
    """``turns`` untraced and traced runs in turns (each on a new backing
    file under ``backing``, deleted after it, on a disk tier); checks the
    keys of both against ``ref``, the path's kernels launched, the traced
    ledger equal to the untraced one, and the ``sort_sample`` span at least
    its kernel-1 launches' CUDA-event time.  Returns the last traced run's
    ``(trace, pems)``."""
    from repro_torch.obs import load_trace
    walls = {False: [], True: []}
    ledgers = {}
    for turn in range(turns):
        for traced in (False, True):
            tag = f"{what} {'traced' if traced else 'untraced'} {turn}"
            if backing is not None:
                kw["backing_path"] = str(backing / f"{turn}{traced}.bin")
            out, pems, ms, sort_ms, launches = traced_sort(
                dev, kern, keys, tp if traced else None, **kw)
            if backing is not None:
                Path(kw["backing_path"]).unlink()
                st = pems.tier_stats
                print(f"trace {tag}: {ms:.1f} ms; swap_in / swap_out / "
                      f"compute / stall {st.swap_in_s:.3f} / "
                      f"{st.swap_out_s:.3f} / {st.compute_s:.3f} / "
                      f"{st.stall_s:.3f} s, overlap "
                      f"{st.overlap_fraction:.4f}")
            check(torch.equal(out.to(ref.device), ref),
                  f"{tag}: keys == torch.sort")
            check(all(launches[name] > 0 for name in path),
                  f"{tag}: every kernel of the path launched: {launches}")
            walls[traced].append(ms)
            ledgers[traced] = pems.merged_shard_ledger().snapshot()
            del out
            if traced:
                t0 = time.perf_counter()
                pems.export_trace(tp)           # again, timed alone
                export_ms = (time.perf_counter() - t0) * 1e3
                trace = load_trace(tp)
                spans = stage_spans(trace)
                check(spans["sort_sample"] >= sort_ms,
                      f"{tag}: sort_sample span {spans['sort_sample']:.3f} "
                      f"ms >= its kernel-1 launches' {sort_ms:.3f} ms")
    check(ledgers[True] == ledgers[False],
          f"{what}: traced ledger == untraced ledger")
    print(f"trace {what}: host ms untraced " + ", ".join(
        f"{t:.3f}" for t in walls[False]) + "; traced " + ", ".join(
        f"{t:.3f}" for t in walls[True]) + f" (the export included; alone "
        f"{export_ms:.3f} ms for {len(trace['traceEvents'])} events); stage "
        f"spans ms " + ", ".join(f"{k} {t:.3f}" for k, t in spans.items())
        + f"; sort_sample's kernel-1 launches {sort_ms:.3f} ms")
    return trace, pems


def run_trace(dev, args, card: str) -> None:
    """The tracing phase: the main path traced on the device tier at P = 1
    and 4, the file tier traced, and the report of both."""
    from repro_torch.core import make_mesh
    from repro_torch.obs import summarize
    from repro_torch.obs import NOOP, Tracer
    kern = kernel_modules()
    t_phase = time.perf_counter()
    # What recording costs the host: a round-loop span, as the executor
    # records it, into a live ring and into the no-op tracer.
    calls = 100_000
    for tr in (Tracer(), NOOP):
        t0 = time.perf_counter()
        for r in range(calls):
            tr.complete("swap_in", t0, t0, tid="prefetch", cat="io",
                        round=r, bytes=4096)
        us = (time.perf_counter() - t0) / calls * 1e6
        print(f"trace: {type(tr).__name__}.complete {us:.3f} us a call on "
              f"the host ({calls} calls)")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 40)
    v = args.v
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # ---- (a) the main path, traced, and (b) at P = 4 on the mesh -----
        keys = rand_int32((1 << args.log_n,), gen)
        ref = torch.sort(keys).values
        trace_pair(dev, kern, keys, ref, str(tmp / "a.json"), PATH_P1,
                   f"(a) n=2^{args.log_n} v={v} k={args.k} P=1 explicit",
                   k=args.k, v=v, driver="explicit")
        trace_pair(dev, kern, keys, ref, str(tmp / "b.json"), PATH_MESH,
                   f"(b) P={MESH_P} k={MESH_K} alpha=1 explicit", turns=1,
                   v=v, k=MESH_K, P=MESH_P, alpha=1, driver="explicit",
                   mesh=make_mesh(MESH_P, device=dev))
        del keys, ref
        torch.cuda.empty_cache()

        # ---- (c) the file tier, traced ------------------------------------
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        try:
            keys = rand_int32((1 << TRACE_FILE_LOG_N,), gen)
            ref = torch.sort(keys).values.cpu()
            what = (f"(c) file n=2^{TRACE_FILE_LOG_N} v={v} k={TIER_K} "
                    "async")
            trace, pems = trace_pair(
                dev, kern, keys, ref, str(tmp / "c.json"),
                ("radix_sort", "kway_splitters", "kway_merge_segments"),
                what, backing=TRACE_DIR, v=v, k=TIER_K, driver="async",
                tier="file")
        finally:
            shutil.rmtree(TRACE_DIR, ignore_errors=True)
        s = summarize(trace)
        stats = pems.tier_stats
        check(s["metrics_overlap"] == stats.overlap_fraction,
              f"{what}: the trace's metrics carry TierStats' overlap")
        delta = abs(s["overlap_fraction"] - s["metrics_overlap"])
        check(delta <= 1e-9, f"{what}: span overlap "
              f"{s['overlap_fraction']:.6f} == TierStats' "
              f"{stats.overlap_fraction:.6f} (delta {delta:.3g})")
        evs = trace["traceEvents"]
        reqs = sum(e.get("cat") == "request" for e in evs)
        depth = sum(e["ph"] == "C" and e["name"] == "queue_depth"
                    for e in evs)
        check(reqs > 0 and depth > 0, f"{what}: {reqs} engine request spans "
              f"and {depth} queue_depth samples")
        print(f"trace {what}: overlap {s['overlap_fraction']:.4f} (spans) "
              f"vs {stats.overlap_fraction:.4f} (TierStats), {reqs} request "
              f"spans, {depth} queue_depth samples, {len(evs)} events")

        # ---- (d) the report ------------------------------------------------
        env = dict(PYTHONPATH=str(ROOT / "src"), PATH="/usr/bin:/bin")
        for name in ("a", "c"):
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.obs", "report",
                 str(tmp / f"{name}.json"), "--top", "5"],
                capture_output=True, text=True, env=env, check=True)
            print(f"trace ({name}) report:")
            print(r.stdout.rstrip())
    print(f"trace phase: {time.perf_counter() - t_phase:.1f} s on {card}")


def host_link(dev) -> dict:
    """GB/s of a 1 GiB copy to and from the card, from pinned and from
    pageable host memory: the bound of the tiered swaps."""
    n = (1 << 30) // 4
    d = torch.empty(n, dtype=torch.int32, device=dev)
    rates = {}
    for kind, pin in (("pinned", True), ("pageable", False)):
        h = torch.ones(n, dtype=torch.int32, pin_memory=pin)
        h2d = cuda_ms(lambda: d.copy_(h, non_blocking=pin), 3)
        d2h = cuda_ms(lambda: h.copy_(d, non_blocking=pin), 3)
        rates[kind] = (2**30 / h2d / 1e6, 2**30 / d2h / 1e6)
        print(f"host link, 1 GiB {kind}: H2D {h2d:.3f} ms "
              f"({rates[kind][0]:.2f} GB/s), D2H {d2h:.3f} ms "
              f"({rates[kind][1]:.2f} GB/s)")
        del h
    return rates


def host_room(path: Path) -> tuple:
    """(free host RAM, free disk under ``path``, its filesystem type)."""
    avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    disk = shutil.disk_usage(path).free
    fs = subprocess.run(["stat", "-f", "-c", "%T", str(path)],
                        capture_output=True, text=True).stdout.strip()
    return avail, disk, fs


def declared_bytes(lo, driver: str, v: int) -> tuple:
    """The closed form of a PSRS run's measured swaps: (h2d, d2h) bytes,
    each superstep's declared fields (sliced) or live context (otherwise)
    for every context."""
    if driver != "sliced":
        return (len(PSRS_DECLARED) * v * lo.live_bytes,) * 2
    return tuple(v * sum(lo.field_bytes(f) for rw in PSRS_DECLARED
                         for f in rw[i]) for i in (0, 1))


def modeled(led) -> dict:
    return {key: val for key, val in led.snapshot().items()
            if key.split(".", 1)[1] not in MEASURED}


def tiered_staged(dev, kern, keys, ref_cpu, v, tier, driver, path,
                  P: int = 1, io_driver=None, cap=TIER_CAP):
    """One PSRS plan with its population in ``tier``, stage by stage (host
    clock, synchronised at each stage's end), every kernel count reset
    just before it and the local sort and merge kernels required after it.
    Returns ``(pems, {stage: ms}, launches, peak device bytes)``."""
    from repro_torch.pems_apps import psrs_plan
    n_v = keys.numel() // v
    set_counts(kern)
    torch.cuda.synchronize()
    reset_peak()
    pems, load, steps, extract = psrs_plan(
        v, n_v, k=TIER_K, P=P, driver=driver, tier=tier, backing_path=path,
        io_driver=io_driver, device_cap_bytes=cap, device=dev)
    ms = {}
    store = None
    for name, fn in [("load", lambda _: load(keys.reshape(v, n_v)))] \
            + list(steps):
        t0 = time.perf_counter()
        store = fn(store)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
    result, rcount, oflow = extract(store)
    launches = read_counts(kern, ("radix_sort", "kway_splitters",
                                  "kway_merge_segments"))
    peak = torch.cuda.max_memory_allocated()
    what = f"tiered {tier} {driver} P={P} io={io_driver}"
    check(int(oflow.sum()) == 0, f"{what}: no overflow")
    counts = rcount[:, 0].tolist()
    out = torch.cat([result[i, :counts[i]] for i in range(v)])
    check(out.device.type == "cpu", f"{what}: the result is a CPU tensor")
    check(torch.equal(out, ref_cpu), f"{what}: output == torch.sort")
    check(all(c > 0 for c in launches.values()),
          f"{what}: the local sort and merge kernels launched: {launches}")
    return pems, ms, launches, peak


def kernel_modules() -> dict:
    """The PSRS kernels' modules by name: each package re-exports a
    function of the module's own name, which an attribute import would pick
    instead."""
    return dict(zip(("bitonic", "kway", "deliver"), (
        importlib.import_module(f"repro_torch.kernels.{m}.{m}")
        for m in ("bitonic_sort", "kway_merge", "alltoallv_deliver"))))


def run_tiered(dev, args) -> None:
    """The backing tiers on the card: the host link, PSRS at full scale with
    its population in host memory and in a file (the device holding k
    contexts of v under an 8 GiB budget), and a matrix of tiers, drivers,
    real processors and I/O drivers at 2^20 keys."""
    import gc

    from repro_torch.pems_apps import psrs_plan, psrs_sort
    kern = kernel_modules()
    t_phase = time.perf_counter()
    TIER_DIR.mkdir(parents=True, exist_ok=True)
    link = host_link(dev)
    ram, disk, fs = host_room(TIER_DIR)
    print(f"tiered: free host RAM {ram / 2**30:.1f} GiB, free disk under "
          f"{TIER_DIR.relative_to(ROOT)} {disk / 2**30:.1f} GiB ({fs})")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 20)
    v = args.v

    # ---- full scale: 2^log_n keys, k = 2 of v = 16 on the card ----------
    log_n = args.log_n
    while True:
        lo = psrs_plan(v, (1 << log_n) // v, k=TIER_K, device=dev)[0].layout
        vmu = v * lo.mu_bytes
        # Host: the population, twice the round staging (pinned, rounded
        # to powers of two) and the Alltoallv's staging; disk: the file.
        if ram >= 2 * vmu + 16 * TIER_K * lo.mu_bytes and disk >= 1.2 * vmu:
            break
        log_n -= 1
        print(f"tiered: cut to 2^{log_n} keys (v·μ {vmu / 2**30:.2f} GiB "
              "does not fit the host's RAM or disk)")
    n = 1 << log_n
    keys = rand_int32((n,), gen)
    ref_cpu = torch.sort(keys).values.cpu()
    print(f"tiered: n=2^{log_n} v={v} k={TIER_K}, v·μ "
          f"{vmu / 2**30:.2f} GiB, device_cap_bytes {TIER_CAP / 2**30:.0f} "
          f"GiB")
    runs = [("host", "sliced", None), ("host", "sliced", None),
            ("host", "async", None), ("file", "async", "buffered")]
    device_led = {}
    for driver in ("sliced", "async"):
        _, dp = psrs_sort(keys, v=v, k=TIER_K, driver=driver, device=dev,
                          return_pems=True)
        device_led[driver] = modeled(dp.ledger)
        del dp
    torch.cuda.empty_cache()
    for i, (tier, driver, io_driver) in enumerate(runs):
        path = None if tier == "host" else str(TIER_DIR / f"full{i}.bin")
        t0 = time.perf_counter()
        pems, ms, launches, peak = tiered_staged(
            dev, kern, keys, ref_cpu, v, tier, driver, path,
            io_driver=io_driver)
        secs = time.perf_counter() - t0
        led, st = pems.ledger, pems.tier_stats
        what = f"tiered {tier} {driver} run {i}"
        check(modeled(led) == device_led[driver],
              f"{what}: modeled ledger == the device tier's")
        h2d, d2h = declared_bytes(lo, driver, v)
        check((led.h2d_bytes, led.d2h_bytes) == (h2d, d2h),
              f"{what}: h2d/d2h {led.h2d_bytes}/{led.d2h_bytes} == closed "
              f"form {h2d}/{d2h}")
        check(peak < vmu, f"{what}: peak device memory {peak} < v·μ {vmu}")
        print(f"{what}: {secs:.2f} s, stages ms " + ", ".join(
            f"{k} {t:.1f}" for k, t in ms.items())
            + f"; total {sum(ms.values()):.1f}")
        print(f"  launches {launches}; peak device "
              f"{peak / 2**30:.2f} GiB < v·μ {vmu / 2**30:.2f} GiB")
        print(f"  TierStats: rounds {st.rounds}, swap_in_s "
              f"{st.swap_in_s:.3f}, swap_out_s {st.swap_out_s:.3f}, "
              f"compute_s {st.compute_s:.3f}, stall_s {st.stall_s:.3f}, "
              f"overlap_fraction {st.overlap_fraction:.3f}, "
              f"peak_stage_bytes {st.peak_stage_bytes}, "
              f"merge_prefetch_events {st.merge_prefetch_events}")
        print(f"  swaps: h2d {led.h2d_bytes / 2**30:.2f} GiB in "
              f"{st.swap_in_s:.3f} s ({led.h2d_bytes / st.swap_in_s / 1e9:.2f}"
              f" GB/s, pinned link {link['pinned'][0]:.2f}), d2h "
              f"{led.d2h_bytes / 2**30:.2f} GiB in {st.swap_out_s:.3f} s "
              f"({led.d2h_bytes / st.swap_out_s / 1e9:.2f} GB/s, pinned "
              f"link {link['pinned'][1]:.2f}); disk read "
              f"{led.disk_read_bytes / 2**30:.2f} GiB, written "
              f"{led.disk_write_bytes / 2**30:.2f} GiB")
        if tier == "file":
            print(f"  io driver {pems.backing.file.driver} (fallback "
                  f"{pems.backing.file.fallback}) on {fs}")
            pems.backing.close()
            Path(path).unlink()
        del pems
        gc.collect()
    del keys, ref_cpu
    torch.cuda.empty_cache()

    # ---- matrix at 2^20 keys --------------------------------------------
    t0 = time.perf_counter()
    m = 1 << min(20, args.log_n)
    mk = rand_int32((m,), gen)
    mref = torch.sort(mk).values.cpu()
    disk_bytes = {}
    matrix = [(t, d, P, None) for t in ("host", "memmap", "file")
              for d in ("explicit", "sliced", "async") for P in (1, TIER_P)]
    matrix += [("file", "sliced", 1, io) for io in IO_NAMES]
    for j, (tier, driver, P, io) in enumerate(matrix):
        path = None if tier == "host" else str(TIER_DIR / f"m{j}.bin")
        pems = tiered_staged(dev, kern, mk, mref, v, tier, driver, path,
                             P=P, io_driver=io, cap=None)[0]
        led = pems.merged_shard_ledger()
        disk_bytes[(tier, driver, P, io)] = (led.disk_read_bytes,
                                             led.disk_write_bytes,
                                             led.h2d_bytes, led.d2h_bytes)
        if io is not None:
            print(f"tiered 2^20 file io_driver={io}: ran "
                  f"{pems.backing.file.driver} (fallback "
                  f"{pems.backing.file.fallback}) on {fs}")
        if tier != "host":
            getattr(pems.backing, "close", lambda: None)()
            for f in TIER_DIR.glob(f"m{j}.bin*"):
                f.unlink()
        del pems
    for tier, driver, P, io in matrix:
        if P > 1:
            check(disk_bytes[(tier, driver, P, io)]
                  == disk_bytes[(tier, driver, 1, io)],
                  f"2^20 {tier} {driver}: P={P} merged shard disk and swap "
                  f"bytes == P=1's")
    print(f"tiered matrix at 2^20 ({len(matrix)} runs: tier x driver x "
          f"P in (1, {TIER_P}), io drivers): passed in "
          f"{time.perf_counter() - t0:.2f} s")
    print(f"tiered phase: {time.perf_counter() - t_phase:.2f} s")


# --------------------------------------------------------------------------- #
# The recovery phase: psrs_run_recoverable on the file tier, killed and       #
# resumed.                                                                    #
# --------------------------------------------------------------------------- #

# Where the recoverable runs keep their state dirs (inside the checkout,
# git-ignored), and the small legs' key count.
RECOVERY_DIR = ROOT / "build" / "recovery"
RECOVERY_SMALL_LOG_N = 20
# The full-width legs' key count: half the tiered phase's 2^27, which made
# room for phase 10b in the script's time limit.
RECOVERY_LOG_N = 26


class RecoveryClock:
    """Host-clock seconds of a recoverable run's durable-state work, by
    wrapping the functions that do it: stage snapshots (save and load),
    cursor writes, commit flushes, checksum recomputes and every CRC call
    (seconds and bytes hashed, from every thread), and each stage's wall
    time from its in-progress mark to its commit (synchronised with the
    card before the commit is read).  ``restore()`` puts them back."""

    def __init__(self):
        import threading

        from repro_torch.core import FileBacking, SuperstepCursor
        from repro_torch.io import checksum
        from repro_torch.pems_apps import psrs
        self.secs = dict.fromkeys(("snapshot_save", "snapshot_load",
                                   "cursor", "commit_flush", "recompute",
                                   "crc"), 0.0)
        self.crc_bytes = 0
        self.stages = {}
        self._lock = threading.Lock()
        self._open = {}
        self._saved = []
        crc = checksum.crc_bytes

        def counted_crc(buf):
            t0 = time.perf_counter()
            out = crc(buf)
            dt = time.perf_counter() - t0
            with self._lock:
                self.secs["crc"] += dt
                self.crc_bytes += memoryview(buf).nbytes
            return out

        self._patch(checksum, "crc_bytes", counted_crc)
        for name, key in (("_save_snapshot", "snapshot_save"),
                          ("_load_snapshot", "snapshot_load")):
            self._patch(psrs, name, self._timed(getattr(psrs, name), key))
        self._patch(FileBacking, "flush",
                    self._timed(FileBacking.flush, "commit_flush"))
        self._patch(FileBacking, "recompute_checksums",
                    self._timed(FileBacking.recompute_checksums,
                                "recompute"))
        self._patch(SuperstepCursor, "note_round",
                    self._timed(SuperstepCursor.note_round, "cursor"))
        mark_in, mark_done = (SuperstepCursor.mark_in_progress,
                              SuperstepCursor.mark_completed)
        clock = self

        def mark_in_progress(cur, stage, name=None):
            t0 = time.perf_counter()
            mark_in(cur, stage, name)
            t1 = time.perf_counter()
            clock.secs["cursor"] += t1 - t0
            clock._open[(cur.path, stage)] = t1

        def mark_completed(cur, stage, name=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mark_done(cur, stage, name)
            clock.secs["cursor"] += time.perf_counter() - t0
            start = clock._open.pop((cur.path, stage))
            clock.stages[name] = clock.stages.get(name, 0.0) + t0 - start

        self._patch(SuperstepCursor, "mark_in_progress", mark_in_progress)
        self._patch(SuperstepCursor, "mark_completed", mark_completed)

    def _patch(self, owner, name, fn):
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    def _timed(self, fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.secs[key] += time.perf_counter() - t0
        return run

    def restore(self) -> None:
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)

    def report(self) -> dict:
        return {"stages_s": self.stages, "durable_s": self.secs,
                "crc_bytes": self.crc_bytes}


def recovery_keys(spec: dict, dev):
    """A leg's keys, made on ``dev`` from its seed: the parent and its
    children draw the same keys."""
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    return rand_int32((1 << spec["log_n"],), gen)


def recovery_run(spec: dict, keys, clock: bool):
    """One ``psrs_run_recoverable`` call as ``spec`` describes it, on the
    device of ``keys``; returns ``(out, pems, report)``, the report with the run's
    seconds, launches, peak device memory and, with ``clock``, its
    durable-state seconds."""
    from repro_torch.pems_apps import psrs_plan, psrs_run_recoverable
    kern = kernel_modules()
    v, k = spec["v"], spec["k"]
    fault = spec.get("fault_spec")
    if fault and "{result}" in fault:
        # 4 bytes in the middle of shard row 0's result field (2n/v words,
        # 16 checksum segments here): under the sliced driver only the
        # merge stage writes its checksum segment.
        lo = psrs_plan(v, keys.numel() // v, k=k,
                       device="cpu")[0].layout
        at = (lo.offset("result") + lo.field_words("result") // 2) * 4
        fault = fault.replace("{result}", f"{at}-{at + 3}")
    rc = RecoveryClock() if clock else None
    set_counts(kern)
    torch.cuda.synchronize()
    reset_peak()
    t0 = time.perf_counter()
    try:
        out, pems = psrs_run_recoverable(
            keys, v=v, k=k, P=spec.get("P", 1), state_dir=spec["state_dir"],
            tier="file", driver=spec.get("driver", "async"),
            io_driver=spec.get("io_driver", "buffered"), fault_spec=fault,
            checksums=spec.get("checksums", True),
            io_retries=spec.get("io_retries"),
            device_cap_bytes=spec.get("cap"),
            crash_in_stage=spec.get("crash_in"),
            crash_after_stage=spec.get("crash_after"),
            device=keys.device, return_pems=True)
        torch.cuda.synchronize()
    finally:
        if rc is not None:
            rc.restore()
    led = pems.merged_shard_ledger()
    rep = {"wall_s": time.perf_counter() - t0,
           "launches": read_counts(kern, ("radix_sort", "kway_splitters",
                                          "kway_merge_segments")),
           "peak": torch.cuda.max_memory_allocated(),
           "rounds": [s.rounds for s in pems.shard_stats],
           "tier": pems.merged_shard_stats().as_dict(),
           "disk_gib": [led.disk_read_bytes / 2**30,
                        led.disk_write_bytes / 2**30]}
    if rc is not None:
        rep.update(rc.report())
    return out, pems, rep


def recovery_child(spec: dict) -> int:
    """A leg of the recovery phase in a process of its own: sort its keys
    recoverably (killed by the run's own hooks or faults where the leg asks
    for it), check the output against ``torch.sort`` and print
    ``RECOVERY_CHILD <json>`` with what the parent checks."""
    from repro_torch.io import collect_findings
    keys = recovery_keys(spec, torch.device("cuda"))
    ref = torch.sort(keys).values.cpu()
    out, pems, rep = recovery_run(spec, keys, spec.get("clock", False))
    check(torch.equal(out, ref), f"recovery leg {spec['name']}: output == "
          "torch.sort")
    shards = getattr(pems.backing, "shards", None) or [pems.backing]
    files = [s.file for s in shards]
    rep.update(
        name=spec["name"],
        injected=[dict(getattr(f, "injected", {})) for f in files],
        retries=[s.engine.retries for s in shards],
        permanent_errors=[s.engine.permanent_errors for s in shards],
        findings=[x.format() for x in collect_findings(pems.backing)],
        tracked=[getattr(f, "tracked", 0) for f in files],
        driver=[f.driver for f in files],
        cursors=[c.state() for c in pems.cursors],
        out_sum=int(out.to(torch.int64).sum()))
    print("RECOVERY_CHILD " + json.dumps(rep), flush=True)
    return 0


def spawn_leg(spec: dict):
    """Run one leg in a child (``sys.executable``, ``PYTHONPATH=src``);
    returns ``(returncode, its RECOVERY_CHILD report or None, stderr)``."""
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                        "--recovery-child", json.dumps(spec)],
                       capture_output=True, text=True, env=child_env(),
                       cwd=ROOT, timeout=900)
    rep = None
    for line in r.stdout.splitlines():
        if line.startswith("RECOVERY_CHILD "):
            rep = json.loads(line.split(" ", 1)[1])
    return r.returncode, rep, r.stderr


def leg_killed(spec: dict) -> None:
    import signal
    rc, _, err = spawn_leg(spec)
    check(rc == -signal.SIGKILL, f"recovery leg {spec['name']}: died by "
          f"SIGKILL (exit {rc}; {err[-2000:]})")


def leg_ok(spec: dict) -> dict:
    rc, rep, err = spawn_leg(spec)
    check(rc == 0 and rep is not None, f"recovery leg {spec['name']}: "
          f"completed (exit {rc}; {err[-2000:]})")
    return rep


def small_legs(base: dict) -> list:
    """The small matrix, as chains of legs: each chain's legs share one
    state dir and run one after another; the chains run side by side.
    Returns ``[(chain name, [(spec, expect 'killed' or 'ok')])]``."""
    def leg(name, sd, **kw):
        return dict(base, name=name, state_dir=str(RECOVERY_DIR / sd), **kw)

    chains = []
    for kind in ("in", "after"):
        legs = [(leg(f"buffered {kind} {i}", f"b_{kind}",
                     **{f"crash_{kind}": i}), "killed") for i in range(8)]
        chains.append((f"buffered {kind}", legs + [
            (leg(f"buffered {kind} resume", f"b_{kind}"), "ok")]))
    for io, stage in (("odirect", "partition"), ("mmap", "merge")):
        chains.append((io, [
            (leg(f"{io} in {stage}", io, io_driver=io, crash_in=stage),
             "killed"),
            (leg(f"{io} resume", io, io_driver=io), "ok")]))
    # Rare enough that no request fails past its retries (0.005^4 a
    # request), frequent enough over some 10^4 requests to fire.
    chains.append(("eio", [(leg("faulty eio", "eio",
                                io_driver="faulty:buffered",
                                fault_spec="seed=5;eio@p0.005:x2",
                                io_retries=6), "ok")]))
    chains.append(("torn", [
        (leg("torn in load", "torn", io_driver="faulty:buffered",
             fault_spec="torn@wb0-4095:0.5", crash_in=0), "killed"),
        (leg("torn resume", "torn"), "ok")]))
    chains.append(("sanitize", [(leg("sanitize", "san",
                                     io_driver="sanitize:buffered"), "ok")]))
    chains.append(("shard", [
        (leg("P=2 shard 1 killed in merge", "shard", P=2, v=8,
             driver="sliced", io_driver="faulty:buffered",
             fault_spec="shard=1;kill@wb{result}"), "killed"),
        (leg("P=2 resume", "shard", P=2, v=8, driver="sliced"), "ok")]))
    return chains


def run_chains(chains) -> dict:
    """Chains of legs side by side, in threads that each wait on their
    children one after another; returns the completing legs' reports by
    name.  Every chain runs to its end before the first failure raises."""
    from concurrent.futures import ThreadPoolExecutor

    def chain(legs):
        reps = {}
        for spec, expect in legs:
            if expect == "killed":
                leg_killed(spec)
            else:
                reps[spec["name"]] = leg_ok(spec)
        return reps

    with ThreadPoolExecutor(max_workers=len(chains)) as pool:
        futs = [pool.submit(chain, legs) for _, legs in chains]
        reps = {}
        for f in futs:
            reps.update(f.result())
    return reps


def run_recovery(dev, args) -> None:
    """The recovery phase on the card: ``psrs_run_recoverable`` on the file
    tier at ``RECOVERY_LOG_N`` keys (the tiered phase's v, k and budget),
    (a)
    with checksums, (b) without, (c) killed by SIGKILL in the merge stage in
    a child, beside the small matrix of legs at 2^20 keys (each in a
    child), and (d) resumed in a fresh child."""
    import gc

    from repro_torch.pems_apps import psrs_plan, psrs_sort
    t_phase = time.perf_counter()
    shutil.rmtree(RECOVERY_DIR, ignore_errors=True)
    RECOVERY_DIR.mkdir(parents=True, exist_ok=True)
    try:
        ram, disk, fs = host_room(RECOVERY_DIR)
        v = args.v
        log_n = min(args.log_n, RECOVERY_LOG_N)
        while True:
            lo = psrs_plan(v, (1 << log_n) // v, k=TIER_K,
                           device=dev)[0].layout
            vmu = v * lo.mu_bytes
            # Disk: one state dir at a time (the file, its sidecar, a
            # snapshot); host: the round staging and the page cache's
            # working set.
            if disk >= 1.2 * vmu and ram >= 16 * TIER_K * lo.mu_bytes:
                break
            log_n -= 1
            print(f"recovery: cut to 2^{log_n} keys (v·μ "
                  f"{vmu / 2**30:.2f} GiB does not fit the host's disk)")
        print(f"recovery: n=2^{log_n} v={v} k={TIER_K}, v·μ "
              f"{vmu / 2**30:.2f} GiB on {fs}, free disk "
              f"{disk / 2**30:.1f} GiB, free host RAM {ram / 2**30:.1f} GiB")
        full = {"seed": args.seed + 20, "log_n": log_n, "v": v, "k": TIER_K,
                "cap": TIER_CAP, "driver": "async", "io_driver": "buffered"}
        keys = recovery_keys(full, dev)
        ref = torch.sort(keys).values.cpu()
        _, dp = psrs_sort(keys, v=v, k=TIER_K, driver="async", device=dev,
                          return_pems=True)
        device_led = modeled(dp.ledger)
        del dp
        torch.cuda.empty_cache()
        outs = {}
        for leg, checksums in (("a", True), ("b", False)):
            spec = dict(full, name=leg, checksums=checksums,
                        state_dir=str(RECOVERY_DIR / leg))
            out, pems, rep = recovery_run(spec, keys, clock=True)
            what = f"recovery ({leg}) checksums={checksums}"
            check(torch.equal(out, ref), f"{what}: output == torch.sort")
            check(modeled(pems.ledger) == device_led,
                  f"{what}: modeled ledger == the plain tiered run's (the "
                  "device tier's)")
            check(rep["peak"] < vmu, f"{what}: peak device memory "
                  f"{rep['peak']} < v·μ {vmu}")
            check(all(c > 0 for c in rep["launches"].values()),
                  f"{what}: the local sort and merge kernels launched")
            print_recovery(what, rep)
            outs[leg] = out
            pems.backing.close()
            del pems
            gc.collect()
            shutil.rmtree(RECOVERY_DIR / leg)
        check(torch.equal(outs["a"], outs["b"]), "recovery (a) == (b)")
        # (c): a child killed in merge, side by side with the small matrix
        # at 2^20 keys (each leg a child too), whose legs time nothing.
        spec = dict(full, name="c", checksums=True,
                    state_dir=str(RECOVERY_DIR / "cd"))
        base = {"seed": args.seed + 21, "log_n": RECOVERY_SMALL_LOG_N,
                "v": 16, "k": 2}
        chains = small_legs(base)
        t0 = time.perf_counter()
        reps = run_chains(chains + [("c", [(dict(spec, crash_in="merge"),
                                            "killed")])])
        print(f"recovery (c) killed in merge beside the small matrix at "
              f"2^{RECOVERY_SMALL_LOG_N} ({sum(len(c) for _, c in chains)} "
              f"legs in {len(chains)} chains): {time.perf_counter() - t0:.2f}"
              " s host clock, the children's starts included")
        t0 = time.perf_counter()
        rep = leg_ok(dict(spec, name="d", clock=True))
        print(f"recovery (d) resumed in a fresh process: "
              f"{time.perf_counter() - t0:.2f} s host clock, the child's "
              "start included")
        print_recovery("recovery (d) resume", rep)
        check(rep["out_sum"] == int(outs["a"].to(torch.int64).sum()),
              "recovery (d): its output sums as (a)'s")
        check(rep["launches"]["radix_sort"] == 0
              and rep["launches"]["kway_merge_segments"] == v // TIER_K,
              f"recovery (d): reran the merge alone ({rep['launches']})")
        check(rep["cursors"][0]["completed"] == 7,
              "recovery (d): the cursor committed the last stage")
        shutil.rmtree(RECOVERY_DIR / "cd")
        del keys, ref, outs
        torch.cuda.empty_cache()

        eio = reps["faulty eio"]
        check(eio["injected"][0]["eio"] > 0
              and eio["retries"] == [eio["injected"][0]["eio"]]
              and eio["permanent_errors"] == [0],
              f"recovery leg faulty eio: injected == retries, 0 permanent "
              f"({eio['injected']}, {eio['retries']})")
        san = reps["sanitize"]
        check(san["findings"] == [] and san["tracked"][0] > 0,
              f"recovery leg sanitize: no findings, tracked "
              f"{san['tracked']}")
        shard = reps["P=2 resume"]
        check(shard["rounds"] == [0, 8 // 2 // base["k"]],
              f"recovery leg P=2: only process 1 reran its stage "
              f"(rounds {shard['rounds']})")
        print(f"recovery small matrix at 2^{RECOVERY_SMALL_LOG_N}: every leg "
              f"passed ({len(reps)} completing children); eio injected "
              f"{eio['injected'][0]['eio']} = retries {eio['retries'][0]}; "
              f"sanitizer tracked {san['tracked'][0]}; P=2 resume rounds "
              f"{shard['rounds']}")
    finally:
        shutil.rmtree(RECOVERY_DIR, ignore_errors=True)
    print(f"recovery phase: {time.perf_counter() - t_phase:.2f} s")


def print_recovery(what: str, rep: dict) -> None:
    d, st = rep["durable_s"], rep["tier"]
    print(f"{what}: {rep['wall_s']:.2f} s host clock; stages s (in progress "
          "to commit) " + ", ".join(f"{k} {t:.2f}"
                                   for k, t in rep["stages_s"].items()))
    crc_rate = rep["crc_bytes"] / d["crc"] / 1e9 if d["crc"] else 0.0
    print(f"  durable state s: snapshot save {d['snapshot_save']:.2f}, "
          f"snapshot load {d['snapshot_load']:.2f}, cursor writes "
          f"{d['cursor']:.2f}, commit flushes {d['commit_flush']:.2f}, "
          f"checksum recompute {d['recompute']:.2f}; CRC "
          f"{rep['crc_bytes'] / 2**30:.2f} GiB hashed in {d['crc']:.2f} s "
          f"({crc_rate:.2f} GB/s, every thread)")
    print(f"  launches {rep['launches']}; peak device "
          f"{rep['peak'] / 2**30:.2f} GiB; disk read / written "
          f"{rep['disk_gib'][0]:.2f} / {rep['disk_gib'][1]:.2f} GiB")
    print(f"  TierStats: rounds {st['rounds']}, swap_in_s "
          f"{st['swap_in_s']:.3f}, swap_out_s {st['swap_out_s']:.3f}, "
          f"compute_s {st['compute_s']:.3f}, stall_s {st['stall_s']:.3f}, "
          f"merge_prefetch_events {st['merge_prefetch_events']}")


# --------------------------------------------------------------------------- #
# The other BSP apps and the collectives (phase 6d).                          #
# --------------------------------------------------------------------------- #

# The prefix sum's keys (the store 4 GiB), list ranking's elements (the
# store (4 + 6v)·n words, 12.5 GiB), the Euler tour's forest (the largest
# the packed 32-bit keys allow), the collectives' field words, and where
# the prefix sum's file backings go (inside the checkout, git-ignored).
APPS_PREFIX_LOG_N, APPS_LR_LOG_N = 29, 25
APPS_EULER_N, APPS_EULER_TREES = 46340, 4
APPS_COLL_WORDS = 1 << 20
APPS_DIR = ROOT / "build" / "apps"


def timed(fn):
    """``(fn()'s result, wall ms)``, synchronised at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def apps_prefix_sum(dev, args, gen) -> None:
    """The prefix sum of 2^29 full-range int32 keys (the sums wrap): the
    device tier (k = 4) under each driver, and k = 2 of v = 16 contexts on
    the card, under a budget that holds the async driver's three round
    blocks of them, on the host and file tiers, sliced and async."""
    import gc

    from repro_torch.pems_apps import prefix_sum
    n, v, k = 1 << APPS_PREFIX_LOG_N, args.v, args.k
    x = rand_int32((n,), gen)
    want = torch.cumsum(x.to(torch.int64), 0).to(torch.int32)
    swap, led2 = {}, {}
    for kk, driver in ([(k, d) for d in ("explicit", "sliced", "async")]
                       + [(TIER_K, "sliced"), (TIER_K, "async")]):
        reset_peak()
        (out, pems), ms = timed(lambda: prefix_sum(
            x, v=v, k=kk, driver=driver, return_pems=True, device=dev))
        peak = torch.cuda.max_memory_allocated()
        check(torch.equal(out, want),
              f"prefix_sum device k={kk} {driver} == torch.cumsum")
        if kk == k:
            swap[driver] = pems.ledger.swap_total
        else:
            led2[driver] = modeled(pems.ledger)
        mu = pems.layout.mu_bytes
        print(f"prefix_sum n=2^{APPS_PREFIX_LOG_N} v={v} k={kk} device "
              f"{driver}: {ms:.3f} ms wall, peak {peak / 2**30:.2f} GiB "
              f"(store {v * mu / 2**30:.2f} GiB), swap_total "
              f"{pems.ledger.swap_total / 2**30:.2f} GiB")
        del out, pems
    check(swap["sliced"] < swap["explicit"],
          f"prefix_sum: sliced swaps less than explicit ({swap})")
    # The least budget the async driver admits at k = 2: its input, output
    # and prefetched round blocks.
    cap = 3 * TIER_K * mu
    x_cpu, want_cpu = x.cpu(), want.cpu()
    del x, want
    torch.cuda.empty_cache()
    APPS_DIR.mkdir(parents=True, exist_ok=True)
    for tier in ("host", "file"):
        for driver in ("sliced", "async"):
            path = None if tier == "host" else str(APPS_DIR / "prefix.bin")
            reset_peak()
            (out, pems), ms = timed(lambda: prefix_sum(
                x_cpu, v=v, k=TIER_K, driver=driver, tier=tier,
                backing_path=path, device_cap_bytes=cap, return_pems=True,
                device=dev))
            peak = torch.cuda.max_memory_allocated()
            led, st = pems.ledger, pems.tier_stats
            what = f"prefix_sum {tier} {driver}"
            check(out.device.type == "cpu" and torch.equal(out, want_cpu),
                  f"{what} == torch.cumsum")
            check(modeled(led) == led2[driver],
                  f"{what}: modeled ledger == the device tier's")
            print(f"{what} (k={TIER_K} of {v}, cap {cap / 2**30:.2f} GiB): "
                  f"{ms:.3f} ms wall, h2d {led.h2d_bytes / 2**30:.2f} GiB in "
                  f"{st.swap_in_s:.3f} s "
                  f"({led.h2d_bytes / max(st.swap_in_s, 1e-9) / 1e9:.2f} "
                  f"GB/s), d2h {led.d2h_bytes / 2**30:.2f} GiB in "
                  f"{st.swap_out_s:.3f} s "
                  f"({led.d2h_bytes / max(st.swap_out_s, 1e-9) / 1e9:.2f} "
                  f"GB/s), disk read {led.disk_read_bytes / 2**30:.2f} GiB, "
                  f"written {led.disk_write_bytes / 2**30:.2f} GiB, "
                  f"overlap {st.overlap_fraction:.3f}, peak device "
                  f"{peak / 2**30:.2f} GiB")
            if tier == "file":
                pems.backing.close()
                Path(path).unlink()
            del out, pems
            gc.collect()


def lists_from_permutation(n: int, gen):
    """``tests/test_pems_apps.py``'s lists on the card: a seeded permutation
    cut at n/16 distinct random positions, each piece a list in permutation
    order ending in a self-loop.  Returns ``(succ, rank)``: the successor
    array and each element's exact rank (its hops to its list's end), from
    the construction in O(n)."""
    dev = gen.device
    perm = torch.randperm(n, generator=gen, device=dev)
    cuts = torch.randperm(n, generator=gen, device=dev)[:max(1, n // 16)]
    ends = torch.cat([torch.sort(cuts).values,
                      torch.tensor([n], device=dev)])
    pos = torch.arange(n, device=dev)
    end = ends[torch.searchsorted(ends, pos, right=True)]
    nxt = torch.clamp(pos + 1, max=n - 1)
    succ = torch.empty(n, dtype=torch.int64, device=dev)
    succ[perm] = torch.where(pos + 1 < end, perm[nxt], perm)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    rank[perm] = (end - 1 - pos).to(torch.int32)
    return succ.to(torch.int32), rank


def apps_list_rank(dev, args, gen, kern) -> list:
    """List ranking of 2^25 elements in n/16 lists, v = 16, k = 4: direct
    mode under each driver and indirect mode once; kernel 2 timed at both
    message shapes of the explicit run.  Returns rows 2r and 2a."""
    import collections

    import repro_torch.core.collectives as coll
    from repro_torch.pems_apps import list_rank
    dv = kern["deliver"]
    n, v, k = 1 << APPS_LR_LOG_N, args.v, args.k
    n_v = n // v
    rounds = math.ceil(math.log2(n))
    succ, want = lists_from_permutation(n, gen)
    store_b = (4 + 6 * v) * n * 4
    # Count kernel 2's launches by message width, and keep the last call
    # of each: after the run its operands still hold that exchange's input.
    by_ww, last = collections.Counter(), {}
    real = coll.deliver_words

    def spy(*a):
        by_ww[a[5]] += 1
        last[a[5]] = a
        return real(*a)

    rows = []
    for driver, mode in (("explicit", "direct"), ("sliced", "direct"),
                         ("async", "direct"), ("explicit", "indirect")):
        by_ww.clear()
        last.clear()
        set_counts(kern)
        coll.deliver_words = spy
        reset_peak()
        try:
            (rank, pems), ms = timed(lambda: list_rank(
                succ, v=v, k=k, driver=driver, mode=mode, return_pems=True,
                device=dev))
        finally:
            coll.deliver_words = real
        peak = torch.cuda.max_memory_allocated()
        what = f"list_rank n=2^{APPS_LR_LOG_N} v={v} k={k} {driver} {mode}"
        check(torch.equal(rank, want), f"{what}: ranks exact")
        launches = dv.LAUNCHES
        expect = 2 * rounds if mode == "direct" else 0
        check(launches == expect and sum(by_ww.values()) == launches,
              f"{what}: kernel 2 launched {launches} times ({dict(by_ww)}),"
              f" 2·⌈log₂ n⌉ = {expect} expected")
        print(f"{what}: {ms:.3f} ms wall, {ms / rounds:.3f} ms a round "
              f"({rounds} rounds), kernel 2 launches {launches} "
              f"(by message words {dict(by_ww)}), peak device "
              f"{peak / 2**30:.2f} GiB against the store's "
              f"{store_b / 2**30:.2f} GiB")
        if driver == "explicit" and mode == "direct":
            for tag, ww, what_ in (("2r", n_v, "requests"),
                                   ("2a", 2 * n_v, "answers")):
                rows.append(deliver_row(dv, last[ww], tag, what_,
                                        by_ww[ww], args.reps))
        del rank, pems
        last.clear()
        torch.cuda.empty_cache()
    return rows


def deliver_row(dv, call, tag: str, what: str, launches: int, reps: int):
    """Kernel 2 on list ranking's last ``what`` exchange as the main path
    gave it (counts transposed, no fill: whole lanes move), against its
    plain version, timed beside it and its bound."""
    src, src_off, dst, dst_off, v, ww = call[:6]
    cp, cp_off, ct, ct_off = call[9:13]
    check(call[8] is None, f"kernel 2 {what}: no fill")

    def run(fn):
        return lambda: fn(*call[:6], None, 0, None, cp, cp_off, ct, ct_off)

    run(dv.deliver_words)()
    got = dst[:, dst_off:dst_off + v * ww].clone()
    got_ct = ct[:, ct_off:ct_off + v].clone()
    run(dv.deliver_words_plain)()
    err = max(same(got, dst[:, dst_off:dst_off + v * ww], f"kernel 2 {what}"),
              same(got_ct, ct[:, ct_off:ct_off + v], f"kernel 2 {what} ct"))
    del got, got_ct
    b_ms, b_by = bound(4 * (2 * v * v * ww + 2 * v * v))
    # The one PyTorch call computing the same function (no fill): the
    # transposed copy of the messages.
    msgs = src[:, src_off:src_off + v * ww].unflatten(1, (v, ww))
    row = dict(
        name=f"alltoallv_deliver_{what}", route="cuda",
        source="src/repro_torch/csrc/alltoallv_deliver.cu",
        replaces="src/repro/kernels/alltoallv_deliver/"
                 "alltoallv_deliver.py:79",
        launches=launches, max_abs_err=err,
        ms=cuda_ms(run(dv.deliver_words), reps),
        plain_ms=cuda_ms(run(dv.deliver_words_plain), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: msgs.transpose(0, 1).contiguous(), reps),
        shape=f"row {tag}, list ranking's {what}: v={v}, ww={ww} int32 "
              "words, counts transposed, no fill")
    print(f"kernel {row['name']} ({tag}) {row['shape']}: {row['ms']:.4f} ms, "
          f"launches {launches}, plain {row['plain_ms']:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}), library {row['library_ms']:.4f} ms")
    return row


def forest(n: int, trees: int, seed: int):
    """``benchmarks/bench_euler.py``'s forest: roots 0..trees-1, node i's
    parent uniform below i."""
    import numpy as np
    rng = np.random.default_rng(seed)
    parent = np.arange(n)
    parent[trees:] = rng.integers(0, np.arange(trees, n))
    return parent


def dfs_tours(parent) -> list:
    """Each tree's Euler tour by a numpy-side DFS, children in index order:
    a list of edge-id arrays (down 2i, up 2i + 1), one a root."""
    import numpy as np
    n = len(parent)
    nonroot = np.flatnonzero(parent != np.arange(n))
    order = nonroot[np.argsort(parent[nonroot], kind="stable")]
    start = np.searchsorted(parent[order], np.arange(n + 1))
    tours = []
    for r in np.flatnonzero(parent == np.arange(n)):
        tour, stack = [], [(r, start[r])]
        while stack:
            u, i = stack[-1]
            if i < start[u + 1]:
                c = order[i]
                stack[-1] = (u, i + 1)
                tour.append(2 * c)
                stack.append((c, start[c]))
            else:
                stack.pop()
                if stack:
                    tour.append(2 * u + 1)
        tours.append(np.asarray(tour, np.int64))
    return tours


def apps_euler(dev, args, kern) -> None:
    """The Euler tour of a 46,340-node forest of 4 trees, v = 16, k = 4:
    equal to the CPU run bit for bit, each tree's edges in DFS order, and
    every kernel of its PSRS and list ranking launched."""
    import numpy as np

    from repro_torch.pems_apps import euler_tour
    parent = forest(APPS_EULER_N, APPS_EULER_TREES, args.seed)
    set_counts(kern)
    res, ms = timed(lambda: euler_tour(parent, v=args.v, k=args.k,
                                       device=dev))
    launches = read_counts(kern, ("radix_sort", "kway_splitters",
                                  "kway_merge_segments",
                                  "alltoallv_deliver"))
    t0 = time.perf_counter()
    ref = euler_tour(parent, v=args.v, k=args.k, device="cpu")
    cpu_s = time.perf_counter() - t0
    for key, want in ref.items():
        check(torch.equal(res[key].cpu(), want),
              f"euler_tour {key}: card == CPU")
    check(all(c > 0 for c in launches.values()),
          f"euler_tour: kernels 1, 3s, 3m and 2 launched: {launches}")
    rank = res["rank"].cpu().numpy()
    for tour in dfs_tours(parent):
        check((rank[tour] == np.arange(len(tour) - 1, -1, -1)).all(),
              "euler_tour: each tree's ranks count down its DFS tour")
    print(f"euler_tour n={APPS_EULER_N} trees={APPS_EULER_TREES} "
          f"v={args.v} k={args.k}: {ms:.3f} ms wall on the card "
          f"({cpu_s:.2f} s on the CPU), launches {launches}")


def plain_reduce(op: str, x: torch.Tensor) -> torch.Tensor:
    """The reduction over axis 0, plainly: integers widened to int64 (uint32
    words as their unsigned values) and cut back to 32 bits, float32 summed
    in float64."""
    if x.dtype == torch.float32:
        if op == "add":
            return x.to(torch.float64).sum(0).to(torch.float32)
        return getattr(x, "a" + op)(0)
    wide = x.view(torch.int32).to(torch.int64)
    if x.dtype == torch.uint32:
        wide = wide & 0xFFFFFFFF
    red = wide.sum(0) if op == "add" else getattr(wide, "a" + op)(0)
    red = (red & 0xFFFFFFFF) - ((red & 0x80000000) << 1)   # the low word
    return red.to(torch.int32).view(x.dtype)


def apps_collectives(dev, args, gen) -> None:
    """allgather, reduce (add, max, min; root 3) and allreduce at v = 16 on
    fields of 2^20 words in int32, uint32 (half past 2^31) and float32: on
    the device tier at P = 1 and P = 4 (a one-card mesh) and on the host
    tier (P = 1, and P = 4 writing shards 1 and 3 alone), each beside the
    same calls on the CPU, whose ledger it must equal."""
    from repro_torch.core import ContextLayout, Pems, PemsConfig, make_mesh
    v, w, root = args.v, APPS_COLL_WORDS, 3
    configs = [("device", 1, None), ("device", MESH_P, None),
               ("host", 1, None), ("host", MESH_P, [1, 3])]
    calls = [("allgather", ("x", "g"), {})]
    for op in ("add", "max", "min"):
        calls += [("reduce", ("x", "o"), dict(op=op, root=root)),
                  ("allreduce", ("x", "o"), dict(op=op))]
    ms = {}
    for dtype in (torch.int32, torch.uint32, torch.float32):
        if dtype == torch.float32:
            x = torch.randn((v, w), generator=gen, device=dev)
        else:
            x = rand_int32((v, w), gen).view(dtype)
        lo = (ContextLayout().add("x", (w,), dtype).add("o", (w,), dtype)
              .add("g", (v, w), dtype))
        device_out = None               # the device tier P = 1's outputs
        for tier, P, procs in configs:
            cfg = f"{tier} P={P}" + (f" procs {procs}" if procs else "")
            ledgers, outs = [], []
            for leg, where in (("card", dev), ("cpu", torch.device("cpu"))):
                mesh = (make_mesh(P, device=where)
                        if tier == "device" and P > 1 else None)
                pems = Pems(PemsConfig(v=v, k=2, P=P, tier=tier), lo,
                            mesh=mesh, device=where)
                store = pems.init().with_field("x", x.to(where))
                for i, (name, a, kw) in enumerate(calls):
                    kw = dict(kw, procs=procs) if procs else kw
                    store, t = timed(lambda: getattr(pems, name)(
                        store, *a, **kw))
                    if leg == "cpu":
                        continue
                    ms.setdefault(f"{cfg} {name}", []).append(t)
                    # A copy: the next call rewrites the field in place.
                    got = store.field(a[1]).to(dev, copy=True)
                    coll_check(f"{name} {kw} {dtype} {cfg}", x, name, kw,
                               got, procs and (v // P, procs),
                               None if device_out is None else device_out[i])
                    if device_out is None:
                        outs.append(got)
                ledgers.append(pems.ledger.snapshot())
                del store, pems
            check(ledgers[0] == ledgers[1],
                  f"collectives {dtype} {cfg}: ledger == the CPU run's")
            if device_out is None:
                device_out = outs
        del device_out, outs
    print("collectives at v=16 on 2^20-word fields, ms a call over int32, "
          "uint32 and float32 (median, min, max):")
    for key, t in ms.items():
        print(f"  {key}: {statistics.median(t):.3f} ({min(t):.3f}, "
              f"{max(t):.3f})")


def coll_check(what, x, name, kw, got, shards, device_got) -> None:
    """One collective's output field against the plain reference; on the
    host tier against the device tier's too, bit for bit.  Under
    ``shards = (m, procs)`` only the listed processes' rows are written,
    and every other row keeps its zeros.  A float32 sum is held within
    1e-6 of the sum of its terms' magnitudes: 16 float32 additions in any
    order stay within 15·2^-24 of it."""
    v = x.shape[0]
    rows = range(v)
    if shards:
        m, procs = shards
        rows = [r for p in procs for r in range(p * m, (p + 1) * m)]
        for r in set(range(v)) - set(rows):
            check(not bool(got[r].view(torch.int32).any()),
                  f"{what}: row {r} of an unlisted shard untouched")
    if name == "allgather":
        want = x[None].expand(v, *x.shape)
    else:
        want = plain_reduce(kw["op"], x)[None].expand_as(x)
    if name == "reduce":
        rows = [r for r in rows if r == kw["root"]]
    for r in rows:
        if x.dtype == torch.float32 and kw.get("op") == "add":
            err = float(((got[r] - want[r]).abs()
                         / x.abs().sum(0)).max())
            check(err <= 1e-6, f"{what} row {r}: error {err:.3g} of the "
                               "terms' magnitudes")
        else:
            check(torch.equal(got[r].view(torch.int32),
                              want[r].reshape(got[r].shape).view(
                                  torch.int32)),
                  f"{what} row {r} == the plain reference")
        if device_got is not None:
            check(torch.equal(got[r].view(torch.int32),
                              device_got[r].view(torch.int32)),
                  f"{what} row {r} == the device tier's, bit for bit")


def run_apps(dev, args) -> list:
    """Phase 6d: the prefix sum, list ranking, the Euler tour and the
    collectives allgather, reduce and allreduce; returns rows 2r and 2a."""
    kern = kernel_modules()
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 30)

    def lap(name, t0):
        torch.cuda.empty_cache()
        print(f"apps {name}: {time.perf_counter() - t0:.2f} s")
        return time.perf_counter()

    t0 = time.perf_counter()
    apps_prefix_sum(dev, args, gen)
    t0 = lap("prefix sum", t0)
    rows = apps_list_rank(dev, args, gen, kern)
    t0 = lap("list ranking", t0)
    apps_euler(dev, args, kern)
    t0 = lap("euler tour", t0)
    apps_collectives(dev, args, gen)
    lap("collectives", t0)
    print(f"apps phase: {time.perf_counter() - t_phase:.2f} s")
    return [{key: r[key] for key in r if key != "shape"} for r in rows]


# --------------------------------------------------------------------------- #
# The LM serving path: flash attention (qwen2) and the SSD scan (mamba2).     #
# --------------------------------------------------------------------------- #

# The serve path's shapes: requests, prompt tokens and generated tokens;
# recurrentgemma's prompt is longer than its 2048-token window.
REQUESTS, PROMPT_LEN, GEN_LEN = 8, 1024, 64
HYBRID_PROMPT_LEN = 3072
# Flash attention edge shapes of tests/test_torch_flash_attention.py, in
# [B, S, H, d] terms: (b, hq, hkv, sq, sk, d); the last two are at qwen2's
# heads, a prefill and a decode call split over the keys.  Each is checked in
# fp32 and in bf16.
FLASH_EDGES = [(2, 2, 2, 16, 16, 16), (1, 4, 2, 13, 29, 16),
               (2, 6, 1, 1, 37, 32), (1, 12, 2, 24, 24, 16),
               (2, 2, 1, 5, 70, 16), (2, 6, 2, 16, 32, 16),
               (2, 12, 2, 70, 150, 128), (2, 12, 2, 1, 1062, 128)]
# Flash edge shapes under the prefix-LM mask (paligemma's patches), (b, hq,
# hkv, sq, sk, d): small heads, arctic's GQA group of 7 (56 query heads over
# 8), paligemma's group of 8 at head dim 256 in a prefill and a decode call;
# each with prefixes of 1, 37 (inside a key tile) and 70 (past one), alone
# and with a window of 16.
FLASH_PREFIX_EDGES = [(2, 4, 2, 70, 90, 16), (2, 56, 8, 70, 80, 128),
                      (2, 8, 1, 100, 110, 256), (2, 8, 1, 1, 300, 256)]
# Windowed flash edge shapes, (b, hq, hkv, sq, sk, d): recurrentgemma's heads
# (10 of 256 over one KV head) in a prefill and a decode call, and smaller
# ones; each is called with windows of 1, 16 and 100 (fp32 and bf16).
FLASH_WINDOW_EDGES = [(2, 4, 1, 70, 90, 256), (1, 10, 1, 1, 300, 256),
                      (1, 10, 1, 4, 110, 256), (2, 6, 2, 33, 80, 64),
                      (1, 2, 2, 40, 40, 16)]
# LRU edge shapes of tests/test_torch_lru_scan.py and the model's width:
# (b, s, d); one chunk of kernel 7's chunked scan (lru_scan.CHUNK, 32
# steps) and a step past it; batch x width below ONE_PASS_CHANNELS (the
# chunked scan) and, the last, at or above it (the one-pass kernel).
LRU_EDGES = [(1, 1, 1), (2, 1, 64), (2, 37, 64), (1, 300, 100),
             (2, 37, 256), (3, 17, 2560), (2, 32, 64), (2, 33, 100),
             (8, 33, 2560)]
# SSD edge shapes of tests/test_torch_ssd_scan.py: (b, h, s, p, n).
# and mamba2's (N 128, P 64) at one kernel chunk (64 steps; 128 is built
# too) and one step past it.
SSD_EDGES = [(1, 1, 1, 16, 16), (2, 3, 37, 16, 16), (1, 2, 64, 32, 32),
             (2, 2, 50, 32, 32), (1, 2, 40, 64, 64), (1, 2, 45, 64, 128),
             (1, 2, 64, 64, 128), (1, 2, 65, 64, 128), (1, 2, 128, 64, 128),
             (1, 2, 129, 64, 128)]
# Both sides sum in fp32 and round once to bf16 (the kernel's P enters P·V as
# bf16 hi + lo, exact to about 2^-16 p): one bf16 ulp of |plain| (at most
# 2^-7 |plain|) apart, plus the fp32 sums' order near zero.
BF16_RTOL, BF16_ATOL = 2**-7, 2**-10
# fp16 the same way: one fp16 ulp (2^-10 |plain|) plus the fp32 sums' order
# near zero (tests/test_torch_flash_attention.py models both).
F16_RTOL, F16_ATOL = 2**-10, 2**-13
HALF_TOL = {torch.bfloat16: (BF16_RTOL, BF16_ATOL),
            torch.float16: (F16_RTOL, F16_ATOL)}
DTYPE_TAG = {torch.float32: "fp32", torch.bfloat16: "bf16",
             torch.float16: "fp16"}
FP32_ATOL = 1e-5     # only the order of the float sums differs
SSD_TOL = 1e-4       # |kernel - plain| <= 1e-4 (1 + |plain|), fp32
LRU_TOL = 1e-5       # |kernel - plain| <= 1e-5 (1 + |plain|), fp32


def close(got, want, rtol, atol, what: str) -> float:
    """max |got - want| over float tensors; fails unless every element is
    within ``atol + rtol * |want|``."""
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{what}: shapes {got.shape} vs "
                                   f"{want.shape}")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    check(ok and math.isfinite(err), f"{what}: max |kernel - plain| = {err}")
    return err


def flash_inputs(gen, b, sq, sk, hq, hkv, d, dtype):
    dev = gen.device
    return (torch.randn((b, sq, hq, d), generator=gen, device=dev).to(dtype),
            torch.randn((b, sk, hkv, d), generator=gen, device=dev).to(dtype),
            torch.randn((b, sk, hkv, d), generator=gen, device=dev).to(dtype))


def ssd_inputs(gen, b, h, s, p, n):
    dev = gen.device
    x = torch.randn((b, h, s, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, h, s), generator=gen, device=dev))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=dev))
    B, C = (torch.randn((b, s, n), generator=gen, device=dev) / n ** 0.5
            for _ in range(2))
    return x, dt, A, B, C


def lru_inputs(gen, b, s, d):
    """The model's operands: gates in (0.5, 0.999), inputs of unit scale."""
    dev = gen.device
    return (0.5 + 0.499 * torch.rand((b, s, d), generator=gen, device=dev),
            torch.randn((b, s, d), generator=gen, device=dev))


def flash_edge_checks(gen, fa, dtype, rtol: float, atol: float) -> int:
    """Flash attention against its plain version at ``FLASH_EDGES``,
    ``FLASH_WINDOW_EDGES`` and ``FLASH_PREFIX_EDGES`` in ``dtype`` (float32
    takes the FMA kernel, bfloat16 the tensor-core kernel): causal and not,
    ``sk_valid`` 0, 1 and sk/2 + 1, decode calls at ``q_offset``, windows
    of 1, 16 and 100, prefixes of 1, 37 and 70 alone and with a window.
    Returns the number of calls checked."""
    n = 0
    for b, hq, hkv, sq, sk, d in FLASH_EDGES:
        q, k, v = flash_inputs(gen, b, sq, sk, hq, hkv, d, dtype)
        calls = [dict(causal=c) for c in (True, False)]
        calls += [dict(causal=c, sk_valid=kv) for c in (True, False)
                  for kv in (0, 1, sk // 2 + 1)]
        calls += [dict(causal=True, sk_valid=pos + 1, q_offset=pos)
                  for pos in (0, sk // 3, sk - 1) if sq == 1]
        for kw in calls:
            close(fa.attend(q, k, v, **kw), fa.attend_plain(q, k, v, **kw),
                  rtol, atol, f"flash {dtype} {b, hq, hkv, sq, sk, d} {kw}")
            n += 1
    for b, hq, hkv, sq, sk, d in FLASH_WINDOW_EDGES:
        q, k, v = flash_inputs(gen, b, sq, sk, hq, hkv, d, dtype)
        for w in (1, 16, 100):
            calls = [dict(causal=False, sk_valid=sk - 3, q_offset=sk - sq)]
            calls += ([dict(causal=True, sk_valid=pos + 1, q_offset=pos)
                       for pos in (sk // 3, sk - 1)] if sq == 1 else
                      [dict(causal=True), dict(causal=True, q_offset=sk - sq)])
            for kw in calls:
                kw["window"] = w
                close(fa.attend(q, k, v, **kw), fa.attend_plain(q, k, v, **kw),
                      rtol, atol,
                      f"flash {dtype} {b, hq, hkv, sq, sk, d} {kw}")
                n += 1
    for b, hq, hkv, sq, sk, d in FLASH_PREFIX_EDGES:
        q, k, v = flash_inputs(gen, b, sq, sk, hq, hkv, d, dtype)
        for pre in (1, 37, 70):
            calls = ([dict(sk_valid=pos + 1, q_offset=pos)
                      for pos in (sk // 3, sk - 1)] if sq == 1 else
                     [dict(sk_valid=sq), dict(sk_valid=sk - 3,
                                              q_offset=sk - sq)])
            for kw in calls + [dict(c, window=16) for c in calls]:
                kw.update(causal=True, prefix=pre)
                close(fa.attend(q, k, v, **kw), fa.attend_plain(q, k, v, **kw),
                      rtol, atol,
                      f"flash {dtype} {b, hq, hkv, sq, sk, d} {kw}")
                n += 1
    return n


def lm_edge_checks(gen, fa, ss, ls) -> None:
    flash_edge_checks(gen, fa, torch.float32, 0, FP32_ATOL)
    for shape in SSD_EDGES:
        args = ssd_inputs(gen, *shape)
        y, s_fin = ss.ssd_scan_chunked(*args)
        y_p, s_p = ss.ssd_chunked_plain(*args, 128)
        close(y, y_p, SSD_TOL, SSD_TOL, f"ssd y {shape}")
        close(s_fin, s_p, SSD_TOL, SSD_TOL, f"ssd S_fin {shape}")
    # x, B and C as column slices of one projection whose rows are not
    # 16-byte aligned (the kernel's 4-byte copies), as the model slices them.
    b, h, s, p, n = 2, 3, 70, 64, 128
    x, dt, A, B, C = ssd_inputs(gen, b, h, s, p, n)
    proj = torch.zeros((b, s, h * p + 2 * n + 3), device=gen.device)
    proj[..., 1:1 + h * p] = x.transpose(1, 2).reshape(b, s, h * p)
    proj[..., 1 + h * p:1 + h * p + n] = B
    proj[..., 1 + h * p + n:1 + h * p + 2 * n] = C
    views = (proj[..., 1:1 + h * p].reshape(b, s, h, p).transpose(1, 2), dt,
             A, proj[..., 1 + h * p:1 + h * p + n],
             proj[..., 1 + h * p + n:1 + h * p + 2 * n])
    y, s_fin = ss.ssd_scan_chunked(*views)
    y_p, s_p = ss.ssd_chunked_plain(x, dt, A, B, C, 128)
    close(y, y_p, SSD_TOL, SSD_TOL, "ssd y, unaligned views")
    close(s_fin, s_p, SSD_TOL, SSD_TOL, "ssd S_fin, unaligned views")
    lengths = {s for _, s, _ in LRU_EDGES}
    check({ls.CHUNK, ls.CHUNK + 1} <= lengths,
          f"LRU_EDGES has lengths {ls.CHUNK} and {ls.CHUNK + 1} (CHUNK)")
    one_pass = [b * d >= ls.ONE_PASS_CHANNELS for b, _, d in LRU_EDGES]
    check(any(one_pass) and not all(one_pass),
          "LRU_EDGES takes both paths of kernel 7 (ONE_PASS_CHANNELS)")
    for b, s, d in LRU_EDGES:
        a, x = lru_inputs(gen, b, s, d)
        wide = torch.zeros((b, s, 2 * d), device=gen.device)   # strided a
        wide[..., d:] = a
        for args in ((a, x), (wide[..., d:], x)):
            h, h_fin = ls.lru_scan_chunked(*args)
            h_p, fin_p = ls.lru_chunked_plain(*args, 256)
            close(h, h_p, LRU_TOL, LRU_TOL, f"lru h {b, s, d}")
            close(h_fin, fin_p, LRU_TOL, LRU_TOL, f"lru h_fin {b, s, d}")
            check(torch.equal(h_fin, h[:, -1]),
                  f"lru {b, s, d}: h_fin is the last step's h, bit for bit")


def glue_check(dev, seed: int) -> None:
    """The models' glue around the kernels on the card, in float32 with TF32
    off: smoke-width prefill logits and greedy tokens equal the CPU's
    (paligemma with its 8 patch embeddings before the prompt; the MoE
    models' routing from the same float32 router logits)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("glue: float32, torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    for arch in ("qwen2-1.5b", "mamba2-130m", "recurrentgemma-2b",
                 "kimi-k2-1t-a32b", "arctic-480b", "paligemma-3b"):
        cfg = get_config(arch).smoke()
        params = init_params(cfg, torch.Generator().manual_seed(seed))
        gpu = Model(cfg, device=dev, params=params)
        cpu = Model(cfg, device="cpu", params=params)
        prompts = torch.randint(0, cfg.vocab, (4, 40),
                                generator=torch.Generator().manual_seed(seed))
        extra = ({"patches": torch.randn(
            (4, cfg.n_frontend_tokens, cfg.d_model),
            generator=torch.Generator().manual_seed(seed + 1))}
            if cfg.n_frontend_tokens else {})
        lg, _ = gpu.prefill({"tokens": prompts.to(dev),
                             **{k: t.to(dev) for k, t in extra.items()}},
                            gpu.init_cache(4, 64))
        lc, _ = cpu.prefill({"tokens": prompts, **extra},
                            cpu.init_cache(4, 64))
        err = close(lg.cpu(), lc, 1e-4, 1e-4, f"glue {cfg.name} prefill")
        tg = ServeEngine(gpu, max_seq=64).generate(prompts, steps=16,
                                                   extra_batch=extra)
        tc = ServeEngine(cpu, max_seq=64).generate(prompts, steps=16,
                                                   extra_batch=extra)
        check(torch.equal(tg.cpu(), tc), f"glue {cfg.name}: greedy tokens "
                                         "on the card == CPU")
        print(f"glue {cfg.name}: prefill logits max |gpu - cpu| = {err:.3g}, "
              "16 greedy tokens x 4 equal")


def serve_full(dev, arch: str, kernels: tuple, mods: dict, args,
               prompt_len: int = PROMPT_LEN, depth: int | None = None,
               after=None, changes: dict | None = None) -> dict:
    """Serve ``arch`` at full width (its config's dtype, bf16 unless
    ``changes``, fields replaced, say so; weights from the seed): a short
    warm-up, then the main run with every kernel's count (``mods``) set to 0
    just before it; each of ``mods[kernels]`` must have launched.  Checks
    the tokens and, on two prompts, the prefill logits with the kernels
    against the same model with their plain versions.  ``depth`` cuts the
    model to its first ``depth`` layers (``dataclasses.replace(cfg,
    n_layers=depth)``, printed); a patches model takes ``prompt_len``
    positions, its ``n_frontend_tokens`` random patch embeddings (from the
    seed) and the rest prompt tokens, through the engine's ``extra_batch``.
    ``after(model)``, if given, runs before the model is freed."""
    import repro_torch.models.blocks as blocks
    import repro_torch.models.layers as layers
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import attend_plain
    from repro_torch.kernels.lru_scan import lru_chunked_plain
    from repro_torch.kernels.ssd_scan import ssd_chunked_plain
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config(arch), **(changes or {}))
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    b, s, g = REQUESTS, prompt_len, GEN_LEN
    pre = cfg.n_frontend_tokens if cfg.frontend == "patches" else 0
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev, seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    eng = ServeEngine(model, max_seq=s + g + 8)
    cpu_gen = torch.Generator().manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab, (b, s - pre), generator=cpu_gen)
    patches = (torch.randn((b, pre, cfg.d_model), generator=cpu_gen)
               .to(dev, getattr(torch, cfg.dtype)) if pre else None)

    def extra(rows):
        return {"patches": patches[:rows]} if pre else {}

    eng.generate(prompts[:2, :64], steps=2, extra_batch=extra(2))  # warm-up
    torch.cuda.synchronize()
    for mod in mods.values():
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    out = eng.generate(prompts, steps=g, extra_batch=extra(b))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: mod.LAUNCHES for name, mod in mods.items()}
    launches = {name: counts[name] for name in kernels}
    peak = torch.cuda.max_memory_allocated()
    check(all(n > 0 for n in launches.values()),
          f"{arch}: {', '.join(kernels)} launched on the serve path "
          f"({counts})")
    check(out.shape == (b, g) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab, f"{arch}: {g} tokens per request")
    t = eng.timing

    # The same prefill with the kernels and with their plain versions.
    two = {"tokens": prompts[:2].to(dev), **extra(2)}
    lk, _ = model.prefill(two, model.init_cache(2, s))
    saved = layers.attend, blocks.ssd_scan_chunked, blocks.lru_scan_chunked
    layers.attend = attend_plain
    blocks.ssd_scan_chunked = (lambda *a, chunk: ssd_chunked_plain(*a, chunk))
    blocks.lru_scan_chunked = (lambda *a, chunk: lru_chunked_plain(*a, chunk))
    try:
        lp, _ = model.prefill(two, model.init_cache(2, s))
    finally:
        (layers.attend, blocks.ssd_scan_chunked,
         blocks.lru_scan_chunked) = saved
    check(bool(torch.isfinite(lk).all()) and lk.shape == (2, 1, cfg.vocab),
          f"{arch}: finite prefill logits")
    cos = torch.nn.functional.cosine_similarity(lk[:, 0], lp[:, 0], dim=-1)
    same_top = int((lk[:, 0].argmax(-1) == lp[:, 0].argmax(-1)).sum())
    check(bool((cos >= 0.99).all()), f"{arch}: prefill logits with the "
                                     f"kernels vs plain, cosine {cos.tolist()}")
    res = dict(arch=arch, params=n_params, launches=launches,
               prefill_ms=t["prefill_ms"],
               decode_ms=statistics.median(t["decode_ms"]),
               tok_s=b * g / ((t["prefill_ms"] + sum(t["decode_ms"])) / 1e3),
               wall_s=wall, peak_gib=peak / 2**30)
    cut = ("" if depth is None else
           f", depth cut to {depth} of {get_config(arch).n_layers} layers "
           f"(dataclasses.replace(cfg, n_layers={depth}))")
    if cfg.is_moe:   # the expert capacity of a prefill and a decode step
        from repro_torch.models.blocks import moe_groups
        cut += (f", expert capacity {moe_groups(cfg, b * s)[2]} prefill, "
                f"{moe_groups(cfg, b)[2]} decode")
    prompt = f"{pre} patches + {s - pre} tokens" if pre else f"{s}"
    print(f"serve {arch} ({n_params / 1e9:.3f} B params, {cfg.dtype}{cut}) "
          f"requests={b} prompt={prompt} generated={g}: prefill "
          f"{res['prefill_ms']:.3f} ms, "
          f"decode {res['decode_ms']:.3f} ms/step (median of {g}), "
          f"{res['tok_s']:.1f} generated tok/s, {wall:.3f} s host clock, "
          f"peak {res['peak_gib']:.2f} GiB, launches {counts}; prefill "
          f"logits vs plain: cosine {min(cos.tolist()):.6f}, "
          f"{same_top}/2 same top token")

    # The device's own time for the prefill and one decode step, against
    # the times above, which the host paces: the rest is the device idle.
    cache = model.init_cache(b, s + g + 8)
    x, prefix = model._embed_inputs({"tokens": prompts.to(dev), **extra(b)})
    pre_dev = stack_device_ms(model, x, cache, 0, prefix)
    dec_dev = stack_device_ms(model, model._embed(out[:, :1].to(dev)), cache,
                              s)
    del x
    for name, dev_ms, paced in (("prefill", pre_dev, res["prefill_ms"]),
                                ("decode step", dec_dev, res["decode_ms"])):
        busy = ("not measured (the host did not finish queueing first)"
                if dev_ms is None else
                f"{dev_ms[0]:.3f} ms on the device, busy "
                f"{dev_ms[0] / paced:.1%} of the {paced:.3f} ms the host "
                "paced; by layer kind " + ", ".join(
                    f"{k} {t:.3f} ms" for k, t in dev_ms[1].items()))
        print(f"serve {arch} {name}: {busy}")
    res.update(prefill_device_ms=None if pre_dev is None else pre_dev[0],
               decode_device_ms=None if dec_dev is None else dec_dev[0])
    if after is not None:
        after(model)
    del model, eng, cache
    torch.cuda.empty_cache()
    return res


# The MoE serving cells: each model cut to its first two layers at full
# width (kimi's dense first layer and one MoE layer; arctic's two MoE
# layers), and the dense-oracle check's tokens.
MOE_DEPTH = 2
MOE_ORACLE_TOKENS = 64


def moe_oracle_check(model) -> dict:
    """The capacity dispatch against the dense oracle on the card, at full
    width, on the first MoE layer of ``model`` (bf16) and
    ``MOE_ORACLE_TOKENS`` tokens of unit scale.

    (1) ``capacity_factor`` raised until ``cap`` takes every token (nothing
    drops): ``moe_apply`` against ``moe_apply_dense_oracle``.  (2) The
    published ``capacity_factor``, which drops: ``moe_apply`` against the
    oracle's sum over the entries the dispatch serves (an expert past its
    capacity serves only its first ``cap - 1``, as the JAX package's
    scatter leaves it).  Both sides route from the same float32 logits (one
    call, the same bits).  They differ by bf16 roundings, each at most 2^-8
    of what it rounds: the capacity path rounds each of the K weighted
    expert outputs and each partial sum, the oracle each gate weight and
    its fp32 sum, both the shared or dense MLP's add, and the two expert
    products may round their bf16 outputs apart (other matrix shapes).  So
    each element is held within (2K + 3)·2^-8·S, S the magnitudes it sums
    down to the expert products' terms: Σ_k |w_k|·(|h_k|·|w_out_k|) +
    |shared| + |dense|."""
    import repro_torch.models.blocks as blocks
    from repro_torch.models.layers import mlp
    from repro_torch.models.model import layer_kinds
    cfg = model.cfg
    layer = model.layers[layer_kinds(cfg).index("moe")]["moe"]
    dev = model.device
    t, e, k, d = MOE_ORACLE_TOKENS, cfg.n_experts, cfg.top_k, cfg.d_model
    x = torch.randn((1, t, d), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7)
                    ).to(torch.bfloat16)
    xe = x.reshape(t, d).expand(e, -1, -1)
    ye = blocks._experts(cfg, layer, xe).float()                # [E, T, d]
    w_in, w_out = layer["w_in"], layer["w_out"]
    hh = torch.bmm(xe, w_in.view(e, d, -1)).unflatten(-1, w_in.shape[2:])
    act = (torch.nn.functional.silu if cfg.act == "swiglu" else
           lambda z: torch.nn.functional.gelu(z, approximate="tanh"))
    h = (act(hh[..., 0, :]) * hh[..., 1, :] if w_in.shape[2] == 2
         else act(hh[..., 0, :]))
    terms = torch.cat([torch.bmm(h[c:c + 64].abs(), w_out[c:c + 64].abs())
                       for c in range(0, e, 64)]).float()       # [E, T, d]
    del hh, h
    side = [mlp(x, layer[n], cfg.act)[0].float() for n in ("shared", "dense")
            if n in layer]

    out = {}
    for name, cf in (("no drop", e / k * 0.9999),
                     ("published", cfg.capacity_factor)):
        cap_cfg = dataclasses.replace(cfg, capacity_factor=cf)
        _, _, cap = blocks.moe_groups(cap_cfg, t)
        r = blocks.moe_dispatch(cap_cfg, layer["router"], x, cap)
        served = r["served"][0]
        comb = torch.zeros((t, e), device=dev)
        comb[r["tok_sorted"][0], r["se"][0]] = (
            r["w_sorted"][0] * served).to(torch.bfloat16).float()
        mags = torch.einsum("te,etd->td", comb.abs(), terms)
        mags = mags + sum(m.abs() for m in side)
        y, aux = blocks.moe_apply(cap_cfg, layer, x)
        if name == "no drop":
            check(cap == t and bool(served.all()), f"moe oracle: cap {cap} "
                  f"takes all {t} tokens, nothing dropped")
            want = blocks.moe_apply_dense_oracle(cfg, layer, x)[0].float()
        else:
            check(not bool(served.all()), f"moe: capacity factor {cf} (cap "
                  f"{cap}) drops entries")
            want = torch.einsum("te,etd->td", comb, ye) + sum(side)
        diff = (y[0].float() - want).abs()
        ratio = float((diff / ((2 * k + 3) * 2**-8 * mags)).max())
        check(bool(torch.isfinite(y).all()) and ratio <= 1.0,
              f"moe {name}: |capacity - oracle| within (2K + 3)·2^-8·S, "
              f"max ratio {ratio:.3g}")
        out[name] = dict(cap=cap, dropped=int((~served).sum()),
                         max_abs_err=float(diff.max()), max_ratio=ratio,
                         aux=float(aux))
        print(f"moe oracle {cfg.name} ({name}, capacity factor {cf:.6g}, cap "
              f"{cap}, {t} tokens, bf16): {out[name]['dropped']} of {t * k} "
              f"entries not served, max |capacity - oracle| "
              f"{out[name]['max_abs_err']:.4g}, at most {ratio:.4f} of the "
              f"(2K + 3)·2^-8·S bound; aux {float(aux):.6f}")
    return out


def device_ms(fn, reps: int = 1):
    """Milliseconds the device spends on one ``fn()``'s work alone: ``reps``
    calls are queued behind a sleep kernel (about 35 ms) that outlasts the
    host's queueing, so the events around them see no host gap.  ``None``
    when the host had not finished queueing before the sleep ended (a full
    launch queue, or a slow host)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1 << 26)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued_first = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / reps if queued_first else None


def stack_device_ms(model, x, cache, pos: int, prefix: int = 0):
    """Device milliseconds of one pass of ``x`` through ``model``'s layers
    and its unembedding, timed layer by layer with :func:`device_ms` (a
    whole step's ~1,700 launches overflow the launch queue): ``(total,
    {kind: ms})`` summed by layer kind (a hybrid model's rec and windowed
    attn layers are one flat list, as are their caches; an MoE model's
    dense and MoE layers), or ``None``."""
    from repro_torch.models.model import layer_kinds
    times = [("unembed", device_ms(lambda: model._unembed(x[:, -1:])))]
    for kind, lp, c in zip(layer_kinds(model.cfg), model.layers,
                           cache["layers"]):
        times.append((kind, device_ms(
            lambda: model._layer(lp, x, c, pos, prefix))))
    if any(t is None for _, t in times):
        return None
    by_kind = {}
    for kind, t in times:
        by_kind[kind] = by_kind.get(kind, 0.0) + t
    return sum(by_kind.values()), by_kind


def sdpa_fn(q, k, v, causal: bool):
    """One scaled_dot_product_attention call on [B, H, S, d] copies of the
    same inputs (the yardstick; the port never calls it)."""
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, is_causal=causal, enable_gqa=True)


def sdpa_mask_fn(q, k, v, window: int = 0, prefix: int = 0):
    """One scaled_dot_product_attention call over [B, H, S, d] copies of the
    same inputs, the KV head expanded to the query heads, with the model's
    causal mask as a boolean mask: the prefix-LM mask ``(j <= i) | (j <
    prefix)`` and with a ``window`` the keys ``j > i - window`` (the
    yardstick; the port never calls it)."""
    hq, hkv = q.shape[2], k.shape[2]
    qh = q.transpose(1, 2).contiguous()
    kh, vh = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
              .contiguous() for t in (k, v))
    i = torch.arange(q.shape[1], device=q.device)[:, None]
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = (j <= i) | (j < prefix)
    if window:
        mask = mask & (j > i - window)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask)


def flash_model_row(gen, fa, name: str, arch: str, launches, reps: int,
                    prompt_len: int = PROMPT_LEN, window: int = 0,
                    prefix: int = 0, dtype=torch.bfloat16):
    """Kernel 5 at ``arch``'s prefill (bf16, or ``dtype``): ``REQUESTS`` ×
    ``prompt_len`` queries of its heads over its serve cache, causal,
    ``sk_valid`` the prompt, with the model's ``window`` or ``prefix``
    mask; held against the plain version and timed beside it and the
    library call.  ``launches`` None: the row's own call through ``attend``
    with the count reset just before.  Returns the row and its ``(q, k,
    v)``, the cache for a decode row."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    b, s, g = REQUESTS, prompt_len, GEN_LEN
    cache = s + g + 8
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = flash_inputs(gen, b, s, cache, hq, hkv, d, dtype)
    pre = dict(causal=True, sk_valid=s, window=window, prefix=prefix)
    if launches is None:
        fa.LAUNCHES = 0
    got = fa.attend(q, k, v, **pre)
    if launches is None:
        launches = fa.LAUNCHES
        check(launches > 0 and got.dtype == dtype,
              f"{name}: attend launched kernel 5 ({launches})")
    err = close(got, fa.attend_plain(q, k, v, **pre), *HALF_TOL[dtype],
                f"flash {name} prefill")
    del got
    # The keys each query sees: up to max(i, prefix - 1), past i - window.
    seen = sum(max(i, prefix - 1) + 1 - (max(0, i - window + 1) if window
                                          else 0) for i in range(s))
    b_ms, b_by = bound(q.element_size() * (2 * q.numel() + 2 * b * s * hkv * d),
                       4 * b * hq * d * seen, BF16_FLOPS_PER_S)
    kv = k[:, :s], v[:, :s]
    lib = (sdpa_mask_fn(q, *kv, window, prefix) if window or prefix else
           sdpa_fn(q, *kv, True))
    masks = (f", window {window}" if window else "") + (
        f", prefix {prefix}" if prefix else "")
    row = dict(
        name=name, route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:78",
        launches=launches, max_abs_err=err,
        ms=cuda_ms(lambda: fa.attend(q, k, v, **pre), reps),
        plain_ms=cuda_ms(lambda: fa.attend_plain(q, k, v, **pre), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib, reps),
        shape=f"{arch} prefill q [{b}, {s}, {hq}, {d}] {DTYPE_TAG[dtype]} "
              f"over a [{b}, {cache}, {hkv}, {d}] cache, causal{masks}, "
              f"sk_valid {s}")
    return row, (q, k, v)


def flash_decode_row(fa, row, q1, k, v, dec, live, reps):
    """Add a decode call's error, times, bound and library time to ``row``:
    ``q1`` at ``dec["q_offset"]`` over the cache, whose ``live`` keys end at
    ``sk_valid``.  A decode call is short enough for the host to pace
    back-to-back calls, so it is timed on the device alone (kernel and
    library alike); the back-to-back time is kept beside it."""
    b, _, hq, d = q1.shape
    hkv, end = k.shape[2], dec["sk_valid"]
    row["decode_max_abs_err"] = close(
        fa.attend(q1, k, v, **dec), fa.attend_plain(q1, k, v, **dec),
        BF16_RTOL, BF16_ATOL, "flash decode")
    row["decode_ms"] = device_ms(lambda: fa.attend(q1, k, v, **dec), 20)
    row["decode_paced_ms"] = cuda_ms(lambda: fa.attend(q1, k, v, **dec),
                                     reps * 20)
    row["decode_plain_ms"] = cuda_ms(lambda: fa.attend_plain(q1, k, v, **dec),
                                     reps)
    row["decode_bound_ms"], row["decode_bound_by"] = bound(
        2 * (2 * q1.numel() + 2 * b * live * hkv * d),
        4 * b * hq * d * live, BF16_FLOPS_PER_S)
    row["decode_library_ms"] = device_ms(
        sdpa_fn(q1, k[:, end - live:end], v[:, end - live:end], False), 20)


def lm_kernel_rows(gen, fa, ss, ls, launches, args) -> list:
    """Each float kernel at the serve path's shapes: held against its plain
    version and timed beside it, its bound and its library call."""
    from repro_torch.configs import get_config
    reps = args.reps
    b, s, g = REQUESTS, PROMPT_LEN, GEN_LEN
    mamba = get_config("mamba2-130m")
    # qwen2's prefill over its cache, then a decode call at pos, sk_valid =
    # pos + 1 (not a tile multiple).
    row, (q, k, v) = flash_model_row(gen, fa, "flash_attention", "qwen2-1.5b",
                                     launches["flash"], reps)
    pos = s + g // 2 + 5
    q1 = q[:, :1].contiguous()
    flash_decode_row(fa, row, q1, k, v, dict(causal=True, sk_valid=pos + 1,
                                             q_offset=pos), pos + 1, reps)
    row["decode_shape"] = (f"q {list(q1.shape)} bf16 at pos {pos} over the "
                           f"{list(k.shape)} cache, sk_valid {pos + 1}")
    rows = [row]
    del q, k, v, q1

    h, p, n = mamba.ssm_heads, mamba.ssm_headdim, mamba.ssm_state
    for length in (s, s - 24):                           # and a ragged one
        args_ = ssd_inputs(gen, b, h, length, p, n)
        y, s_fin = ss.ssd_scan_chunked(*args_)
        y_p, s_p = ss.ssd_chunked_plain(*args_, 128)
        err = max(close(y, y_p, SSD_TOL, SSD_TOL, f"ssd y S={length}"),
                  close(s_fin, s_p, SSD_TOL, SSD_TOL, f"ssd S_fin S={length}"))
        if length == s:
            main, main_err = args_, err
    x, dt, A, B, C = main
    nbytes = 4 * (2 * x.numel() + dt.numel() + A.numel() + B.numel()
                  + C.numel() + b * h * n * p)
    # The recurrence's 4 N P operations a step and head, in fp32 accuracy on
    # the tensor cores: 3xTF32 does them at a third of TF32's rate.
    b_ms, b_by = bound(nbytes, 4 * n * p * b * h * s, TF32X3_FLOPS_PER_S)
    rows.append(dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:78",
        launches=launches["ssd"], max_abs_err=main_err,
        ms=cuda_ms(lambda: ss.ssd_scan_chunked(*main), reps),
        plain_ms=cuda_ms(lambda: ss.ssd_chunked_plain(*main, 128), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"x [{b}, {h}, {s}, {p}], B/C [{b}, {s}, {n}] fp32, "
              f"S_fin [{b}, {h}, {n}, {p}]"))
    del main, args_, x, dt, A, B, C

    # recurrentgemma: the windowed prefill over its cache and a decode call
    # past the window.
    rg = get_config("recurrentgemma-2b")
    s, w = HYBRID_PROMPT_LEN, rg.local_window
    row, (q, k, v) = flash_model_row(
        gen, fa, "flash_attention_window_d256", "recurrentgemma-2b",
        launches["flash_window"], reps, prompt_len=s, window=w)
    pos = s + g // 2 + 5
    q1 = q[:, :1].contiguous()
    flash_decode_row(fa, row, q1, k, v, dict(causal=True, sk_valid=pos + 1,
                                             q_offset=pos, window=w),
                     min(pos + 1, w), reps)
    row["decode_shape"] = (f"q {list(q1.shape)} bf16 at pos {pos} over the "
                           f"{list(k.shape)} cache, window {w}, sk_valid "
                           f"{pos + 1}")
    rows.append(row)
    del q, k, v, q1

    width = rg.lru_width
    for length in (s - 24, s):             # a ragged length, then the prompt's
        a, x = lru_inputs(gen, b, length, width)
        h, h_fin = ls.lru_scan_chunked(a, x)
        h_p, fin_p = ls.lru_chunked_plain(a, x, 256)
        err = max(close(h, h_p, LRU_TOL, LRU_TOL, f"lru h S={length}"),
                  close(h_fin, fin_p, LRU_TOL, LRU_TOL,
                        f"lru h_fin S={length}"))
        again = ls.lru_scan_chunked(a, x)
        check(torch.equal(again[0], h) and torch.equal(again[1], h_fin),
              f"lru S={length}: two runs of kernel 7 give equal bits")
        del h, h_fin, h_p, fin_p, again
    b_ms, b_by = bound(4 * (3 * a.numel() + b * width), 2 * a.numel(),
                       FP32_FLOPS_PER_S)
    rows.append(dict(
        name="lru_scan", route="cuda", source="src/repro_torch/csrc/lru_scan.cu",
        replaces="src/repro/kernels/lru_scan/lru_scan.py:57",
        launches=launches["lru"], max_abs_err=err,
        ms=cuda_ms(lambda: ls.lru_scan_chunked(a, x), reps),
        plain_ms=cuda_ms(lambda: ls.lru_chunked_plain(a, x, 256), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"a, b [{b}, {s}, {width}] fp32, h_fin [{b}, {width}]"))
    return rows


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def run_lm(dev: torch.device, args) -> list:
    """The serving phases after PSRS; returns their ``kernels`` rows."""
    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}.{m}")
            for m in ("bitonic_sort", "kway_merge", "alltoallv_deliver",
                      "flash_attention", "ssd_scan", "lru_scan")}
    fa, ss, ls = mods["flash_attention"], mods["ssd_scan"], mods["lru_scan"]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    lm_edge_checks(gen, fa, ss, ls)
    print(f"flash/ssd/lru edge checks: passed in "
          f"{time.perf_counter() - t0:.2f} s")
    # The same flash calls in bf16, on the tensor-core kernel.
    t0 = time.perf_counter()
    n = flash_edge_checks(gen, fa, torch.bfloat16, BF16_RTOL, BF16_ATOL)
    print(f"flash bf16 edge checks: {n} calls within 2^-10 + 2^-7 |plain|, "
          f"passed in {time.perf_counter() - t0:.2f} s")
    glue_check(dev, args.seed)
    qwen = serve_full(dev, "qwen2-1.5b", ("flash_attention",), mods, args)
    mamba = serve_full(dev, "mamba2-130m", ("ssd_scan",), mods, args)
    rg = serve_full(dev, "recurrentgemma-2b", ("lru_scan", "flash_attention"),
                    mods, args, prompt_len=HYBRID_PROMPT_LEN)
    from repro_torch.configs import get_config
    kimi = serve_full(dev, "kimi-k2-1t-a32b", ("flash_attention",), mods,
                      args, depth=MOE_DEPTH, after=moe_oracle_check)
    arctic = serve_full(dev, "arctic-480b", ("flash_attention",), mods, args,
                        depth=MOE_DEPTH)
    pali = serve_full(dev, "paligemma-3b", ("flash_attention",), mods, args)
    launches = {"flash": qwen["launches"]["flash_attention"],
                "ssd": mamba["launches"]["ssd_scan"],
                "flash_window": rg["launches"]["flash_attention"],
                "lru": rg["launches"]["lru_scan"]}
    rows = lm_kernel_rows(gen, fa, ss, ls, launches, args)
    rows += lm_dtype_rows(gen, args)
    for name, arch, res, prefix in (
            ("flash_attention_kimi", "kimi-k2-1t-a32b", kimi, 0),
            ("flash_attention_arctic", "arctic-480b", arctic, 0),
            ("flash_attention_prefix_d256", "paligemma-3b", pali,
             get_config("paligemma-3b").n_frontend_tokens)):
        rows.append(flash_model_row(gen, fa, name, arch,
                                    res["launches"]["flash_attention"],
                                    args.reps, prefix=prefix)[0])
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernel {r['name']} {r['shape']}: {r['ms']:.4f} ms, launches "
              f"{r['launches']}, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib} ms, "
              f"max |kernel - plain| {r['max_abs_err']:.3g}")
        if "decode_ms" in r:
            print(f"kernel {r['name']} decode {r['decode_shape']}: "
                  f"{fmt_ms(r['decode_ms'])} on the device ("
                  f"{r['decode_paced_ms']:.4f} ms a call back to back), plain "
                  f"{r['decode_plain_ms']:.4f} ms, bound "
                  f"{r['decode_bound_ms']:.4f} ms ({r['decode_bound_by']}), "
                  f"library {fmt_ms(r['decode_library_ms'])} on the device, "
                  f"max |kernel - plain| {r['decode_max_abs_err']:.3g}")
    return [{key: r[key] for key in r if not key.endswith("shape")}
            for r in rows]



# --------------------------------------------------------------------------- #
# 10. Training                                                                 #
# --------------------------------------------------------------------------- #

# Kernel 5b's edge matrix, (b, sq, sk, hq, hkv, d, mask keywords): head dims
# 16, 64, 80, 128 and 256; causal, non-causal, the prefix-LM mask (256 keys,
# and 37 under a window), windows of 16 and 100; GQA groups 1, 6, 7 and 8;
# one query row, ragged lengths, sk_valid and q_offset; two with so few
# blocks that the forward's plan splits the keys (its merge writes lse);
# the last three at the bf16 kernels' 64-key and 64-row tiles: ragged tiles
# at hubert's heads, a position's group of 6 across two row tiles (258
# rows), a prefix at qwen2's heads.  The four after them meet bf16's
# head-dim-256 passes: recurrentgemma's 10 heads over one KV head under a
# window of 100 (300 ragged rows, the dK/dV pass's rows in 11 slices),
# sk_valid and q_offset (3 slices), non-causal (2 slices), and a shape too
# small to slice.  Each case runs in fp32 and in bf16.
BWD_EDGES = [
    (2, 1, 1, 2, 2, 16, dict(causal=True)),
    (2, 37, 37, 6, 1, 16, dict(causal=True)),
    (1, 70, 70, 7, 1, 64, dict(causal=False)),
    (2, 300, 300, 8, 1, 80, dict(causal=True)),
    (2, 130, 130, 16, 16, 80, dict(causal=False)),
    (1, 300, 300, 12, 2, 128, dict(causal=True)),
    (2, 300, 300, 8, 1, 256, dict(causal=True, prefix=256)),
    (1, 90, 90, 4, 2, 256, dict(causal=True, window=16)),
    (1, 300, 300, 6, 2, 64, dict(causal=True, window=100)),
    (2, 70, 90, 4, 2, 16, dict(causal=True, prefix=37, window=16,
                               sk_valid=85, q_offset=20)),
    (1, 1, 1062, 12, 2, 128, dict(causal=True, sk_valid=1000, q_offset=999)),
    (1, 200, 1062, 2, 1, 80, dict(causal=True, q_offset=862)),
    (1, 1023, 1023, 16, 16, 80, dict(causal=False)),
    (1, 43, 43, 6, 1, 128, dict(causal=True)),
    (1, 200, 200, 12, 2, 128, dict(causal=True, prefix=37)),
    (1, 300, 300, 10, 1, 256, dict(causal=True, window=100)),
    (2, 100, 300, 8, 1, 256, dict(causal=True, sk_valid=260, q_offset=170)),
    (1, 150, 200, 4, 1, 256, dict(causal=False)),
    (1, 40, 40, 2, 1, 256, dict(causal=True)),
]
# Kernel 5b against attend_backward_plain from the same inputs: both sum in
# fp32 in other orders, so |kernel - plain| <= rtol |plain| + atol
# max(1, max |plain|) per gradient; bf16 rounds each gradient once more (one
# bf16 ulp, 2^-7 of |plain| at most).  The forward's lse within 1e-5 (1 +
# |plain|): fp32 sums of the same products.
BWD_FP32_TOL = (1e-4, 1e-5)
BWD_BF16_TOL = (2**-7, 1e-4)
# fp16: rtol |plain| + atol max(max |plain|, max |dout|) + 2^-24 (fp16's
# subnormal spacing): no floor of 1, so an output gradient of 2^-16, whose
# dS lies below fp16's normal range, is held at its own scale (the kernel
# scales dS a row by a power of two), and a gradient whose terms cancel at
# dout's (tests/test_torch_flash_attention.py models it).
BWD_FP16_TOL = (2**-10, 2**-12, 2**-24)
BWD_TOL = {torch.float32: BWD_FP32_TOL, torch.bfloat16: BWD_BF16_TOL,
           torch.float16: BWD_FP16_TOL}
LSE_TOL = 1e-5
# A full-width hubert-xlarge layer's gradients with the kernels against the
# plain path (attention differentiated through attend_plain), fp32 with TF32
# off: every leaf within 1e-4 of its largest element (other sum orders over
# 1024 frames and 1280-wide products).
LAYER_GRAD_TOL = 1e-4
# The smoke models trained on the card against the CPU, fp32, TF32 off.
SMOKE_LOSS_RTOL = 1e-4
# hubert-xlarge whole, as python -m repro_torch.launch.train
# --arch hubert-xlarge --steps 5 --seq 1024 --batch 16 --microbatches 2;
# qwen2-1.5b whole, 3 steps of 8 x 1024 tokens; mamba2-130m whole, 3 steps
# of 16 x 2048 tokens; recurrentgemma-2b whole, 3 steps of 4 x 3072 tokens
# in 2 microbatches (longer than its 2048-token window).
HUBERT_RUN = dict(steps=5, seq=1024, batch=16, microbatches=2)
QWEN_RUN = dict(steps=3, seq=1024, batch=8, microbatches=1)
MAMBA_RUN = dict(steps=3, seq=2048, batch=16, microbatches=1)
RGEMMA_RUN = dict(steps=3, seq=3072, batch=4, microbatches=2)
# One full-width layer of each kind in fp32 (TF32 off), its gradients with
# the kernels against the plain path: (what, arch, config changes, batch,
# positions).  recurrentgemma's local-attention layer is its block pattern
# cut to ("attn",): head dim 256, 10 heads over one KV head, window 2048.
LAYER_CHECKS = (
    ("hubert-xlarge", "hubert-xlarge", dict(), 2, 1024),
    ("mamba2-130m", "mamba2-130m", dict(), 2, 2048),
    ("recurrentgemma-2b rec", "recurrentgemma-2b", dict(), 1, 3072),
    ("recurrentgemma-2b local-attention", "recurrentgemma-2b",
     dict(block_pattern=("attn",)), 1, 3072),
)
# Kernels 6b and 7b's edge shapes: SSD (b, h, s, p, n): one step, shorter
# than the kernel's chunk of 64, one chunk, ragged, every built (N, P); LRU
# (b, s, d): one step, shorter than kernel 7b's chunk of 32, ragged, a width
# that is no multiple of its 128-channel blocks, recurrentgemma's width.
SSD_BWD_EDGES = [(1, 1, 1, 16, 16), (2, 3, 37, 16, 16), (1, 2, 64, 32, 32),
                 (2, 2, 100, 64, 64), (1, 2, 129, 64, 128),
                 (2, 24, 300, 64, 128)]
LRU_BWD_EDGES = [(1, 1, 1), (2, 31, 64), (2, 37, 100), (1, 300, 2560)]
# Kernel 6b against ssd_backward_plain (chunks of 64 both): 3xTF32 products
# and fp32 sums in other orders, dA, dB and dC summing over the whole
# sequence and the heads: |kernel - plain| <= 1e-4 |plain| + 1e-4 max(1,
# max |plain|).  Kernel 7b against lru_backward_plain: the same recurrence,
# its carries composed in another order: 1e-5 and 1e-5.
SSD_BWD_TOL = (1e-4, 1e-4)
LRU_BWD_TOL = (1e-5, 1e-5)
# The fixed-batch run's peak lr: at the default 3e-4 the first Adam step
# (every weight moved by about lr) lifts hubert's loss before it falls, so
# the fall is checked at a tenth of it.
FIXED_LR = 3e-5


def grad_close(got, want, tol, what: str, dout=None) -> float:
    """max |got - want| / scale, failing unless every element is within
    ``rtol |want| + atol scale``, scale ``max(1, max |want|)``; a tolerance
    of three, ``(rtol, atol, floor)`` (fp16's), takes scale ``max(max
    |want|, max |dout|)`` and adds ``floor``."""
    torch.cuda.synchronize()
    rtol, atol, *floor = tol
    check(got.shape == want.shape, f"{what}: shapes {got.shape} vs "
                                   f"{want.shape}")
    want = want.float()
    diff = (got.float() - want).abs()
    top = float(want.abs().max()) if want.numel() else 0.0
    if floor:
        scale = max(top, float(dout.abs().max()), floor[0])
        floor = floor[0]
    else:
        scale, floor = max(1.0, top), 0.0
    ok = bool((diff <= rtol * want.abs() + atol * scale + floor).all())
    err = float(diff.max()) / scale if diff.numel() else 0.0
    check(ok and math.isfinite(err), f"{what}: max |kernel - plain| = "
                                     f"{err * scale} (scale {scale})")
    return err


# The kernels a training step's clock counts and times: (key, kernel module,
# the wrapper function timed, its launch counter).
CLOCKED = (("5", "flash_attention", "_launch", "LAUNCHES"),
           ("5b", "flash_attention", "attend_backward", "BWD_LAUNCHES"),
           ("6", "ssd_scan", "_forward", "LAUNCHES"),
           ("6b", "ssd_scan", "ssd_scan_backward", "BWD_LAUNCHES"),
           ("7", "lru_scan", "_forward", "LAUNCHES"),
           ("7b", "lru_scan", "lru_scan_backward", "BWD_LAUNCHES"))


def step_launches(cfg, microbatches: int) -> dict:
    """The launches a training step of ``cfg`` makes of each clocked
    kernel: each layer's forward kernel (5 attention, 6 SSD, 7 RG-LRU) once
    a microbatch, twice under ``remat="layer"`` (its forward rerun in the
    backward), and its backward kernel once a microbatch."""
    from repro_torch.models.model import layer_kinds
    fwd = 2 if cfg.remat == "layer" else 1
    key = {"attn": "5", "moe": "5", "ssm": "6", "rec": "7"}
    out = dict.fromkeys((k for k, *_ in CLOCKED), 0)
    for kind in layer_kinds(cfg):
        out[key[kind]] += fwd * microbatches
        out[key[kind] + "b"] += microbatches
    return out


class KernelClock:
    """Counts the launches of kernels 5, 5b, 6, 6b, 7 and 7b and sums their
    device time in a run, between CUDA events recorded around each wrapper
    call (``CLOCKED``; the events add no synchronisation, :meth:`read`
    synchronises once)."""

    def __init__(self):
        self.orig = []
        for key, name, fn, counter in CLOCKED:
            mod = importlib.import_module(
                f"repro_torch.kernels.{name}.{name}")
            f = getattr(mod, fn)
            self.orig.append((mod, fn, f, counter))
            setattr(mod, fn, self._timed(key, f))
        self.reset()

    def _timed(self, key, fn):
        def call(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            self.events[key].append((e0, e1))
            self.calls[key] = dict(
                shapes=[tuple(t.shape) for t in a
                        if isinstance(t, torch.Tensor)],
                dtype=a[0].dtype,
                kw={k: v for k, v in kw.items()
                    if not isinstance(v, torch.Tensor)})
            return out
        return call

    def reset(self) -> None:
        self.events = {key: [] for key, *_ in CLOCKED}
        self.calls = {}
        for mod, _, _, counter in self.orig:
            setattr(mod, counter, 0)

    def read(self) -> dict:
        """Launches (``launches``) and device ms (``ms``) by kernel since
        :meth:`reset`, and the shapes of each kernel's last call
        (``calls``: its tensor arguments' shapes, the first one's dtype and
        the keywords that are not tensors)."""
        torch.cuda.synchronize()
        ms = {k: sum(a.elapsed_time(b) for a, b in ev)
              for k, ev in self.events.items()}
        launches = {key: getattr(mod, counter) for (key, *_), (mod, _, _,
                    counter) in zip(CLOCKED, self.orig)}
        return {"launches": launches, "ms": ms, "calls": dict(self.calls)}

    def close(self) -> None:
        for mod, fn, f, _ in self.orig:
            setattr(mod, fn, f)


def fwd_lse_check(fa, q, k, v, kw: dict, what: str):
    """Kernel 5 with lse against attend_plain_with_lse on the same inputs:
    the output within the forward's tolerance of its dtype, lse +inf on the
    same rows and within ``LSE_TOL`` elsewhere.  Returns the kernel's
    ``(out, lse)`` and the largest differences ``(out, lse)``."""
    out, lse = fa.attend_with_lse(q, k, v, **kw)
    out_p, lse_p = fa.attend_plain_with_lse(q, k, v, **kw)
    if q.dtype == torch.float32:
        e_out = close(out, out_p, 0, FP32_ATOL, f"{what} out")
    else:
        e_out = close(out, out_p, *HALF_TOL[q.dtype], f"{what} out")
    live = torch.isfinite(lse_p)
    check(torch.equal(live, torch.isfinite(lse)),
          f"{what}: lse +inf on the same rows")
    e_lse = close(lse[live], lse_p[live], LSE_TOL, LSE_TOL, f"{what} lse")
    return out, lse, (e_out, e_lse)


def bwd_edge_checks(gen, fa, dtypes=(torch.float32, torch.bfloat16),
                    dout_scales=(1.0,)) -> int:
    """Kernel 5 with lse and kernel 5b against their plain versions at
    ``BWD_EDGES`` in ``dtypes`` (``BWD_TOL``), with output gradients of
    ``dout_scales`` times unit scale; kernel 5b twice gives the same bits.
    Returns the number of cases."""
    n = 0
    for dtype in dtypes:
        for (b, sq, sk, hq, hkv, d, kw), dsc in itertools.product(
                BWD_EDGES, dout_scales):
            q, k, v = flash_inputs(gen, b, sq, sk, hq, hkv, d, dtype)
            dout = (torch.randn((b, sq, hq, d), generator=gen,
                                device=gen.device) * dsc).to(dtype)
            what = f"5b {dtype} {b, sq, sk, hq, hkv, d} {kw} dout x {dsc}"
            out, lse, _ = fwd_lse_check(fa, q, k, v, kw, what)
            got = fa.attend_backward(q, k, v, out, dout, lse, **kw)
            want = fa.attend_backward_plain(q, k, v, out, dout, **kw)
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                grad_close(g, w, BWD_TOL[dtype], f"{what} {name}", dout)
            again = fa.attend_backward(q, k, v, out, dout, lse, **kw)
            check(all(torch.equal(a, c) for a, c in zip(got, again)),
                  f"{what}: two runs of kernel 5b give equal bits")
            n += 1
    return n


def scan_bwd_edge_checks(gen, ss, ls) -> int:
    """Kernels 6b and 7b against their plain versions at ``SSD_BWD_EDGES``
    and ``LRU_BWD_EDGES``, each with the final state's gradient given and
    None, and at the model's strided views (x, B and C column slices of one
    projection whose rows are not 16-byte aligned, dt and dy transposed
    views; a column slice of a and every second step of dh); each kernel
    twice gives the same bits.  Returns the number of cases."""
    dev, n = gen.device, 0

    def ssd_case(ops, dy, fin, what):
        _, _, states = ss._forward(*ops, 128)
        got = ss.ssd_scan_backward(*ops, dy, fin, states=states)
        want = ss.ssd_backward_plain(*ops, dy, fin, chunk=ss.KERNEL_CHUNK)
        for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
            grad_close(g, w, SSD_BWD_TOL, f"{what} {name}")
        again = ss.ssd_scan_backward(*ops, dy, fin, states=states)
        check(all(torch.equal(u, v) for u, v in zip(got, again)),
              f"{what}: two runs of kernel 6b give equal bits")

    for b, h, s, p, nn in SSD_BWD_EDGES:
        ops = ssd_inputs(gen, b, h, s, p, nn)
        dy = torch.randn((b, h, s, p), generator=gen, device=dev)
        dS = torch.randn((b, h, nn, p), generator=gen, device=dev)
        for fin in (None, dS):
            ssd_case(ops, dy, fin, f"6b {(b, h, s, p, nn)} dS_fin "
                                   f"{'given' if fin is not None else None}")
            n += 1
    b, h, s, p, nn = 2, 3, 70, 64, 128
    proj = torch.randn((b, s, h * p + 2 * nn + 3), generator=gen, device=dev)
    views = (proj[..., 1:1 + h * p].reshape(b, s, h, p).transpose(1, 2),
             torch.nn.functional.softplus(torch.randn(
                 (b, s, h), generator=gen, device=dev)).transpose(1, 2),
             -torch.exp(0.5 * torch.randn((h,), generator=gen, device=dev)),
             proj[..., 1 + h * p:1 + h * p + nn] / nn ** 0.5,
             proj[..., 1 + h * p + nn:1 + h * p + 2 * nn] / nn ** 0.5)
    dy = torch.randn((b, s, h, p), generator=gen, device=dev).transpose(1, 2)
    ssd_case(views, dy, None, "6b the model's strided views")
    n += 1
    for b, s, d in LRU_BWD_EDGES:
        a, x = lru_inputs(gen, b, s, d)
        dh = torch.randn((b, s, d), generator=gen, device=dev)
        dh_fin = torch.randn((b, d), generator=gen, device=dev)
        h, _ = ls.lru_scan_chunked(a, x)
        wide = torch.zeros((b, s, 2 * d), device=dev)
        wide[..., d:] = a
        long = torch.zeros((b, 2 * s, d), device=dev)
        long[:, ::2] = dh
        for fin in (None, dh_fin):
            what = (f"7b {(b, s, d)} dh_fin "
                    f"{'given' if fin is not None else None}")
            got = ls.lru_scan_backward(a, h, dh, fin)
            want = ls.lru_backward_plain(a, h, dh, fin)
            for name, g, w in zip(("da", "db"), got, want):
                grad_close(g, w, LRU_BWD_TOL, f"{what} {name}")
            for args in ((a, h, dh, fin), (wide[..., d:], h, long[:, ::2],
                                           fin)):
                again = ls.lru_scan_backward(*args)
                check(all(torch.equal(u, v) for u, v in zip(got, again)),
                      f"{what}: kernel 7b again (strided: "
                      f"{args[0] is not a}) gives equal bits")
            n += 1
    return n


def ssd_bwd_bound(b, h, s, p, n, nc):
    """Kernel 6b's bound: read x, dt, B, C, dy and the forward's chunk
    states once, write dx, ddt, dA, dB and dC once (fp32); the least
    operations of the chunked form kernel 6b computes, in fp32 accuracy on
    the tensor cores (3xTF32, a third of TF32's rate): 8 N P a step and head
    (the state gradient's update, dx, dB and dC, 2 N P each; dC's carry
    term reads the saved chunk state, so no state is rebuilt a step) and
    2 N P a chunk and head (the decay's dot <Gbar_c+1, S_c>).  The products
    inside a chunk, O(Q (N + P)) a step, are left out: the bound is what any
    chunk length needs."""
    nbytes = 4 * (3 * b * h * s * p + 2 * b * h * s + 4 * b * s * n + 2 * h
                  + b * h * nc * n * p)
    return bound(nbytes, 2 * n * p * b * h * (4 * s + nc), TF32X3_FLOPS_PER_S)


def scan_train_rows(gen, ss, ls, mamba: dict, rg: dict, reps: int) -> list:
    """Kernels 6b and 7b at the shapes of their last call in a training step
    of mamba2-130m and recurrentgemma-2b (``calls`` of
    :meth:`KernelClock.read`), on fresh inputs: held against their plain
    versions and timed beside them and their bounds (no one PyTorch call
    computes either function: ``library_ms`` null); and kernels 6 and 7's
    forwards at the same shapes (rows ``ssd_scan_train``,
    ``lru_scan_train``)."""
    dev = gen.device
    rows = []
    (b, h, s, p), _, _, (_, _, n) = mamba["calls"]["6b"]["shapes"][:4]
    ops = ssd_inputs(gen, b, h, s, p, n)
    dy = torch.randn((b, h, s, p), generator=gen, device=dev)
    y, s_fin, states = ss._forward(*ops, 128)
    y_p, s_p = ss.ssd_chunked_plain(*ops, 128)
    e_fwd = max(close(y, y_p, SSD_TOL, SSD_TOL, "6t y"),
                close(s_fin, s_p, SSD_TOL, SSD_TOL, "6t S_fin"))
    del y, s_fin, y_p, s_p
    got = ss.ssd_scan_backward(*ops, dy, states=states)
    want = ss.ssd_backward_plain(*ops, dy, chunk=ss.KERNEL_CHUNK)
    err = max(grad_close(g, w, SSD_BWD_TOL, f"6b training {nm}") for nm, g, w
              in zip(("dx", "ddt", "dA", "dB", "dC"), got, want))
    del got, want
    shape = (f"mamba2-130m training: x, dy [{b}, {h}, {s}, {p}], B/C [{b}, "
             f"{s}, {n}] fp32")
    b_ms, b_by = ssd_bwd_bound(b, h, s, p, n, -(-s // ss.KERNEL_CHUNK))
    rows.append(dict(
        name="ssd_scan_bwd", route="cuda",
        source="src/repro_torch/csrc/ssd_scan_bwd.cu",
        # No TPU kernel: it replaces XLA's autodiff of the JAX model's
        # twin, src/repro/models/blocks.py:250.
        replaces="src/repro/models/blocks.py:250",
        launches=mamba["launches"]["6b"], max_abs_err=err,
        ms=cuda_ms(lambda: ss.ssd_scan_backward(*ops, dy, states=states),
                   reps),
        plain_ms=cuda_ms(lambda: ss.ssd_backward_plain(
            *ops, dy, chunk=ss.KERNEL_CHUNK), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=shape))
    x, dt, A, B, C = ops
    nbytes = 4 * (2 * x.numel() + dt.numel() + A.numel() + B.numel()
                  + C.numel() + b * h * n * p)
    b_ms, b_by = bound(nbytes, 4 * n * p * b * h * s, TF32X3_FLOPS_PER_S)
    rows.append(dict(
        name="ssd_scan_train", route="cuda",
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:78",
        launches=mamba["launches"]["6"], max_abs_err=e_fwd,
        ms=cuda_ms(lambda: ss.ssd_scan_chunked(*ops), reps),
        plain_ms=cuda_ms(lambda: ss.ssd_chunked_plain(*ops, 128), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=shape.replace(", dy", "").replace("training", "training "
                                                "forward")))
    del ops, dy, states, x, dt, A, B, C

    (b, s, d), _ = rg["calls"]["7b"]["shapes"][:2]
    a, x = lru_inputs(gen, b, s, d)
    dh = torch.randn((b, s, d), generator=gen, device=dev)
    h, h_fin = ls.lru_scan_chunked(a, x)
    h_p, fin_p = ls.lru_chunked_plain(a, x, 256)
    e_fwd = max(close(h, h_p, LRU_TOL, LRU_TOL, "7t h"),
                close(h_fin, fin_p, LRU_TOL, LRU_TOL, "7t h_fin"))
    again = ls.lru_scan_chunked(a, x)
    check(torch.equal(again[0], h) and torch.equal(again[1], h_fin),
          "7t: two runs of kernel 7 give equal bits")
    del h_p, fin_p, again
    got = ls.lru_scan_backward(a, h, dh)
    want = ls.lru_backward_plain(a, h, dh)
    err = max(grad_close(g, w, LRU_BWD_TOL, f"7b training {nm}")
              for nm, g, w in zip(("da", "db"), got, want))
    del got, want
    shape = f"recurrentgemma-2b training: a, h, dh [{b}, {s}, {d}] fp32"
    # Read a, h and dh, write da and db: 5 fp32 words an element; 3 FLOP
    # an element count for nothing against them.
    b_ms, b_by = bound(4 * 5 * a.numel(), 3 * a.numel(), FP32_FLOPS_PER_S)
    rows.append(dict(
        name="lru_scan_bwd", route="cuda",
        source="src/repro_torch/csrc/lru_scan_bwd.cu",
        # No TPU kernel: it replaces XLA's autodiff of the JAX model's
        # twin, src/repro/models/blocks.py:397.
        replaces="src/repro/models/blocks.py:397",
        launches=rg["launches"]["7b"], max_abs_err=err,
        ms=cuda_ms(lambda: ls.lru_scan_backward(a, h, dh), reps),
        plain_ms=cuda_ms(lambda: ls.lru_backward_plain(a, h, dh), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=shape))
    b_ms, b_by = bound(4 * (3 * a.numel() + b * d), 2 * a.numel(),
                       FP32_FLOPS_PER_S)
    rows.append(dict(
        name="lru_scan_train", route="cuda",
        source="src/repro_torch/csrc/lru_scan.cu",
        replaces="src/repro/kernels/lru_scan/lru_scan.py:57",
        launches=rg["launches"]["7"], max_abs_err=e_fwd,
        ms=cuda_ms(lambda: ls.lru_scan_chunked(a, x), reps),
        plain_ms=cuda_ms(lambda: ls.lru_chunked_plain(a, x, 256), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"recurrentgemma-2b training forward: a, b [{b}, {s}, {d}] "
              f"fp32, h_fin [{b}, {d}]"))
    return rows


# Kernel names of a training step's device time, by what launched them.
STEP_PARTS = (("kernel 5", ("flash_mma_kernel", "flash_kernel",
                            "combine_kernel")),
              ("kernel 5b", ("dkdv_mma_kernel", "dq_mma_kernel", "dkdv_kernel",
                             "dq_kernel", "row_dot_kernel", "dkdv_256_kernel",
                             "dq_256_kernel", "sum_slices_kernel")),
              ("kernel 6b", ("ssd_bwd_states", "ssd_bwd_chunk", "ssd_bwd_dA")),
              ("kernel 6", ("ssd_gram", "ssd_states", "ssd_output")),
              ("kernel 7b", ("lru_bwd_local", "lru_bwd_carry", "lru_bwd_fix")),
              ("kernel 7", ("lru_kernel", "lru_local", "lru_carry",
                            "lru_fix")),
              ("matmuls", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")))


def profile_step(step_fn, state, batch) -> dict:
    """One more training step under ``torch.profiler`` (CUDA activity): the
    device ms of its kernels summed by ``STEP_PARTS`` (the rest "other"),
    the step's wall ms around it and the device's busy share of that wall
    time (the profiler's own cost included)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    parts = dict.fromkeys([p for p, _ in STEP_PARTS] + ["other"], 0.0)
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        part = next((p for p, names in STEP_PARTS
                     if any(n in e.key for n in names)), "other")
        parts[part] += us / 1e3
    busy = sum(parts.values())
    return dict(wall_ms=wall, device_ms=busy, busy=busy / wall, parts=parts)


def train_steps(model, tcfg, batches, clock, what: str,
                profile: bool = False):
    """``tcfg``'s train step over ``batches`` on ``model``, each step timed
    on the host clock (synchronised) with its loss, gnorm, peak memory and
    the clocked kernels' launches and device ms (:class:`KernelClock`), the
    launches held to :func:`step_launches`; returns the per-step dicts and,
    with ``profile``, :func:`profile_step` of one more step on the last
    batch (else None)."""
    from repro_torch.train import init_train_state, make_train_step
    state = init_train_state(model.params(), tcfg)
    step_fn = make_train_step(model, tcfg)
    out = []
    for i, batch in enumerate(batches):
        reset_peak()
        clock.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rec = dict(step=i + 1, loss=float(m["loss"]), gnorm=float(m["gnorm"]),
                   lr=float(m["lr"]), ms_step=ms,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   **clock.read())
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["gnorm"]),
              f"{what} step {i + 1}: finite loss and gnorm")
        want = step_launches(model.cfg, tcfg.microbatches)
        check(rec["launches"] == want, f"{what} step {i + 1}: launches "
                                       f"{rec['launches']}, want {want}")
        out.append(rec)
    prof = profile_step(step_fn, state, batches[-1]) if profile else None
    del state
    return out, prof


def print_steps(what: str, recs: list, positions: int) -> None:
    for r in recs:
        kern = "; ".join(f"kernel {k}: {n} launches, {r['ms'][k]:.1f} ms"
                         for k, n in r["launches"].items() if n)
        print(f"train {what} step {r['step']}: loss {r['loss']:.4f}, gnorm "
              f"{r['gnorm']:.3f}, lr {r['lr']:.3g}, {r['ms_step']:.1f} ms, "
              f"{positions / r['ms_step'] * 1e3:,.0f} positions/s, peak "
              f"{r['peak_gib']:.2f} GiB; {kern}")


def describe_mixers(cfg) -> str:
    """The sequence mixers of ``cfg``: attention heads, SSD heads and state,
    the RG-LRU width and the local window, as the family has them."""
    parts = []
    if cfg.family == "ssm":
        parts.append(f"{cfg.ssm_heads} SSD heads of {cfg.ssm_headdim}, state "
                     f"{cfg.ssm_state}")
    else:
        parts.append(f"{cfg.n_heads} heads of {cfg.head_dim} "
                     f"({cfg.n_kv_heads} KV)")
    if cfg.family == "hybrid":
        parts.append(f"RG-LRU width {cfg.lru_width}, pattern "
                     f"{'/'.join(cfg.block_pattern)}, window {cfg.local_window}")
    return ", ".join(parts)


def train_full(dev, arch: str, run: dict, clock, seed: int,
               fixed_steps: int = 0, changes: dict | None = None) -> dict:
    """``arch`` whole at full width (its config's dtype, bf16 unless
    ``changes``, fields replaced, say so; random weights from ``seed``):
    ``run["steps"]`` steps of the synthetic pipeline's batches through the
    training API ``launch.train`` drives (``Model``, ``init_train_state``,
    ``make_train_step``, ``synthetic_batches``), then, with
    ``fixed_steps``, that many steps on one fixed batch from a fresh
    optimizer state at peak lr ``FIXED_LR``, whose loss must fall."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batches
    from repro_torch.models import Model
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig
    cfg = dataclasses.replace(get_config(arch), **(changes or {}))
    reset_peak()
    model = Model(cfg, device=dev, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    steps = run["steps"]
    tcfg = TrainConfig(opt=OptConfig(), microbatches=run["microbatches"],
                       warmup_steps=max(steps // 20, 1), total_steps=steps)
    dcfg = DataConfig(seq_len=run["seq"], global_batch=run["batch"],
                      vocab=cfg.vocab, seed=seed, frontend=cfg.frontend,
                      n_frontend_tokens=cfg.n_frontend_tokens,
                      d_model=cfg.d_model)
    batches = [b for _, b in zip(range(steps),
                                 synthetic_batches(dcfg, device=dev))]
    positions = run["batch"] * run["seq"]
    print(f"train {arch}: {n_params / 1e9:.4f} G params, {cfg.n_layers} "
          f"layers, d {cfg.d_model}, {describe_mixers(cfg)}, {cfg.dtype}, "
          f"remat {cfg.remat}; {steps} steps of {run['batch']} x "
          f"{run['seq']}, microbatches {run['microbatches']}")
    recs, prof = train_steps(model, tcfg, batches, clock, arch,
                             profile=True)
    print_steps(arch, recs, positions)
    parts = ", ".join(f"{k} {v:.1f}" for k, v in prof["parts"].items())
    print(f"train {arch} profiled step: {prof['wall_ms']:.1f} ms wall, "
          f"{prof['device_ms']:.1f} ms on the device ({parts}), busy "
          f"{prof['busy']:.1%}")
    res = dict(steps=recs, params=n_params, profile=prof)
    if fixed_steps:
        fixed = TrainConfig(opt=OptConfig(lr=FIXED_LR),
                            microbatches=run["microbatches"], warmup_steps=1,
                            total_steps=100)
        recs, _ = train_steps(model, fixed, [batches[0]] * fixed_steps,
                              clock, f"{arch} fixed batch")
        print_steps(f"{arch} fixed batch", recs, positions)
        losses = [r["loss"] for r in recs]
        check(losses[-1] < losses[0], f"{arch}: the loss on one fixed batch "
                                      f"falls over {fixed_steps} steps "
                                      f"({losses})")
        res["fixed"] = recs
    del model, batches
    torch.cuda.empty_cache()
    return res


def layer_grad_check(dev, seed: int, what: str, arch: str, changes: dict,
                     batch: int, seq: int) -> dict:
    """One full-width layer of ``arch`` (``changes`` applied, fp32, TF32
    off): the loss's gradients with the kernels (5 and 5b, 6 and 6b, or 7
    and 7b, by the layer's kind) against the same model with the layer's
    mixer differentiated through its plain version (``attend_plain``,
    ``ssd_chunked_plain``, ``lru_chunked_plain``; PyTorch autograd), every
    leaf within ``LAYER_GRAD_TOL`` of its largest element."""
    import repro_torch.models.blocks as blocks
    import repro_torch.models.layers as layers
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import layer_kinds
    from repro_torch.tree import leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), n_layers=1, dtype="float32",
                              **changes)
    kind = layer_kinds(cfg)[0]
    model = Model(cfg, device=dev, seed=seed)
    flat = list(leaves(model.params()))
    for p in flat:
        p.requires_grad_(True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.frontend == "frames":
        data = {"frames": torch.randn((batch, seq, cfg.d_model), generator=gen,
                                      device=dev),
                "labels": torch.randint(0, cfg.vocab, (batch, seq),
                                        generator=gen, device=dev)}
    else:
        data = {"tokens": torch.randint(0, cfg.vocab, (batch, seq),
                                        generator=gen, device=dev)}

    def grads():
        loss, _ = model.loss(data)
        got = torch.autograd.grad(loss, flat, allow_unused=True)
        return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                                      for p, g in zip(flat, got)]

    # The layer's kernel module, and the plain versions put in its place.
    fa = sys.modules[layers.attend.__module__]
    ss = sys.modules[blocks.ssd_scan_chunked.__module__]
    ls = sys.modules[blocks.lru_scan_chunked.__module__]
    mod, key = {"attn": (fa, "5"), "ssm": (ss, "6"), "rec": (ls, "7")}[kind]
    plain = {"attn": [(layers, "attend", fa.attend_plain)],
             "ssm": [(blocks, "ssd_scan_chunked",
                      lambda *a, chunk: ss.ssd_chunked_plain(*a, chunk))],
             "rec": [(blocks, "lru_scan_chunked",
                      lambda a, b, chunk: ls.lru_chunked_plain(a, b, chunk))]
             }[kind]
    before = (mod.LAUNCHES, mod.BWD_LAUNCHES)
    loss_k, g_k = grads()
    after = (mod.LAUNCHES, mod.BWD_LAUNCHES)
    check(after[0] - before[0] == 2 and after[1] - before[1] == 1,
          f"{what} layer: kernel {key} twice (remat) and {key}b once, got "
          f"{after[0] - before[0]} and {after[1] - before[1]}")
    saved = [(m, name, getattr(m, name)) for m, name, _ in plain]
    for m, name, fn in plain:
        setattr(m, name, fn)
    try:
        loss_p, g_p = grads()
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p),
          f"{what} layer loss {loss_k} vs plain {loss_p}")
    worst = 0.0
    for a, b in zip(g_k, g_p):
        scale = float(b.abs().max())
        err = float((a - b).abs().max()) / max(scale, 1e-30)
        check(err <= LAYER_GRAD_TOL, f"{what} layer gradient {tuple(a.shape)}"
                                     f": max |kernel - plain| / max |plain| "
                                     f"= {err}")
        worst = max(worst, err)
    print(f"train {what}, one full-width {kind} layer (fp32, {batch} x "
          f"{seq}): loss {loss_k:.6f} (plain {loss_p:.6f}), {len(g_k)} "
          f"gradient leaves within {worst:.3g} of their largest element "
          f"(bound {LAYER_GRAD_TOL}); kernels {key} and {key}b")
    del model, flat, g_k, g_p, data
    torch.cuda.empty_cache()
    return dict(loss=loss_k, worst=worst)


def smoke_train_check(dev, arch: str, seed: int, clock) -> dict:
    """``arch``'s smoke config (fp32, TF32 off) trained 3 steps on the card
    and on the CPU from the same weights and batches: the losses within
    ``SMOKE_LOSS_RTOL``, the card's run through its layers' kernels
    (:func:`step_launches`).  The launches returned are those of the card's
    last step."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import Model
    from repro_torch.models.model import init_params
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    from repro_torch.tree import map_tree
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).smoke()
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    tcfg = TrainConfig(warmup_steps=1, total_steps=10)
    dcfg = DataConfig(seq_len=48, global_batch=4, vocab=cfg.vocab, seed=seed,
                      frontend=cfg.frontend,
                      n_frontend_tokens=cfg.n_frontend_tokens,
                      d_model=cfg.d_model)
    batches = [synthetic_batch(dcfg, i, device=dev) for i in range(3)]
    losses = []
    for where in (dev, torch.device("cpu")):
        model = Model(cfg, device=where,
                      params=map_tree(lambda t: t.clone(), params))
        state = init_train_state(model.params(), tcfg)
        step = make_train_step(model, tcfg)
        got = []
        for i, b in enumerate(batches):
            if where.type == "cuda" and i == len(batches) - 1:
                clock.reset()
            state, m = step(state, {k: t.to(where) for k, t in b.items()})
            got.append(float(m["loss"]))
        losses.append(got)
        if where.type == "cuda":
            counts = clock.read()
    card, cpu = losses
    for a, b in zip(card, cpu):
        check(abs(a - b) <= SMOKE_LOSS_RTOL * abs(b),
              f"{arch} smoke: card losses {card} vs CPU {cpu}")
    want = step_launches(cfg, tcfg.microbatches)
    check(counts["launches"] == want, f"{arch} smoke: launches "
                                      f"{counts['launches']}, want {want}")
    kern = ", ".join(f"{k} {n}" for k, n in counts["launches"].items() if n)
    print(f"train {cfg.name} (fp32) 3 steps: card losses "
          f"{[round(x, 6) for x in card]}, CPU {[round(x, 6) for x in cpu]}; "
          f"its last step's launches by kernel: {kern}")
    return dict(losses=card, **counts)


def bwd_row(gen, fa, name: str, arch: str, step: dict, reps: int) -> dict:
    """Kernel 5b at the shapes, dtype and mask of the last kernel-5b call of
    ``arch``'s training step (``step``, a :meth:`KernelClock.read` of it),
    on fresh inputs: kernel 5 with lse held against attend_plain_with_lse,
    kernel 5b against attend_backward_plain, each timed beside its plain
    version, its bound, scaled_dot_product_attention's forward plus
    backward (the library call; never called by the port) and its backward
    alone (``library_bwd_ms``: ``torch.autograd.grad`` with
    ``retain_graph`` on one forward run outside the timer), the same
    function as kernel 5b.  The row's launches are the step's, kernel 5b's
    and (``fwd_launches``) kernel 5's."""
    call = step["calls"]["5b"]
    (b, s, hq, d), (_, sk, hkv, _) = call["shapes"][:2]
    dtype, kw = call["dtype"], call["kw"]
    check(sk == s and kw["sk_valid"] == s and kw["q_offset"] == 0,
          f"{name}: a training call ({call})")
    causal, prefix, window = kw["causal"], kw["prefix"], kw["window"]
    q, k, v = flash_inputs(gen, b, s, s, hq, hkv, d, dtype)
    dout = torch.randn((b, s, hq, d), generator=gen,
                       device=gen.device).to(dtype)
    out, lse, (e_out, e_lse) = fwd_lse_check(fa, q, k, v, kw, name)
    got = fa.attend_backward(q, k, v, out, dout, lse, **kw)
    want = fa.attend_backward_plain(q, k, v, out, dout, **kw)
    err = max(grad_close(g, w, BWD_TOL[dtype], f"{name} {nm}", dout)
              for nm, g, w in zip(("dq", "dk", "dv"), got, want))
    del got, want
    # The pairs (query, key) the mask lets through: query i sees keys up
    # to max(i, prefix - 1) (all keys without causality), past i - window;
    # five products of 2 d FLOP a pair and head.
    pairs = sum((min(s, max(i, prefix - 1) + 1) if causal else s)
                - (max(0, i - window + 1) if window else 0) for i in range(s))
    # Read q, k, v, out, dout and lse once; write dq, dk and dv once.
    nbytes = (q.element_size() * (4 * q.numel() + 4 * k.numel())
              + 4 * lse.numel())
    rate = FP32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
    b_ms, b_by = bound(nbytes, 5 * 2 * b * hq * d * pairs, rate)
    qh = q.transpose(1, 2).contiguous().requires_grad_(True)
    kh, vh = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
              .contiguous().requires_grad_(True) for t in (k, v))
    doh = dout.transpose(1, 2).contiguous()
    if prefix or window:
        i = torch.arange(s, device=q.device)[:, None]
        j = torch.arange(s, device=q.device)[None, :]
        mask = (j <= i) | (j < prefix) if causal else j >= 0
        sdpa_kw = dict(attn_mask=mask & (j > i - window) if window else mask)
    else:
        sdpa_kw = dict(is_causal=causal)

    def lib_fwd():
        return torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, scale=kw["scale"], **sdpa_kw)

    def lib():
        torch.autograd.grad(lib_fwd(), (qh, kh, vh), doh)

    o_lib = lib_fwd()
    # Kernel 5 with lse (rows 5t, 5tq): its bound (q, k, v read, out and lse
    # written once; two products of 2 d FLOP a pair and head) and the one
    # PyTorch call that returns the output and its logsumexp, the flash
    # attention op (no mask argument: rows without a prefix or window).
    fwd_b_ms, fwd_b_by = bound(
        q.element_size() * (2 * q.numel() + 2 * k.numel()) + 4 * lse.numel(),
        2 * 2 * b * hq * d * pairs, rate)
    fwd_lib_ms = None
    if not (prefix or window) and dtype != torch.float32:
        qd, kd, vd = (t.detach() for t in (qh, kh, vh))
        fwd_lib_ms = cuda_ms(
            lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                qd, kd, vd, 0.0, causal, False, scale=kw["scale"]), reps)

    masks = "causal" if causal else "non-causal"
    masks += f", prefix {prefix}" if prefix else ""
    masks += f", window {window}" if window else ""
    kind = DTYPE_TAG[dtype]
    row = dict(
        name=name, route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        # No TPU kernel: it replaces XLA's autodiff of the JAX model's
        # attention, src/repro/models/layers.py:99-174.
        replaces="src/repro/models/layers.py:99",
        launches=step["launches"]["5b"], max_abs_err=err,
        ms=cuda_ms(lambda: fa.attend_backward(q, k, v, out, dout, lse, **kw),
                   reps),
        plain_ms=cuda_ms(lambda: fa.attend_backward_plain(q, k, v, out, dout,
                                                          **kw), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib, reps),
        library_bwd_ms=cuda_ms(lambda: torch.autograd.grad(
            o_lib, (qh, kh, vh), doh, retain_graph=True), reps),
        fwd_ms=cuda_ms(lambda: fa.attend_with_lse(q, k, v, **kw), reps),
        fwd_plain_ms=cuda_ms(lambda: fa.attend_plain_with_lse(q, k, v, **kw),
                             2),
        fwd_bound_ms=fwd_b_ms, fwd_bound_by=fwd_b_by,
        fwd_library_ms=fwd_lib_ms,
        shape=f"{arch} training: q [{b}, {s}, {hq}, {d}] {kind} over k, v "
              f"[{b}, {s}, {hkv}, {d}], {masks}",
        fwd_err=(e_out, e_lse), fwd_launches=step["launches"]["5"])
    return row


def lse_row(r: dict, name: str) -> dict:
    """Kernel 5 with lse at a training shape (rows 5t, 5tq), from
    :func:`bwd_row`'s forward figures: the step's kernel-5 launches, the
    output's largest difference from the plain version, the times, the
    bound and the flash attention op's time."""
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:78",
        launches=r["fwd_launches"], max_abs_err=r["fwd_err"][0],
        ms=r["fwd_ms"], plain_ms=r["fwd_plain_ms"],
        bound_ms=r["fwd_bound_ms"], bound_by=r["fwd_bound_by"],
        library_ms=r["fwd_library_ms"],
        shape=r["shape"] + ", forward with lse")


def run_train(dev: torch.device, args) -> list:
    """The training phase: kernel 5b's, 6b's and 7b's edge checks;
    hubert-xlarge, qwen2-1.5b, mamba2-130m and recurrentgemma-2b whole; one
    full-width layer of each kind against the plain path; paligemma's,
    kimi's, mamba2's and recurrentgemma's smoke configs against the CPU;
    returns the ``kernels`` rows 5b, 5bq, 5bp, 5br, 5t, 5tq (kernel 5 with
    lse at hubert's and qwen2's training shapes), 6b, 6t, 7b and 7t."""
    t_phase = time.perf_counter()
    fa, ss, ls = (importlib.import_module(f"repro_torch.kernels.{m}.{m}")
                  for m in ("flash_attention", "ssd_scan", "lru_scan"))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    n = bwd_edge_checks(gen, fa)
    print(f"train: kernel 5 lse and kernel 5b edge checks, {n} cases (fp32 "
          f"within {BWD_FP32_TOL}, bf16 within {BWD_BF16_TOL} as (rtol, atol "
          f"of max(1, max |plain|))), two runs bit-equal, passed in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    n = scan_bwd_edge_checks(gen, ss, ls)
    print(f"train: kernel 6b and 7b edge checks, {n} cases (6b within "
          f"{SSD_BWD_TOL}, 7b within {LRU_BWD_TOL} as (rtol, atol of max(1, "
          f"max |plain|))), two runs bit-equal, passed in "
          f"{time.perf_counter() - t0:.2f} s")
    clock = KernelClock()
    try:
        hub = train_full(dev, "hubert-xlarge", HUBERT_RUN, clock, args.seed,
                         fixed_steps=5)
        qwen = train_full(dev, "qwen2-1.5b", QWEN_RUN, clock, args.seed)
        mamba = train_full(dev, "mamba2-130m", MAMBA_RUN, clock, args.seed)
        rg = train_full(dev, "recurrentgemma-2b", RGEMMA_RUN, clock,
                        args.seed)
        for check_args in LAYER_CHECKS:
            layer_grad_check(dev, args.seed, *check_args)
        pali = smoke_train_check(dev, "paligemma-3b", args.seed, clock)
        for arch in ("kimi-k2-1t-a32b", "mamba2-130m", "recurrentgemma-2b"):
            smoke_train_check(dev, arch, args.seed, clock)
    finally:
        clock.close()
    rows = []
    for name, arch, step in (
            ("flash_attention_bwd", "hubert-xlarge", hub["steps"][-1]),
            ("flash_attention_bwd_qwen2", "qwen2-1.5b", qwen["steps"][-1]),
            ("flash_attention_bwd_prefix", "paligemma-3b smoke", pali),
            ("flash_attention_bwd_window", "recurrentgemma-2b",
             rg["steps"][-1])):
        rows.append(bwd_row(gen, fa, name, arch, step, args.reps))
    lse_rows = [lse_row(rows[0], "flash_attention_lse"),
                lse_row(rows[1], "flash_attention_lse_qwen2")]
    for r in lse_rows:
        print(f"kernel {r['name']} {r['shape']}: {r['ms']:.4f} ms, launches "
              f"{r['launches']} a step, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4g} ms ({r['bound_by']}), library "
              f"(_scaled_dot_product_flash_attention, output and "
              f"logsumexp) {r['library_ms']:.4f} ms, max |out - plain| "
              f"{r['max_abs_err']:.3g}")
    for r in rows:
        print(f"kernel {r['name']} {r['shape']}: {r['ms']:.4f} ms, launches "
              f"{r['launches']} a step (forward {r['fwd_launches']}, under "
              f"remat twice a layer), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4g} ms ({r['bound_by']}), library (sdpa "
              f"forward + backward) {r['library_ms']:.4f} ms, sdpa backward "
              f"alone {r['library_bwd_ms']:.4f} ms, forward with "
              f"lse {r['fwd_ms']:.4f} ms (max |out - plain| "
              f"{r['fwd_err'][0]:.3g}, |lse - plain| "
              f"{r['fwd_err'][1]:.3g}), max |kernel - plain| / max(1, "
              f"max |plain|) {r['max_abs_err']:.3g}")
    scan_rows = scan_train_rows(gen, ss, ls, mamba["steps"][-1],
                                rg["steps"][-1], args.reps)
    for r in scan_rows:
        print(f"kernel {r['name']} {r['shape']}: {r['ms']:.4f} ms, launches "
              f"{r['launches']} a step, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4g} ms ({r['bound_by']}), no library call; "
              f"max |kernel - plain| {r['max_abs_err']:.3g}")
    print(f"train phase: {time.perf_counter() - t_phase:.1f} s")
    fwd = ("fwd_err", "fwd_plain_ms", "fwd_bound_ms", "fwd_bound_by",
           "fwd_library_ms")
    return [{key: r[key] for key in r if key not in ("shape",) + fwd}
            for r in rows + lse_rows + scan_rows]


# --------------------------------------------------------------------------- #
# The training driver's checkpoints (phase 10b): SIGKILL and resume on one    #
# card; elastic checkpoints over cards (phase 12b).                           #
# --------------------------------------------------------------------------- #

# Where the checkpoints go (inside the checkout, git-ignored), the model
# and the training driver's flags: full width, 6 steps of 2 x 2048 tokens,
# a checkpoint every 2 steps (the uninterrupted run keeps step 6's alone:
# its steps are the same, and it writes 2.6 GB less beside the run to
# kill), killed once step RESUME_KILL_AT's has committed.
RESUME_DIR = ROOT / "build" / "resume"
RESUME_ARCH = "mamba2-130m"
RESUME_STEPS = 6
RESUME_KILL_AT = 4
RESUME_FLAGS = ["--arch", RESUME_ARCH, "--steps", str(RESUME_STEPS),
                "--log-every", "1", "--batch", "2", "--seq", "2048"]
# The driver's ``main`` (what ``python -m repro_torch.launch.train`` runs)
# in a child that prints, as they happen, the host-clock marks of its
# start, its imports, each train step's call, the restore and each save's
# call and commit (its manifest durable), with the checkpoint layer's
# seconds by function so far; then kernels 6's and 6b's launches.
TRAIN_CHILD = """
import time
print("MARK start", time.time(), flush=True)
import importlib, json, sys
from repro_torch.checkpoint import manager
from repro_torch.launch import train


def mark(name):
    print("MARK", name, time.time(), flush=True)


Manager = manager.CheckpointManager
save, restore, commit = (Manager.save, Manager.restore_latest,
                         manager.atomic_write_json)


def timed_save(self, step, state, blocking=True):
    mark(f"save{step}")
    return save(self, step, state, blocking)


def timed_restore(self, *a, **kw):
    mark("restore")
    got = restore(self, *a, **kw)
    mark("restored")
    return got


def timed_commit(path, obj):
    commit(path, obj)
    mark(f"commit{obj['step']}")
    print("PARTS " + json.dumps(parts), flush=True)


Manager.save, Manager.restore_latest = timed_save, timed_restore
manager.atomic_write_json = timed_commit
parts = {}


def summed(owner, name):
    fn = getattr(owner, name)

    def run(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
    setattr(owner, name, run)


for name in ("_snapshot", "_array_crcs", "save_npy_durable", "_verify"):
    summed(manager, name)
make_step = train.make_train_step


def timed_make_step(*a, **kw):
    step_fn, calls = make_step(*a, **kw), [0]

    def step(state, batch):
        calls[0] += 1
        mark(f"call{calls[0]}")
        return step_fn(state, batch)
    return step


train.make_train_step = timed_make_step
mark("imported")
train.main(sys.argv[1:])
print("PARTS " + json.dumps(parts), flush=True)
mark("end")
ss = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
print("LAUNCHES " + json.dumps({"6": ss.LAUNCHES, "6b": ss.BWD_LAUNCHES}),
      flush=True)
"""


def kill_all(procs) -> None:
    """Kill and reap the children still running."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def train_child(ckpt_dir: Path, every: int) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", TRAIN_CHILD, *RESUME_FLAGS, "--ckpt-every",
         str(every), "--ckpt-dir", str(ckpt_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=child_env(), cwd=ROOT)


def step_dir(ckpt_dir: Path, step: int) -> Path:
    return ckpt_dir / f"step_{step:012d}"


def child_done(proc: subprocess.Popen, what: str, timeout: float = 600):
    """A child's stdout once it exits 0 (else the check fails with its
    stderr's tail)."""
    out, err = proc.communicate(timeout=timeout)
    check(proc.returncode == 0, f"{what}: exit {proc.returncode}; "
          f"{err[-3000:]}")
    return out


def step_losses(out: str) -> dict:
    """``{step: (loss, gnorm)}`` from the training driver's step lines."""
    got = {}
    for line in out.splitlines():
        if line.startswith("step "):
            f = line.split()
            got[int(f[1])] = (f[2], f[3])
    return got


def marks(out: str) -> dict:
    """A train child's host-clock marks, by name."""
    return {f[1]: float(f[2]) for f in (line.split() for line in
                                        out.splitlines())
            if len(f) == 3 and f[0] == "MARK"}


def manifest(d: Path) -> dict:
    return json.loads((d / "manifest.json").read_text())


def leaf_diffs(a: Path, b: Path) -> list:
    """Each array whose chunk CRCs differ between checkpoints ``a`` and
    ``b``: ``(key, dtype, largest |a - b|)`` (bf16 bits compared as
    bf16)."""
    import numpy as np
    ma, mb = manifest(a), manifest(b)
    check([(x["key"], x["shape"], x["dtype"]) for x in ma["arrays"]]
          == [(x["key"], x["shape"], x["dtype"]) for x in mb["arrays"]],
          f"checkpoints {a} and {b} hold the same leaves")
    out = []
    for x, y in zip(ma["arrays"], mb["arrays"]):
        if x["chunk_crcs"] == y["chunk_crcs"]:
            continue
        u, w = (torch.from_numpy(np.load(d / z["file"]))
                for d, z in ((a, x), (b, y)))
        if u.dtype == torch.uint16:
            u, w = u.view(torch.bfloat16), w.view(torch.bfloat16)
        err = (u.double() - w.double()).abs().max().item() if u.numel() \
            else 0.0
        out.append((x["key"], x["dtype"], err))
    return out


def state_bytes(d: Path) -> int:
    import numpy as np
    return sum(int(np.prod(x["shape"], dtype=np.int64))
               * np.dtype(x["dtype"]).itemsize
               for x in manifest(d)["arrays"])


def run_resume(dev) -> None:
    """Phase 10b: the training driver (``repro_torch.launch.train``) at
    ``RESUME_ARCH``'s full width with a checkpoint directory, in children:
    an uninterrupted run beside a run killed by SIGKILL once step
    ``RESUME_KILL_AT``'s checkpoint has committed, which a fresh child then
    resumes.  The resumed step-6 checkpoint must equal the uninterrupted
    one chunk CRC for chunk CRC (any leaf that differs is named with its
    largest error), the resumed steps' loss and gradient-norm lines the
    uninterrupted run's; then that checkpoint restored from a ``meta``
    like onto ``cuda:0`` by ``placements``, every leaf's bits the
    uninterrupted run's.  Prints the children's timelines, each save's
    seconds and GB/s (the training driver's ``save(blocking=False)`` from
    its call to its manifest's commit) and the restores'."""
    import signal

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _array_crcs
    from repro_torch.configs import get_config
    from repro_torch.models.model import meta_params
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.tree import flatten_with_keys, map_tree
    t_phase = time.perf_counter()
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    RESUME_DIR.mkdir(parents=True)
    whole, cut = RESUME_DIR / "uninterrupted", RESUME_DIR / "killed"
    procs = []
    try:
        _, disk, fs = host_room(RESUME_DIR)
        print(f"resume: checkpoints to {fs}, free disk {disk / 2**30:.1f} GiB")
        t0 = time.time()
        uninterrupted = train_child(whole, RESUME_STEPS)
        killed = train_child(cut, 2)
        procs += [uninterrupted, killed]
        # The restore's like and placements, made while the children run.
        like = init_train_state(meta_params(get_config(RESUME_ARCH)),
                                TrainConfig())
        target = (torch.device("cuda", dev.index or 0) if dev.type == "cuda"
                  else dev)
        place = map_tree(lambda _: str(target), like)
        commit = step_dir(cut, RESUME_KILL_AT)
        while not commit.is_dir():
            if killed.poll() is not None:
                check(False, "resume: the run to kill ended before step "
                      f"{RESUME_KILL_AT}'s commit: "
                      f"{killed.communicate()[1][-3000:]}")
            check(time.time() - t0 < 300, "resume: step "
                  f"{RESUME_KILL_AT}'s checkpoint committed within 300 s")
            time.sleep(0.01)
        killed.send_signal(signal.SIGKILL)
        t_kill = time.time()
        killed_out = killed.communicate()[0]
        check(killed.returncode == -signal.SIGKILL,
              f"resume: the run died by SIGKILL (exit {killed.returncode})")
        later = [s for s in range(RESUME_KILL_AT + 1, RESUME_STEPS + 1)
                 if step_dir(cut, s).is_dir()]
        check(not later, f"resume: killed before step {later}'s commit")
        resumed = train_child(cut, 2)
        procs.append(resumed)
        resumed_out = child_done(resumed, "resume: the resumed run")
        t_resumed = time.time()
        whole_out = child_done(uninterrupted, "resume: the uninterrupted run")
        check(f"resumed from step {RESUME_KILL_AT}" in resumed_out,
              f"resume: the run resumed from step {RESUME_KILL_AT}: "
              f"{resumed_out[-2000:]}")
        want, got = step_losses(whole_out), step_losses(resumed_out)
        check(sorted(got) == list(range(RESUME_KILL_AT + 1,
                                        RESUME_STEPS + 1))
              and all(got[s] == want[s] for s in got),
              f"resume: steps {sorted(got)} print the uninterrupted run's "
              f"loss and gnorm ({got} vs {want})")
        launches = json.loads(whole_out.split("LAUNCHES ", 1)[1])
        check(launches["6"] > 0 and launches["6b"] > 0,
              f"resume: kernels 6 and 6b launched ({launches})")
        final = step_dir(whole, RESUME_STEPS)
        nbytes = state_bytes(final)
        for what, out in (("uninterrupted", whole_out),
                          ("killed", killed_out), ("resumed", resumed_out)):
            m = marks(out)
            print(f"resume: {what} run, s after the phase's start: "
                  + ", ".join(f"{k} {t - t0:.2f}" for k, t in m.items()))
            last = [line for line in out.splitlines()
                    if line.startswith("PARTS ")][-1:]
            if last:
                print(f"resume: {what} run's checkpoint seconds by part "
                      f"(summed over threads): {last[0][6:]}")
            for s in range(2, RESUME_STEPS + 1, 2):
                if f"commit{s}" in m:
                    dt = m[f"commit{s}"] - m[f"save{s}"]
                    print(f"resume: {what} run's save of step {s}: "
                          f"{dt:.3f} s from its call to its commit, "
                          f"{nbytes / dt / 1e9:.3f} GB/s")
        m = marks(resumed_out)
        print(f"resume: {RESUME_ARCH} {' '.join(RESUME_FLAGS[2:])}, a "
              f"checkpoint every 2 steps; killed {t_kill - t0:.2f} s after "
              f"the start, once step {RESUME_KILL_AT}'s checkpoint had "
              f"committed (steps printed "
              f"{sorted(step_losses(killed_out))}); the resume "
              f"{t_resumed - t_kill:.2f} s wall from the kill to its exit "
              f"(its start {m['imported'] - m['start']:.2f} s of imports, "
              f"its restore {m['restored'] - m['restore']:.3f} s, "
              f"{nbytes / (m['restored'] - m['restore']) / 1e9:.3f} GB/s); "
              f"uninterrupted run's launches {launches}")
        diffs = leaf_diffs(final, step_dir(cut, RESUME_STEPS))
        n_leaves = len(manifest(final)["arrays"])
        for key, dtype, err in diffs:
            print(f"resume: leaf {key} ({dtype}) differs, largest |resumed "
                  f"- uninterrupted| {err:.6g}")
        check(not diffs, f"resume: the resumed step-{RESUME_STEPS} "
              f"checkpoint equals the uninterrupted one ({len(diffs)} of "
              f"{n_leaves} leaves differ)")
        print(f"resume: the resumed step-{RESUME_STEPS} checkpoint equals "
              f"the uninterrupted one, chunk CRC for chunk CRC ({n_leaves} "
              f"leaves, {nbytes} bytes)")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = CheckpointManager(str(cut)).restore(RESUME_STEPS, like,
                                                    placements=place)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        want = {x["key"]: x["chunk_crcs"] for x in manifest(final)["arrays"]}
        for key, leaf in flatten_with_keys(state):
            host = leaf.cpu()
            bits = (host.view(torch.int16).numpy().view("uint16")
                    if host.dtype == torch.bfloat16 else host.numpy())
            check(leaf.device == target and _array_crcs(bits) == want[key],
                  f"resume: restored leaf {key} on {target}, its bits the "
                  "uninterrupted run's")
        check([t.dtype for _, t in flatten_with_keys(state)]
              == [t.dtype for _, t in flatten_with_keys(like)],
              "resume: restored leaves in the like's dtypes")
        del state
        print(f"resume: restored from a meta like onto {target} by "
              f"placements in {t_restore:.3f} s "
              f"({nbytes / t_restore / 1e9:.3f} GB/s, file to card, CRCs "
              "verified)")
    finally:
        kill_all(procs)
        shutil.rmtree(RESUME_DIR, ignore_errors=True)
    print(f"resume phase: {time.perf_counter() - t_phase:.2f} s")


# Four NCCL ranks save qwen2-1.5b's train state laid out over (data 1,
# model ELASTIC_SAVE_MODEL); two restore it over (data 1, model
# ELASTIC_RESTORE_MODEL).
ELASTIC_DIR = ROOT / "build" / "elastic"
ELASTIC_ARCH = "qwen2-1.5b"
ELASTIC_SAVE_MODEL = 4
ELASTIC_RESTORE_MODEL = 2
ELASTIC_STEP = 5


def elastic_state(cfg, seed: int, dev):
    """``cfg``'s train state on ``dev``: weights from ``seed``, moments
    drawn from ``seed + 1`` (the same on every card of one kind)."""
    from repro_torch.models import Model
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.tree import leaves
    st = init_train_state(Model(cfg, device=dev, seed=seed).params(),
                          TrainConfig())
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        for t in [*leaves(st.opt["m"]), *leaves(st.opt["v"])]:
            t.normal_(generator=gen)
        st.opt["step"].fill_(ELASTIC_STEP)
    return st


def elastic_layout(cfg, params, opt, mesh):
    """The ``placements`` of a train state over ``mesh`` by the sharding
    rules: ``shardings_for`` of ``param_placements`` and
    ``opt_placements``."""
    from repro_torch.distributed import (ShardingRules, opt_placements,
                                         param_placements, shardings_for)
    from repro_torch.train import TrainState
    rules = ShardingRules(mesh=mesh)
    return TrainState(
        params=shardings_for(rules, param_placements(rules, cfg, params)),
        opt=shardings_for(rules, opt_placements(rules, cfg, opt, params)),
        ef=None)


def shard_of(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's slice of ``full`` under ``placements`` (each
    ``Shard(d)`` the mesh coordinate's chunk of dim ``d``)."""
    from torch.distributed.tensor import Shard
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            full = torch.chunk(full, mesh.size(i), dim=p.dim)[
                mesh.get_local_rank(i)]
    return full


def int_bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    if not t.is_floating_point():
        return t
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def elastic_rank(spec: dict) -> int:
    """One rank of the elastic phase (``--elastic-rank``): join the world,
    then save the train state from DTensors or restore it onto this
    world's layout, and print ``ELASTIC_RANK <json>``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models.model import meta_params
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.tree import flatten_with_keys, leaves, map_tree
    rank, world = spec["rank"], spec["world"]
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=spec["init"],
                            rank=rank, world_size=world)
    peak = PeakRss()
    try:
        cfg = get_config(spec["arch"])
        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("data", "model"))
        mgr = CheckpointManager(spec["dir"])
        rep = {"rank": rank}
        if spec["save"]:
            st = elastic_state(cfg, spec["seed"], dev)
            where = elastic_layout(cfg, st.params, st.opt, mesh)
            sharded = map_tree(lambda t, p: distribute_tensor(
                t.detach(), *p, src_data_rank=None), st, where)
            rep["global_bytes"] = sum(t.numel() * t.element_size()
                                      for t in leaves(st))
            rep["shapes"] = [list(t.shape) for t in leaves(st)]
            del st
            torch.cuda.empty_cache()
            dist.barrier()
            t0 = time.perf_counter()
            mgr.save(ELASTIC_STEP, sharded)
            rep["save_s"] = time.perf_counter() - t0
            rep["local_bytes"] = sum(
                t.to_local().numel() * t.element_size()
                for t in leaves(sharded))
        else:
            like = init_train_state(meta_params(cfg), TrainConfig())
            where = elastic_layout(cfg, like.params, like.opt, mesh)
            dist.barrier()
            t0 = time.perf_counter()
            step, got = mgr.restore_latest(like=like, placements=where)
            torch.cuda.synchronize()
            rep["restore_s"] = time.perf_counter() - t0
            rep["step"] = step
            want = elastic_state(cfg, spec["seed"], dev)
            same = map_tree(lambda g, w, p: torch.equal(
                int_bits(g.to_local()), int_bits(shard_of(w.detach(), *p))),
                got, want, where)
            rep["mismatched"] = [k for k, ok in flatten_with_keys(same)
                                 if not ok]
            rep["leaves"] = len(list(leaves(same)))
            rep["sharded"] = sum(g.to_local().shape != w.shape for g, w in
                                 zip(leaves(got), leaves(want)))
            rep["local_bytes"] = sum(
                t.to_local().numel() * t.element_size() for t in leaves(got))
        rep["host_peak_gib"] = peak.stop() / 2**30
        rep["card_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    finally:
        dist.destroy_process_group()
    print("ELASTIC_RANK " + json.dumps(rep), flush=True)
    return 0


def rss_bytes() -> int:
    """This process's resident bytes now (``/proc/self/statm``), 0 where
    the host does not say."""
    import os
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


class PeakRss:
    """The largest of this process's resident bytes, sampled every 0.25 s on
    a thread until ``stop()`` (the card's machine gives no ``VmHWM``, and
    ``ru_maxrss`` counts the parent's resident bytes at the fork)."""

    def __init__(self):
        import threading
        self.peak = rss_bytes()
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._done.wait(0.25):
            self.peak = max(self.peak, rss_bytes())

    def stop(self) -> int:
        self._done.set()
        self._thread.join()
        return max(self.peak, rss_bytes())


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def elastic_world(world: int, save: bool, base: dict) -> list:
    """A world of ``world`` rank processes (``chip_smoke.py
    --elastic-rank``) rendezvousing on a free localhost port; each rank's
    report, in rank order."""
    env = child_env()
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    init = f"tcp://localhost:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--elastic-rank",
         json.dumps(dict(base, rank=r, world=world, save=save, init=init))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for r in range(world)]
    reps = []
    try:
        for r, p in enumerate(procs):
            out = child_done(p, f"elastic rank {r} of {world}", timeout=900)
            reps.append(json.loads(out.split("ELASTIC_RANK ", 1)[1]))
    finally:
        kill_all(procs)
    return reps


def run_elastic(args) -> None:
    """Phase 12b on four cards: qwen2-1.5b's train state at full width
    (bf16 weights from ``--seed``, fp32 moments drawn from ``--seed + 1``)
    laid out over ``(data 1, model 4)`` by ``param_placements`` and
    ``opt_placements`` and saved from DTensors by four NCCL ranks (rank 0
    writes), then restored over ``(data 1, model 2)`` by two from a
    ``meta`` like: every local shard bit for bit its slice of the state
    rebuilt from the seed.  Prints the bytes, the save's and restore's
    seconds and GB/s, and each rank's host and card peaks."""
    t_phase = time.perf_counter()
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    ELASTIC_DIR.mkdir(parents=True)
    base = {"arch": ELASTIC_ARCH, "seed": args.seed, "dir": str(ELASTIC_DIR)}
    try:
        _, disk, fs = host_room(ELASTIC_DIR)
        print(f"elastic: {ELASTIC_ARCH} train state to {fs}, free disk "
              f"{disk / 2**30:.1f} GiB")
        saved = elastic_world(ELASTIC_SAVE_MODEL, True, base)
        d = ELASTIC_DIR / f"step_{ELASTIC_STEP:012d}"
        m = manifest(d)
        nbytes = state_bytes(d)
        check([x["shape"] for x in m["arrays"]] == saved[0]["shapes"]
              and nbytes == saved[0]["global_bytes"],
              "elastic: every leaf written whole (the manifest's shapes "
              "and bytes the state's)")
        check(sorted(p.name for p in ELASTIC_DIR.iterdir())
              == [d.name], "elastic: one committed step, no staging dir")
        save_s = max(r["save_s"] for r in saved)
        print(f"elastic: saved {len(m['arrays'])} leaves, {nbytes} bytes "
              f"({nbytes / 2**30:.3f} GiB), from DTensors over (data 1, "
              f"model {ELASTIC_SAVE_MODEL}) in {save_s:.3f} s ("
              f"{nbytes / save_s / 1e9:.3f} GB/s: gathered, copied to the "
              f"host, CRC'd, written and fsynced by rank 0); local bytes "
              f"by rank {[r['local_bytes'] for r in saved]}; host peak GiB "
              + ", ".join(f"{r['host_peak_gib']:.2f}" for r in saved)
              + "; card peak GiB "
              + ", ".join(f"{r['card_peak_gib']:.2f}" for r in saved))
        back = elastic_world(ELASTIC_RESTORE_MODEL, False, base)
        for r in back:
            check(r["step"] == ELASTIC_STEP and not r["mismatched"],
                  f"elastic: rank {r['rank']} restored step "
                  f"{ELASTIC_STEP}, every local shard bit-equal to its "
                  f"slice ({r['mismatched'][:5]})")
        restore_s = max(r["restore_s"] for r in back)
        print(f"elastic: restored over (data 1, model "
              f"{ELASTIC_RESTORE_MODEL}) from a meta like in {restore_s:.3f}"
              f" s ({nbytes / restore_s / 1e9:.3f} GB/s a rank: each reads "
              f"and CRCs every leaf, then keeps its shard); "
              f"{back[0]['leaves']} leaves, {back[0]['sharded']} sharded, "
              "every local shard "
              f"bit-equal; local bytes by rank "
              f"{[r['local_bytes'] for r in back]}; host peak GiB "
              + ", ".join(f"{r['host_peak_gib']:.2f}" for r in back)
              + "; card peak GiB "
              + ", ".join(f"{r['card_peak_gib']:.2f}" for r in back))
    finally:
        shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    print(f"elastic phase: {time.perf_counter() - t_phase:.2f} s")


# The dry-run phase's cells held against a real step on the card: (arch,
# shape, build_cell's cut) on a one-device mesh; and the bound on the
# traced peak's relative distance from the card's.
DRYRUN_CELLS = {
    "a": ("qwen2-1.5b", "train_4k", dict(global_batch=4, microbatches=2)),
    "b": ("qwen2-1.5b", "decode_32k", dict(global_batch=8)),
}
DRYRUN_PEAK_RTOL = 0.10


def dryrun_cell(name: str):
    """``(cell, meta)`` of dry-run cell ``a`` or ``b`` on a one-device mesh
    (call inside ``fake_world(1)``)."""
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.launch.mesh import make_mesh
    arch, shape, kw = DRYRUN_CELLS[name]
    return build_cell(arch, shape, make_mesh((1, 1), ("data", "model")),
                      **kw)


def dryrun_child(name: str) -> int:
    """One trace of the dry-run phase in a process of its own, on the
    host's CPU: cells ``a`` and ``b`` on a one-device mesh, ``c``
    (mamba2-130m ``train_4k``) on the 16×16 production mesh; prints
    ``DRYRUN <json>``: the record (``cell_result``) and the trace's
    seconds."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    t0 = time.perf_counter()
    if name == "c":
        rec = dryrun.run_cell("mamba2-130m", "train_4k", False)
    else:
        with fake_world(1):
            cell, meta = dryrun_cell(name)
            trace = cell()
        rec = dryrun.cell_result(trace, meta, False, 0.0)
        rec["peak_bytes"] = trace.peak_bytes
    rec["seconds"] = time.perf_counter() - t0
    print("DRYRUN " + json.dumps(rec), flush=True)
    return 0


def spawn_dryrun(name: str):
    """Start trace ``name`` in a child; its output goes to temporary files
    (a pipe no one reads while the card runs other phases would stall it
    once full)."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--dryrun-child", name], stdout=out, stderr=err,
                            env=child_env(), cwd=ROOT)
    proc.logs = (out, err)
    return proc


def stop(procs) -> None:
    """Kill and reap the dry-run children still running; close their
    logs."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        for f in p.logs:
            f.close()


def dryrun_result(proc, name: str) -> dict:
    proc.wait(timeout=600)
    out, err = proc.logs
    out.seek(0)
    err.seek(0)
    lines = [x for x in out.read().splitlines() if x.startswith("DRYRUN ")]
    check(proc.returncode == 0 and lines, f"dry run ({name}): its trace "
          f"ran (exit {proc.returncode}; {err.read()[-2000:]})")
    return json.loads(lines[0].split(" ", 1)[1])


def tree_bytes(*trees) -> int:
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for tree in trees
               for t in leaves(tree))


def dryrun_real(dev, name: str, seed: int) -> dict:
    """Cell ``name``'s step run for real on the card: a warm-up step, a
    timed one (host clock, synchronised) over which the peak of
    ``torch.cuda.max_memory_allocated()`` above the memory before the model
    is read, and one under ``FlopCounterMode``; with the real arguments'
    bytes."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.data import synthetic_batch
    from repro_torch.launch.mesh import fake_world
    from repro_torch.models import Model
    from repro_torch.train import init_train_state, make_train_step
    with fake_world(1):
        cell, _ = dryrun_cell(name)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = Model(cell.cfg, device=dev, seed=seed)
    shape = cell.shape
    if shape.kind == "train":
        state = init_train_state(model.params(), cell.tcfg)
        step = make_train_step(model, cell.tcfg)
        batch = synthetic_batch(cell.dcfg, 0, dev)
        args_bytes = tree_bytes(state.params, state.opt, batch)
        run = lambda: step(state, batch)
    else:
        cache = model.init_cache(shape.global_batch, shape.seq_len)
        tok = torch.zeros((shape.global_batch, 1), dtype=torch.int32,
                          device=dev)
        args_bytes = tree_bytes(model.params(), tok, cache)
        run = lambda: model.decode(tok, shape.seq_len - 1, cache)
    run()
    torch.cuda.synchronize()
    reset_peak()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    with FlopCounterMode(display=False) as fc:
        run()
    torch.cuda.synchronize()
    flops = fc.get_total_flops()
    del model, run
    torch.cuda.empty_cache()
    return dict(ms=ms, peak=peak, flops=flops, args=args_bytes)


def run_dryrun(dev, args, card: str, early=None) -> None:
    """The dry-run phase: the three traces in processes of their own on the
    host's CPU (``early`` holds those started before the phase), the card
    meanwhile running cells (a) and (b) for real; then the checks and lines
    of item 11 of the docstring."""
    t_phase = time.perf_counter()
    procs = dict(early or {})
    procs.update((name, spawn_dryrun(name)) for name in ("c", "a", "b")
                 if name not in procs)
    try:
        real = {name: dryrun_real(dev, name, args.seed)
                for name in DRYRUN_CELLS}
        traced = {name: dryrun_result(p, name) for name, p in procs.items()}
    finally:
        stop(procs.values())
    for name, (arch, shape, kw) in DRYRUN_CELLS.items():
        t, r = traced[name], real[name]
        what = f"dry run ({name}) {arch} {shape}"
        check(t["cost"]["flops_per_device"] == r["flops"],
              f"{what}: traced flops {t['cost']['flops_per_device']:.0f} "
              f"== FlopCounterMode over the real step {r['flops']}")
        check(t["memory"]["argument_bytes"] == r["args"],
              f"{what}: traced argument bytes "
              f"{t['memory']['argument_bytes']} == the real {r['args']}")
        ratio = t["peak_bytes"] / r["peak"]
        check(abs(ratio - 1) <= DRYRUN_PEAK_RTOL,
              f"{what}: traced peak {t['peak_bytes']} within "
              f"{DRYRUN_PEAK_RTOL:.0%} of the card's {r['peak']}")
        lb = t["roofline"]["step_lower_bound_s"] * 1e3
        cut = ", ".join(f"{k} {v}" for k, v in kw.items())
        print(f"dryrun ({name}) {arch} {shape} [{cut}; 1x1 mesh; {card}]: "
              f"flops traced {t['cost']['flops_per_device']:.0f} == measured "
              f"{r['flops']}; argument bytes traced "
              f"{t['memory']['argument_bytes']} == real {r['args']}; peak "
              f"traced {t['peak_bytes'] / 1e9:.4f} GB, measured "
              f"{r['peak'] / 1e9:.4f} GB (traced/measured {ratio:.4f}); step "
              f"{r['ms']:.2f} ms measured, lower bound {lb:.3f} ms "
              f"({t['roofline']['dominant']}), bound/measured "
              f"{lb / r['ms']:.4f}; traced in {t['seconds']:.1f} s")
    c = traced["c"]
    print(f"dryrun (c) mamba2-130m train_4k [16x16 mesh, fake, on the host]: "
          f"{c['memory']['per_device_bytes'] / 1e9:.3f} GB per device "
          f"(fits {c['memory']['fits_hbm']}), dominant "
          f"{c['roofline']['dominant']}, step lower bound "
          f"{c['roofline']['step_lower_bound_s'] * 1e3:.3f} ms, collectives "
          f"{c['collectives']['weighted_bytes'] / 1e9:.3f} GB weighted, "
          f"traced in {c['seconds']:.1f} s")
    print(f"dryrun phase: {time.perf_counter() - t_phase:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
