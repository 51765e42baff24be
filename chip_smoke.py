#!/usr/bin/env python3
"""End-to-end smoke of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (the exit code is not 0 and the last line is
not printed):

1. The card's name and power limit, then the build of the five kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel).
2. Main path: a sift-like corpus (ann-benchmarks sift-128-euclidean scale:
   1M base, 10k queries, 128-d, L2) built into the paper's default Proxima
   index on the card (PQ M=32 x C=256, graph R=64 / build list 128,
   hot_node_fraction=0.03 — 30,000 hot nodes from a 128-query reorder trace
   on the kernels — gap encoding, calibrate_beta): build seconds by stage
   (trace, reorder and gap among them), the launches of the trace and
   calibrate_beta, the gap compression ratio, ``index_bytes()``, the mean
   hot hops and free PQ fetches per query.  Then all queries submitted to
   ``ServingEngine(index, batch_size=256)`` and drained.  Launch counts are zeroed just before and
   read just after; every kernel must have launched, and ``l2_rerank`` once
   a round and once a batch.  Fails if recall@10 against the exact ground
   truth is below 0.5, or if the engine's ids differ from
   ``Searcher.search`` of the same queries.  Then one more batch, with the
   exact-distance entry wrapped, measures the share of rows the round's
   masks ask for (the timed run is never instrumented).
   Continuous phase: the same queries through ``ServingEngine(index,
   batch_size=256, continuous=True, slots=256)`` (submit, then ``step``
   until done): QPS, p50/p99, ticks, mean occupied slots, lane-rounds,
   host seconds per tick and per read of the active flags, recall@10.
   Fails unless every request's ids and distances equal, bit for bit, the
   batch-flush engine's.
   Distributed phase (``repro_torch.core.distributed``, ``launch/``): the
   index sharded round-robin (``shard_corpus``) and 2,048 queries served
   256 at a time through ``Searcher.open(sharded, mesh=, mode=)``: at
   world size 1 over NCCL in this process (a 1x1 mesh), nsp and fetch at
   E=1 and 4, beside a flat ``Searcher`` at the same E (QPS, recall@10,
   launches per kernel a round, bytes handed to the collectives a round,
   each round collective's time); then a (2, 2) mesh of 4 gloo processes
   on the one card (``mesh_rank``; each loads only its own data shard,
   written once as ``.npy``), nsp and fetch at E=1 over the first
   MESH_QUERIES (512) queries (QPS, seconds); then
   ``python -m repro_torch.launch.serve`` at its defaults.  Fails unless
   every world-size-1 run's ids equal the flat search's as sorted sets,
   its recall@10 is >= 0.5, each round launched the lookup (twice in nsp),
   the merge and the masked rerank (twice) and each batch ``pq_adt``
   once, every rank exits 0 with the world-size-1 ids, and the launcher
   exits 0 with its recall line.
   Filtered phase: ``random_attributes(N, {"category": 8, "price": 1000},
   seed=5)`` and four specs — ``isin(category, [0, 1, 2])`` (~37.5%,
   masked, L=512), ``eq(category, 3)`` (~12.5%, masked, L=1024), ``range(price, 0,
   9)`` (~1%, scan) and one no node passes (empty) — 1024 queries each,
   interleaved, through the continuous engine and the batch-flush engine; then each spec alone through ``Searcher.search``
   (strategy, effective L, rounds per lane, launches).  Fails unless the
   two engines agree bit for bit, every returned id passes its filter, the
   strategies and L are as listed, the empty spec returns only padding, and
   filtered recall@10 against an exact filtered kNN on the card is >= 0.5.
   Tiled phase: the same index in 4 channel tiles through
   ``ServingEngine(num_tiles=4, shard_policy=, probe_tiles=)`` — cluster
   tiles at full fan-out and routed to 2 tiles, hash tiles at full fan-out —
   2,048 queries each, through the batched fan-out (the default: one
   traversal of the tiles' 4 x 256 lanes): tile-build seconds (per-tile
   graphs rebuilt on the card), QPS, recall@10, launches and launches a
   batch, cross-tile merges (one sort launch a batch).  Fails unless
   recall@10 >= 0.5, the engine's ids equal ``Searcher.search``'s, 64
   queries on the CPU over the same tiles equal the card's in >= 95% of
   rows, and the merges equal the batches.  Then two A/B comparisons of
   AB_PAIRS (4) alternating pairs of 512 queries through ``Searcher.search``: the
   cluster tiles at full fan-out unrolled (``use_vmap=False``) against
   batched, and the flat index against the batched tiles (QPS of each
   pair, medians and spread, launches and rounds a 256-query batch).
   Fails unless unrolled and batched give the same ids, distances,
   ``probed`` and per-tile counters, bit for bit.
   IVF phase (``repro_torch.core.ivf``, the paper's Fig. 11 baseline, with
   fig11's settings): ``build_ivf`` of the corpus on the card (nlist=64, PQ
   32 x 256 with 8 k-means iterations, residual; seconds by stage, list
   lengths), then 2,048 queries through ``search_ivf`` at nprobe 2, 8 and
   16: recall@10 beside the flat graph's on the same queries, QPS, rows
   scanned a query, launches.  Fails unless ``pq_adt`` and ``pq_lookup``
   launched at every nprobe and 64 queries on the card give the ids and
   scanned counts of the same index on the CPU (plain versions), with
   distances at rtol 1e-4.
   Segmented phase: ``build_segmented`` of the corpus's first 250,000
   vectors (the ground truth recomputed over them) in 2 segments of
   125,000 on the card, 16,384 stitch anchors a joining segment (stage and
   stitch seconds, patched rows), 2,048
   queries served tiled through the segments (the checks above) and flat
   through ``to_flat()``; recall@10 >= 0.5 for both.
   Observability phase (``repro_torch.obs``, ``repro_torch.nand``): 2,048
   queries through the batch engine with ``Observability.on(quality=True,
   quality_sample_rate=1.0)`` and again with obs off; the continuous
   engine with ``convergence=True``; the cluster tiles (the tiled phase's)
   at full fan-out with obs on, and one batch's channel traces through
   ``simulate_sharded``; the segmented index's ``build_trace()`` through
   ``simulate_build``; then ``Observability.on()`` against obs off, 3
   alternating pairs on the same engines.  Fails unless obs-on ids and
   distances equal obs-off's bit for bit, ``kernel_calls`` equals the
   launches and every kernel has in-search ``kernel_wall_ms`` samples,
   every query of each run is billed (no unbilled batch, no shadow error),
   the shadow recall is within 0.002 of recall@10 against the exact ground
   truth, the convergence log holds one record per lane-round (and the
   continuous ids equal the batch engine's), every (tile, query) lane is
   served, ``simulate_sharded`` reports 4 channels and the build trace's
   stitched rows are the stitch's patched rows.  Prints the NAND model's
   medians per plan kind (model QPS, latency, pJ per query, core
   utilisation: output of ``nand/simulator.py`` fed with this run's
   counters, not times of any device), the in-search ``kernel_wall_ms``
   medians per kernel and the QPS pairs.
   Streaming phase (``repro_torch.stream``): a ``MutableIndex`` over the
   index at ``StreamConfig``'s defaults but a delta capacity of
   STREAM_DELTA_CAPACITY, 512 (list 32, brute force below 64, over-fetch
   16), served by ``ServingEngine(mutable,
   batch_size=256)`` and the continuous engine (slots=256), both with
   ``auto_consolidate=False``.  10,000 random base ids and each of the
   first 2,048 queries' exact top-1 are deleted, 512 vectors (a random
   base vector plus N(0, 0.1^2) noise) inserted through the continuous
   engine, filling the delta; 512 queries and 256 of the inserted vectors
   are served through both engines and ``merged_search_kernel``; then with
   256 lanes in flight the 513th insert consolidates inside ``insert``
   (the base rebuilt on the card) and the same sets are served again.
   Prints inserts a second, merged QPS beside the flat engine's, the delta
   search's share of the wall time, recall@10 against the exact kNN of
   ``live_vectors()``, the consolidation's seconds by build stage, device
   memory around it and the write amplification.  Fails if a tombstoned id
   is returned, the engines differ from each other or from
   ``merged_search_kernel``, recall@10 is below 0.5, the merge drops an
   inserted vector that its segment's own search found, fewer than
   STREAM_SELF_FLOOR of the inserted vectors find themselves, the engine's
   stats are not 1 consolidation / capacity + 1 inserts / every delete, a
   lane in flight was not retired before the rebuild, the old base's corpus is
   still allocated when the rebuild starts, the rebuild's peak exceeds one
   build's on top of what remains, device memory grew across it, or the
   sort entry did not launch once per merged batch.
   Model phase (``repro_torch.models``, ``model_phase``): each of the ten
   architectures' smoke configs in f32 (TF32 off) and bf16, one set of
   seeded weights on the card and on the CPU, through ``prefill``, 4
   ``decode_step``s and, for the five archs that support it,
   ``prefill_chunked``: the card's logits against the CPU's at 1e-3 (f32)
   and 5e-2 (bf16; the hybrid's 0.15, PERF.md).  Then PaliGemma-3B at full
   width in bf16 (18 layers, d 2048, 8 heads, 1 KV head, head_dim 256,
   d_ff 16,384, vocab 257,216, 256 x 1152 patch embeddings, softcap 30;
   weights from a seeded generator on the card): 8 requests of 256
   patches + 32 tokens through ``prefill`` (max_len 320) and 32 greedy
   decode steps (prefill ms, median decode ms, tokens a second, KV-cache
   bytes, peak memory); the same requests on an f32 copy, its decode
   logits against one teacher-forced forward within 1e-3 of the largest
   |logit|.  Then the same requests through the sharded serving steps
   (``serve_sharded``: ``serve_params``, ``make_prefill_step``,
   ``make_serve_step``): on a (1, 1) NCCL mesh, 32 greedy steps whose
   tokens, logits and cache must equal the unsharded run's bit for bit
   (prefill and decode ms beside the unsharded ones); then a (2, 2) mesh
   of 4 gloo processes on the one card (``serve_mesh_rank``: the model
   from the same seed, each rank 4 rows, 4 q heads, 160 of the cache's 320
   positions and 128,608 of the vocabulary), 2 decode steps fed the
   one-rank greedy tokens: fails unless every rank exits 0, each greedy
   token is the one-rank token or a tie within the zoo's bf16 bar, and the
   logits are no further from an f32 copy's (fed the same tokens) than
   the one-rank bf16 run's are, plus that bar's atol (ms a step,
   collective bytes a step, the cache's local bytes; the logits' distance
   from the one-rank run's).  Then
   ``examples/image_retrieval.py`` at scale: 8,192
   synthetic images (256 classes x 32, class centres N(0, 1), noise 0.3,
   4 prompt tokens) embedded 64 at a time and pooled over the patches,
   indexed by ``EmbeddingRetriever(metric="angular")`` on the card (PQ 32
   x 256 at dsub 64, R=32), 1,024 fresh images searched 256 at a time:
   images a second, build seconds by stage, recall@10 against the exact
   angular kNN over the embeddings, label purity of the top 5, QPS,
   launches.  Fails on any disagreement, below recall@10 0.5, or if a
   kernel never launched on the retrieval; the models are freed before
   the kernel phase.  The zoo's SSM and hybrid configs run the selective
   scan kernel on the card against the plain scan on the CPU.
   SSM phase (``ssm_phase``): zamba2-1.2B (arXiv 2411.15242: 38 layers, 32
   of them Mamba-2, d 2048, d_inner 4096, 64 heads of 64, state 64, a
   shared attention block every 6) and falcon-mamba-7b (arXiv 2410.05355:
   64 Mamba-1 layers, d 4096, d_inner 8192, state 16) at published width
   and depth in bf16, weights from seed 0: 8 (falcon-mamba: 2) requests of
   2,048 tokens through ``prefill_chunked`` in one segment, then 32 (8)
   greedy decode steps: prefill ms and tokens a second, decode ms a step
   and tokens a second, the cache's bytes, peak memory, and the scan's
   launches (counted from zero over the timed round: one a Mamba layer in
   the prefill and in each step, else the phase fails); zamba2's f32 copy's
   decode logits against one teacher-forced forward within 1e-3 of the
   largest |logit|.  zamba2's prefill runs the scan's SSD kernel (Mamba-2,
   the chunked matrix form on the tensor cores), its decode and every
   falcon-mamba call the step kernel: the launches are counted by kernel
   and the phase fails on any other route.  Last of the whole run, after
   the profiles below (``scan_phase``), the scan's kernels against the
   plain loop at the layers' shapes — zamba2's (B=8, S=2,048, d_inner
   4,096, state 64, 64 heads) from a zero and a carried state and its
   train microbatch (2, 4,096), falcon-mamba's (8, 2,048, 8,192, 16) and
   its served (2, 2,048), each model's decode step (S=1) and S=300 (no
   multiple of the chunk) — within 1e-5 of the largest |y| and |h_last|,
   each entry's route (SSD or step) printed and every zamba2 entry with S
   > 1 on the SSD route, else the phase fails: events and CUPTI ms, the
   plain version's ms (the SSD entries': their chunked plain version's,
   and the loop's beside it), the bound (bytes at 3.35 TB/s, exps at the
   special-function units' rate or the SSD form's products, each once, at
   495 TFLOP/s TF32, the largest; the SSD kernels' three-pass products at
   that rate beside it, as the design's floor).  Then the backward kernels
   against the plain backward at both models' layer widths — zamba2's train
   microbatch (B=2, S=4,096) and falcon-mamba's (2, 2,048), each from a
   zero and a carried state, S=1 and S=300 — each gradient within 1e-5 of
   its largest magnitude, two runs of zamba2's (2, 4,096) bit-equal; the
   zero-state cases timed as the forward's.
   Train phase (``repro_torch.train``, ``ckpt``, ``distributed``,
   ``launch/train.py``; ``train_phase``), after the models are freed: (a)
   one ``make_train_step`` step (2 microbatches) of each architecture's
   smoke config in f32 (TF32 off), one set of weights and one step-seeded
   batch on the card and on the CPU: the loss within 1e-5 relative, each
   leaf's gradient within 1e-4 of its largest |g| (SSM and hybrid 1e-3).
   (b) StableLM-1.6B at its published width and depth
   (hf:stabilityai/stablelm-2-1_6b: 24 layers, d 2048, 32 heads, d_ff
   5,632, vocab 100,352; bf16 weights from seed 0, f32 moments) through
   the launcher's path (``launch.train.train``): AdamW(lr=1e-3, warmup 5,
   20 steps), 2 microbatches, ``DataConfig(seq_len=4097, global_batch=4,
   copy_period=16)`` (train_4k's sequence; its global batch of 256 cut to 4
   for time), 20 steps: step ms (median of steps 3-20), tokens a second,
   model TFLOP/s (6 N T plus attention over full 4,096 blocks) and their
   share of 989, peak memory, loss and grad-norm each step.  Fails on a
   non-finite loss or unless the mean of the last 5 losses is >= 0.3 below
   the first.  (b') zamba2-1.2B at published width and depth the same
   way, 12 steps (the SSM phase's model): step ms (median of steps 3-12),
   tokens a second, peak memory, losses; fails on a non-finite loss, unless
   the mean of the last 3 losses is >= 0.3 below the first, unless the
   scan's SSD backward kernel launched once a Mamba layer a microbatch in
   every step and its SSD forward at least that often, if a step kernel of
   the scan launched (counted over step 2), or if an op of the scan's
   plain versions ran on the card (step 2).  (c) ``FaultTolerantLoop`` over ``custom_dense_config(100)``
   (d 704, 11 layers), checkpoints every 5 steps (async) under
   ``chiprun_out/train_ckpt`` (removed after), a NaN written into ``ln_f``
   before step 7: fails unless the run ends at step 15 with exactly one
   restart, ``restore_checkpoint`` of the last checkpoint equals the live
   state bit for bit, and 5 steps replayed from the checkpoint at step 10
   give the loop's losses within 1e-3 relative (not bit for bit: the
   embedding's backward adds with atomics on the card).  (d)
   ``elastic_restore`` of that checkpoint onto a one-card ``DeviceMesh``
   (NCCL, world size 1): DTensors placed by the resolved specs whose full
   tensors equal the live state (a checkpoint of its parameters).  (e)
   The sharded step (``train_sharded``): (b)'s model, optimizer and data
   with the state held by ``shard_state`` and SHARDED_STEPS steps through
   ``make_train_step(..., mesh, param_shardings=...)`` on a (1, 1) NCCL
   mesh (NCCL takes one rank a card; the multi-rank meshes are the CPU
   tests' gloo ones): fails unless its losses are within 1e-3 relative of
   (b)'s first steps (whether they are bit-equal is printed); step ms and
   peak bytes.  (f) The dry-run (``start_dryrun``, six processes of
   their own started as the train phase starts, after the phases that
   measure QPS and latency on the host; fake tensors over fake process
   groups, no card): ``python -m repro_torch.launch.dryrun`` over
   StableLM-1.6B's train_4k cell on the (16, 16) and (2, 16, 16)
   production meshes and over zamba2-1.2B's and falcon-mamba-7b's at full
   depth on (16, 16), (b)'s own cell on a (1, 1) mesh, and the serving
   cells on (16, 16) (``dryrun_serve``: StableLM's prefill_32k and
   decode_32k, PaliGemma's decode_32k): fails unless the production
   records, the two SSM train cells and the three serving cells are "ok"
   (the first with FLOPs and collective bytes; each SSM cell's trace
   seconds are printed) and the (1, 1) trace's peak bytes are within 25%
   of (e)'s
   measured peak (each serving cell's bottleneck, collective bytes by
   kind, traced peak and ``kv_bytes_local`` are printed);
   per-device FLOPs, collective bytes by kind, peak bytes, bottleneck, and
   the (1, 1) trace's dot FLOPs beside (b)'s model FLOPs and (e)'s step ms
   are printed.
   Every kernel must launch on each path (launches zeroed before each).
3. Kernel phase: each kernel at the main path's shapes (Q=256 queries, D=128,
   M=32, C=256, dsub=4, R=64 neighbours, L=128 list, a 1M-row base) against
   its plain PyTorch version on the same inputs: ADT and lookup at rtol/atol
   1e-4, rerank at 1e-4/1e-3, the sort and the merge exactly (ties, +inf
   padding, -0.0 beside +0.0).  The lookup is checked and timed with and
   without the round's "fresh" mask; ``bitonic_sort_pairs`` as the merge the
   round runs, (L=128, n=64) and (L=128, n=256), and as a plain sort at
   P=256; ``l2_rerank``'s masked entry at the density phase 2 measured and
   with every row asked for, and its reference signature on pre-gathered
   rows.  The filtered paths' shapes too: the merge at (L=512, n=64) and
   (L=1024, n=64, the rank merge), the masked entry at K=1024 at the
   masked search's density, the lookup over the scan's (Q=256, S=16384)
   rows.  The new call sites of this index: ``pq_adt`` at Q=1 and the
   lookup at (1, 64) (the reorder trace), the lookup at (256, 512)
   (``calibrate_beta``), ``l2_rerank_masked`` at (1, 16) (the trace's exact
   distances), the sort entry at the cross-tile merge's (256, 64), with
   ties, duplicate ids keyed +inf and -1 padding, and at the base/delta
   merge's (256, 26 + 26 padded to 64).  The batched tile fan-out's
   round: the lookup, the merge (L=128, n=64) and the masked rerank at
   4 x 256 = 1,024 lanes.  The IVF search's: ``pq_adt`` over one chunk's
   (Q x nprobe) residuals and the lists entry over that chunk's (Q,
   nprobe) probed lists, the IVF phase's own arguments, and beside it the
   gather entry IVF took before (Q x nprobe, max_len) on the same chunk.
   ``pq_adt`` also at dsub 8 and 16 (Q=256, M=32).  The distributed round's, on
   one round's arguments from the distributed phase: the lookup over the
   shard's codes, over the hot replica and over fetch's fetched table, the
   masked rerank over the shard's base and over the hot replica.  The
   image retriever's, on one round's arguments from the model phase:
   ``pq_adt`` at (256, 2048) x (32, 256, 64), angular; the lookup at
   n=32; the merge at (L=64, n=32); the masked rerank at D=2048 over the
   8,192 embeddings.  Each entry is timed over
   30 launches, the 50 MB L2 cache flushed
   before each and the launch queued behind a spin: by CUDA events around
   each launch (``ms``) and, for the same launches, by the kernel's own
   device duration from ``torch.profiler`` (``cupti_ms``); beside them the
   plain version's time and, where PyTorch calls compute the same function,
   their times.  A near-empty kernel timed the same way gives the floor of
   both columns.
4. Cross-device check: 64 queries through the same search on the CPU (plain
   versions); at least 95% of top-10 rows must equal the card's.
5. The loop-control cost: one batch through ``graph_search`` (host check of
   "any lane active" every DONE_CHECK_EVERY rounds) and through
   ``graph_search_stepped`` (a check every round), in turns; then one batch
   under ``torch.profiler`` (launches per round, device busy share); then
   60 continuous-engine ticks on a full pool with the host time of each
   part of a tick, and 60 under the profiler (launches, syncs per tick).

The line before last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Details (the full record, ptxas
reports, profiler tables) go to ``--out-dir``, ``results/chip_smoke/`` by
default.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
REORDER_SAMPLES = 128            # build_index's default trace sample
SHARD_QUERIES = 2048             # of the 10,000, for the smoke's time
NUM_TILES = 4
TILED_VARIANTS = (("cluster", 0), ("cluster", 2), ("hash", 0))
# alternating A/B pairs of the fan-out (10 until the sharded-training
# phases: the smoke's time limit's cut of the A/B's depth, PERF.md)
AB_PAIRS = 4
AB_QUERIES = 512                 # queries an arm of a pair
IVF_NLIST = 64                   # fig11's IVF-PQ baseline
IVF_NPROBES = (2, 8, 16)
IVF_CHECK_QUERIES = 64           # card against CPU, at nprobe 8
SEGMENT_SIZE = 125_000
# the segmented phase builds the corpus's first SEGMENTED_BASE vectors (2
# segments), the smoke's time limit's cut of its depth (500,000 before,
# PERF.md)
SEGMENTED_BASE = 250_000
# boundary anchors a joining segment stitches (BuildConfig's default is 32:
# the stitched 1M graph then stays inside segment 0, recall@10 0.2339 on an
# H100, PERF.md)
STITCH_SAMPLE = 16384
FP32_FLOP_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
# the streaming phase: base ext ids deleted at random (each served query's
# exact top-1 too), queries served before and after the consolidation, and
# inserted vectors served as queries
STREAM_DELETES = 10_000
# the delta's capacity, the inserts that fill it (StreamConfig's default is
# 4,096): the smoke's time limit's cut of the streaming path's depth (1,024
# before: 51-79 s of inserts on the card's hosts; 4,096 ran 8.8-13.6 a
# second, 301-463 s, PERF.md).  Merged QPS over this delta is not
# comparable with a larger delta's
STREAM_DELTA_CAPACITY = 512
STREAM_QUERIES = 512             # of the 10,000: the host's delta search
STREAM_SELF_QUERIES = 256
# the share of inserted vectors that must find themselves, before the
# consolidation (the delta's search) and after (the rebuilt base graph's):
# the reference's delta search found 0.992-1.000 of 256 over seeds 1-5 at
# STREAM_DELTA_CAPACITY inserts (0.949-0.980 at 4,096, a miss rate near
# 3.7%; tests/_delta_self_recall.py on the CPU, PERF.md); 0.9 is ~5
# standard deviations of a 256-query share below the 4,096-insert rate
STREAM_SELF_FLOOR = 0.9


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class _Flush:
    """Writes 64 MiB between timed launches so each finds L2 cold."""

    def __init__(self, torch, dev):
        self.buf = torch.empty(1 << 24, dtype=torch.float32, device=dev)

    def __call__(self):
        self.buf.fill_(1.0)


SPIN_CYCLES = 2_000_000          # ~1 ms of device time at 1.98 GHz
SPIN_SYMBOL = "spin_kernel"      # torch.cuda._sleep's kernel


def _time_ms(torch, fn, flush, symbol=None, reps=30, warmup=3):
    """Median device milliseconds of one call of ``fn``, from CUDA events
    around the call.  Before each call the L2 is flushed and the device is
    kept busy by a ~1 ms spin, so the events time the device work of ``fn``
    and not the host's time to enqueue it.

    With ``symbol`` (a substring of a kernel's name) the same launches run
    under ``torch.profiler`` and the result is (events ms, CUPTI ms): the
    second is the median of that kernel's own device duration, which leaves
    out the launch gap that the events also count.  A tuple of symbols (a
    call that launches several kernels) sums their medians."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    times = []

    def run():
        for _ in range(reps):
            flush()
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))

    if symbol is None:
        run()
        return _median(times)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    symbols = symbol if isinstance(symbol, tuple) else (symbol,)
    return _median(times), sum(_cupti_ms(torch, prof, sym, reps)
                               for sym in symbols)


def _cupti_ms(torch, prof, symbol: str, reps: int) -> float:
    """The median device duration of the kernels named with ``symbol`` in
    ``prof``'s records (``_time_ms``)."""
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == cuda and symbol in e.name]
    if symbol == SPIN_SYMBOL:               # drop the ~1 ms spins
        kern = [t for t in kern if t < 0.1]
    # the profiler has been seen to drop one kernel record in a few
    # thousand: take the median of those it kept, unless most are missing
    if len(kern) != reps:
        print(f"profiler kept {len(kern)} of {reps} launches of {symbol!r}",
              file=sys.stderr)
    if len(kern) < reps // 2:
        raise AssertionError(f"profiler saw {len(kern)} launches of "
                             f"{symbol!r}, expected {reps}")
    return _median(kern)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _mask_rows(mask, window: int = 32) -> dict:
    """Where a (Q, K) rerank mask's rows fall: how many in all, how many
    queries ask, and the most of one query and of one window of
    ``window`` candidates (scripts/retriever_round.py profiles a search's
    every call)."""
    per_q = mask.sum(1)
    k = mask.shape[1]
    per_w = mask[:, : k // window * window].reshape(
        mask.shape[0], -1, window).sum(2) if k >= window else per_q[:, None]
    return {"rows": int(per_q.sum()), "queries": int((per_q > 0).sum()),
            "max_query": int(per_q.max()), "max_window": int(per_w.max())}


def _bound(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, dev, n_base: int, rerank_density: dict,
                 filter_density: dict, scan_pass: int, ivf_inputs: dict,
                 dist_inputs: dict, retr_inputs: dict, seed: int = 0) -> list:
    """Each kernel vs its plain version at the main path's shapes; raises
    on a disagreement.  Returns one record per kernel (launches filled in
    from the main path): the top-level numbers are those of the entry the
    search's round runs, and ``entries`` holds every entry timed.  The
    rerank's masked entry runs at the shares of rows that the round's and
    the margin's masks ask for on the main path (``rerank_density``), and
    at K=1024 at the masked search's share (``filter_density``); the
    filtered paths' merges at L=512 and 1024 and the scan's lookup over
    the ``scan_pass`` passing rows, padded to a power of two as the scan
    pads them, are entries too; so are the batched tile fan-out's round
    (the lookup, merge and masked rerank at NUM_TILES x Q lanes) and the
    IVF search's launches (``ivf_inputs``: the arguments of one chunk's
    ``pq_adt`` and ``pq_lookup_lists``, as the IVF phase made them; the
    gather entry IVF took before runs on the same chunk) and the distributed
    search's call sites (``dist_inputs``: one round's arguments of each,
    as the distributed phase made them at world size 1) and the image
    retriever's (``retr_inputs``: one round's arguments of each kernel over
    the 2048-d angular embeddings, as the model phase made them)."""
    from repro_torch.core.search import next_pow2
    from repro_torch.kernels import bitonic_topk, ops

    q, d, m, c, r, l = 256, 128, 32, 256, 64, 128
    inf = float("inf")
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def signed(x):
        """Flip about half the signs: negative keys, -0.0 beside +0.0."""
        return torch.where(rand(*x.shape) < 0.5, -x, x)

    def ints(lo, hi, shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    queries = torch.randn(q, d, generator=g, device=dev)
    cents = torch.randn(m, c, d // m, generator=g, device=dev)
    codes = ints(0, c, (n_base, m), torch.uint8)
    base = torch.randn(n_base, d, generator=g, device=dev)
    nbr = ints(0, n_base, (q, r), torch.int32)
    fresh = rand(q, r) < 0.5
    cand = ints(0, n_base, (q, l), torch.int32)
    # the sort's keys: L sorted list entries, R fresh ones, +inf padding to
    # 256, with ties from repeated values and -0.0 beside +0.0
    p = 256
    keys = signed(ints(0, 512, (q, p)).float())
    keys[:, l + r:] = inf
    keys[:, :l] = keys[:, :l].sort(dim=1).values
    pos = torch.arange(p, dtype=torch.int32, device=dev).expand(q, p).contiguous()
    flush = _Flush(torch, dev)
    out = []

    def entry(label, symbol, got, want, rtol, atol, kernel, plain, libraries,
              nbytes, flops):
        """Hold ``got`` against ``want`` (a tuple: exactly), then time the
        kernel (events and CUPTI, ``symbol`` names its kernel), its plain
        version and each library yardstick."""
        torch.cuda.synchronize()
        if isinstance(got, tuple):
            if not all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(got, want)):
                raise AssertionError(f"{label}: kernel differs from its "
                                     "plain version (stable sort)")
            err = rel = 0.0
        else:
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                       msg=lambda s: f"{label}: {s}")
            fin = torch.isfinite(want)          # masked entries are +inf
            diff = (got - want)[fin].abs()
            err = float(diff.max())
            rel = float((diff / want[fin].abs().clamp(min=1e-6)).max())
        bound_ms, bound_by = _bound(nbytes, flops)
        lib = {k: _time_ms(torch, f, flush) for k, f in libraries.items()}
        ms, cupti_ms = _time_ms(torch, kernel, flush, symbol)
        return {
            "entry": label, "max_abs_err": err, "max_rel_err": rel,
            "rtol": rtol, "atol": atol, "ms": ms, "cupti_ms": cupti_ms,
            "plain_ms": _time_ms(torch, plain, flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": next(iter(lib.values()), None), "library": lib,
        }

    def record(name, source, replaces, main, *others):
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0}
        rec.update({k: v for k, v in main.items() if k != "entry"})
        rec.update(kernel_ms=main["ms"], main_entry=main["entry"],
                   entries=[main, *others])
        out.append(rec)

    # ---- pq_adt: the batch's (Q=256, also calibrate_beta's) and the
    # reorder trace's (one sampled base vector a search, Q=1) -------------
    def adt_entry(label, qq, cents=cents, metric="l2"):
        nq, dd = qq.shape
        mm, cc, dsub = cents.shape
        qsub = qq.reshape(nq, mm, dsub).transpose(0, 1).contiguous()
        lib = ({"cdist": lambda: torch.cdist(qsub, cents)}  # sqrt of the table
               if metric == "l2" else
               {"bmm": lambda: torch.bmm(qsub, cents.transpose(1, 2))})
        # the search's aligned dsub=4 codebooks, or the wide kernel
        symbol = ("pq_adt_kernel" if dsub == 4 and cents.data_ptr() % 16 == 0
                  else "pq_adt_wide_kernel")
        return entry(
            label, symbol, ops.pq_adt(qq, cents, metric),
            ops.pq_adt_plain(qq, cents, metric), 1e-4, 1e-4,
            lambda: ops.pq_adt(qq, cents, metric),
            lambda: ops.pq_adt_plain(qq, cents, metric), lib,
            4 * (nq * dd + mm * cc * dsub + nq * mm * cc),
            (3 if metric == "l2" else 2) * nq * mm * cc * dsub)

    ivf_res, ivf_cents, _ = ivf_inputs["adt"]
    retr_adt = retr_inputs["pq_adt"]
    retr_lookup = retr_inputs["pq_lookup_gather"]
    retr_merge = retr_inputs["bitonic_merge_topl"]
    retr_rerank = retr_inputs["l2_rerank_masked"]
    record("pq_adt", "src/repro_torch/kernels/csrc/pq_adt.cu",
           "src/repro/kernels/pq_adt.py:38", adt_entry("pq_adt", queries),
           adt_entry("pq_adt_Q1_trace", queries[:1]),
           adt_entry(f"pq_adt_ivf_Q{ivf_res.shape[0]}", ivf_res, ivf_cents),
           adt_entry(f"pq_adt_retriever_Q{retr_adt[0].shape[0]}"
                     f"_D{retr_adt[0].shape[1]}", *retr_adt),
           # the wide kernel at the subspaces between (Q=256, M=32)
           *(adt_entry(f"pq_adt_dsub{w}", torch.randn(q, m * w, generator=g,
                                                       device=dev),
                       torch.randn(m, c, w, generator=g, device=dev))
             for w in (8, 16)))

    # ---- pq_lookup (the search's gather entry, masked and not) -----------
    adts = ops.pq_adt(queries, cents, "l2")
    offs = torch.arange(m, device=dev) * c
    flat_idx = codes[nbr.long()].long() + offs                # (Q, R, M)
    adt_flat = adts.reshape(q, 1, m * c).expand(q, r, m * c)

    def touched(ids, table, mask):
        """ADT entries the rows the mask asks for read, once a lane."""
        total = 0
        for s in range(0, ids.shape[0], 64):
            idx = table[ids[s : s + 64].long()].long() + offs     # (b, n, M)
            idx = torch.where(mask[s : s + 64, :, None], idx, m * c)
            used = torch.zeros((idx.shape[0], m * c + 1), dtype=torch.bool,
                               device=dev)
            total += int(used.scatter_(1, idx.reshape(idx.shape[0], -1),
                                       True)[:, :-1].sum())
        return total

    def lookup_bytes(ids, table, mask):
        """ids + mask + M code bytes of each distinct row the mask asks for
        + the ADT entries the scored rows touch + the output, each once (a
        row that many lanes score, as IVF's probed lists are, is read once)."""
        return (9 * ids.numel() + int(torch.unique(ids[mask]).numel()) * m
                + 4 * touched(ids, table, mask))

    def gather_entry(label, ids, table, lane_adts, mask):
        """The masked gather entry at another call site's shape, with the
        whole function in PyTorch calls as the library yardstick."""
        nl, n = ids.shape
        flat = lane_adts.reshape(nl, 1, m * c).expand(nl, n, m * c)
        return entry(
            label, "pq_lookup_gather_kernel",
            ops.pq_lookup_gather(ids, table, lane_adts, mask),
            ops.pq_lookup_gather_plain(ids, table, lane_adts, mask),
            1e-4, 1e-4,
            lambda: ops.pq_lookup_gather(ids, table, lane_adts, mask),
            lambda: ops.pq_lookup_gather_plain(ids, table, lane_adts, mask),
            {"codes_gather_sum": lambda: torch.where(mask, flat.gather(
                2, table[ids.long()].long() + offs).sum(-1), inf)},
            lookup_bytes(ids, table, mask), int(mask.sum()) * m)

    # IVF's chunk: the probed lists as the lists entry takes them, and as
    # rows of the (nlist*max_len, M) table and a mask, as the gather entry
    # took them before the lists entry (one ADT a probe: residual)
    probes, lengths, list_codes, ivf_adts = ivf_inputs["lists"]
    max_len = list_codes.shape[1]
    slots = torch.arange(max_len, dtype=torch.int32, device=dev)
    lens = lengths[probes.long()]
    ivf_rows = (probes[:, :, None] * max_len + slots).reshape(
        ivf_adts.shape[0], -1)
    ivf_mask = (slots < lens[..., None]).reshape(ivf_adts.shape[0], -1)
    ivf_table = list_codes.reshape(-1, m)
    ivf_flat = ivf_adts.reshape(ivf_adts.shape[0], 1, m * c).expand(
        ivf_adts.shape[0], ivf_rows.shape[1], m * c)
    read = torch.unique(probes[lens > 0]).long()
    lists_ivf = entry(
        f"lists_ivf_Q{probes.numel()}_n{max_len}", "pq_lookup_lists_kernel",
        ops.pq_lookup_lists(probes, lengths, list_codes, ivf_adts),
        ops.pq_lookup_lists_plain(probes, lengths, list_codes, ivf_adts),
        1e-4, 1e-4,
        lambda: ops.pq_lookup_lists(probes, lengths, list_codes, ivf_adts),
        lambda: ops.pq_lookup_lists_plain(probes, lengths, list_codes,
                                          ivf_adts),
        # the gather entry's yardstick on the same chunk: code-row gather +
        # ADT gather + sum + where
        {"codes_gather_sum": lambda: torch.where(ivf_mask, ivf_flat.gather(
            2, ivf_table[ivf_rows.long()].long() + offs).sum(-1), inf)},
        # probes, the probed lengths, each probed list's real code rows
        # once, the ADT entries they touch, the (Q, P, max_len) output
        4 * probes.numel() + 4 * read.numel()
        + int(lengths[read].sum()) * m
        + 4 * touched(ivf_rows, ivf_table, ivf_mask)
        + 4 * probes.numel() * max_len,
        int(lens.sum()) * m)
    lists_ivf["valid_share"] = float(ivf_mask.float().mean())

    libraries = {
        # code rows gathered beforehand, outside the timed call
        "gather_sum_pregathered": lambda: adt_flat.gather(2, flat_idx).sum(-1),
        # the whole function: code-row gather, ADT gather, sum
        "codes_gather_sum": lambda: adt_flat.gather(
            2, codes[nbr.long()].long() + offs).sum(-1),
    }
    masked = entry(
        "gather_masked", "pq_lookup_gather_kernel",
        ops.pq_lookup_gather(nbr, codes, adts, fresh),
        ops.pq_lookup_gather_plain(nbr, codes, adts, fresh), 1e-4, 1e-4,
        lambda: ops.pq_lookup_gather(nbr, codes, adts, fresh),
        lambda: ops.pq_lookup_gather_plain(nbr, codes, adts, fresh),
        {k: (lambda f=f: torch.where(fresh, f(), inf))
         for k, f in libraries.items()},
        lookup_bytes(nbr, codes, fresh), int(fresh.sum()) * m)
    masked["fresh_share"] = float(fresh.float().mean())
    everything = torch.ones_like(fresh)
    # the scan: every query scores the same S rows, n_pass of them real
    n_pass, scan_rows = scan_pass, next_pow2(scan_pass)
    sel = torch.randperm(n_base, generator=g, device=dev)[:scan_rows]
    sel = sel.sort().values.to(torch.int32)
    sel_ids = sel.expand(q, scan_rows).contiguous()
    sel_valid = (torch.arange(scan_rows, device=dev) < n_pass).expand(
        q, scan_rows).contiguous()
    sel_flat = (codes[sel[:n_pass].long()].long() + offs)          # (S', M)
    adts_2d = adts.reshape(q, m * c)
    scan = entry(
        f"scan_S{scan_rows}", "pq_lookup_gather_kernel",
        ops.pq_lookup_gather(sel_ids, codes, adts, sel_valid),
        ops.pq_lookup_gather_plain(sel_ids, codes, adts, sel_valid),
        1e-4, 1e-4,
        lambda: ops.pq_lookup_gather(sel_ids, codes, adts, sel_valid),
        lambda: ops.pq_lookup_gather_plain(sel_ids, codes, adts, sel_valid),
        # the passing rows' codes gathered beforehand; ADT gather + sum
        {"index_sum": lambda: adts_2d[:, sel_flat].sum(-1)},
        # the S ids and mask once (the same for every query), the (Q, S)
        # output, each passing row's codes once, the whole ADT
        5 * scan_rows + 4 * q * scan_rows + n_pass * m + 4 * q * m * c,
        q * n_pass * m)
    scan["valid_share"] = n_pass / scan_rows
    # the reorder trace: one query's E*R = 64 fresh neighbours, unmasked
    nbr1, adt1 = nbr[:1].contiguous(), adts[:1].contiguous()
    touched1 = touched(nbr1, codes, torch.ones_like(fresh[:1]))
    trace = entry(
        "gather_Q1_n64_trace", "pq_lookup_gather_kernel",
        ops.pq_lookup_gather(nbr1, codes, adt1),
        ops.pq_lookup_gather_plain(nbr1, codes, adt1), 1e-4, 1e-4,
        lambda: ops.pq_lookup_gather(nbr1, codes, adt1),
        lambda: ops.pq_lookup_gather_plain(nbr1, codes, adt1),
        {"codes_gather_sum": lambda: adt_flat[:1].gather(
            2, codes[nbr1.long()].long() + offs).sum(-1)},
        4 * r + r * m + 4 * touched1 + 4 * r, r * m)
    # calibrate_beta: 256 sampled queries x the same 512 target rows
    tcodes = codes[:512].contiguous()
    tids = torch.arange(512, dtype=torch.int32, device=dev).expand(
        q, 512).contiguous()
    calib = entry(
        "gather_Q256_n512_calibrate", "pq_lookup_gather_kernel",
        ops.pq_lookup_gather(tids, tcodes, adts),
        ops.pq_lookup_gather_plain(tids, tcodes, adts), 1e-4, 1e-4,
        lambda: ops.pq_lookup_gather(tids, tcodes, adts),
        lambda: ops.pq_lookup_gather_plain(tids, tcodes, adts),
        # the reference's form: the target codes, one ADT gather and sum
        {"index_sum": lambda: adts_2d[:, tcodes.long() + offs].sum(-1)},
        4 * q * 512 + 512 * m + 4 * q * m * c + 4 * q * 512, q * 512 * m)
    record("pq_lookup", "src/repro_torch/kernels/csrc/pq_lookup.cu",
           "src/repro/kernels/pq_lookup.py:42", masked, entry(
               "gather", "pq_lookup_gather_kernel",
               ops.pq_lookup_gather(nbr, codes, adts),
               ops.pq_lookup_gather_plain(nbr, codes, adts), 1e-4, 1e-4,
               lambda: ops.pq_lookup_gather(nbr, codes, adts),
               lambda: ops.pq_lookup_gather_plain(nbr, codes, adts),
               libraries, lookup_bytes(nbr, codes, everything) - q * r,
               q * r * m), scan, trace, calib,
           # the batched tile fan-out's round: NUM_TILES x Q lanes, each
           # tile's lanes with the same Q ADTs
           gather_entry(f"gather_masked_Q{NUM_TILES * q}_batched_tiles",
                        ints(0, n_base, (NUM_TILES * q, r), torch.int32),
                        codes, adts.repeat(NUM_TILES, 1, 1),
                        rand(NUM_TILES * q, r) < 0.5),
           # IVF's chunk: the gather entry IVF took before, then the lists
           # entry it takes now
           gather_entry(f"gather_ivf_Q{ivf_rows.shape[0]}"
                        f"_n{ivf_rows.shape[1]}", ivf_rows, ivf_table,
                        ivf_adts, ivf_mask), lists_ivf,
           # the distributed round's: nsp over the shard's codes (local
           # ids, "fresh and owned and not hot") and over the hot replica
           # ("fresh and hot"); fetch over the fetched (Q*R, M) table
           *(gather_entry(f"gather_distributed_{site}", *dist_inputs[site])
             for site in ("lookup_shard", "lookup_hot", "lookup_table")),
           # the image retriever's round over its 2048-d corpus (n = R = 32)
           gather_entry(f"gather_retriever_Q{retr_lookup[0].shape[0]}"
                        f"_n{retr_lookup[0].shape[1]}", *retr_lookup))

    # ---- bitonic_sort_pairs: the merge entry the round runs, the sort ----
    def merge_inputs(n, l, nq):
        """A lane's list (sorted prefix, +inf tail with -1 ids) and n fresh
        candidates (30% stale: +inf, -1), with ties and signed zeros."""
        dl = signed(ints(0, 64, (nq, l)).float()).sort(dim=1).values
        tail = torch.arange(l, device=dev) >= ints(l // 2, l + 1, (nq, 1))
        dl[tail] = inf
        ids = torch.where(tail, -1, ints(0, n_base, (nq, l), torch.int32))
        acc = torch.where(rand(nq, l) < 0.3, rand(nq, l), inf)
        ev = rand(nq, l) < 0.5
        nd = signed(ints(0, 64, (nq, n)).float())
        stale = rand(nq, n) < 0.3
        nd[stale] = inf
        n_ids = torch.where(stale, -1, ints(0, n_base, (nq, n), torch.int32))
        return ids, dl, acc, ev, n_ids, nd

    def network_ops(width, nq=q):
        lg = (width - 1).bit_length()
        return nq * (1 << lg) // 2 * lg * (lg + 1) // 2

    def merge_entry(n, l=l, nq=q, cols=None, label=None):
        """The merge at (L=l, n) over nq lanes: random lists, or ``cols``,
        a call site's own arguments."""
        cols = cols or merge_inputs(n, l, nq)
        cat = [torch.cat([cols[0], cols[4]], 1), torch.cat([cols[1], cols[5]], 1),
               torch.cat([cols[2], torch.full_like(cols[5], inf)], 1),
               torch.cat([cols[3], torch.zeros_like(cols[3][:, :1]).expand(
                   nq, n)], 1)]

        def sort_and_gathers():
            order = torch.sort(cat[1], dim=1, stable=True).indices[:, :l]
            return [t.gather(1, order) for t in cat]

        return entry(
            label or f"merge_L{l}_n{n}"
            + ("" if nq == q else f"_Q{nq}_batched_tiles"),
            bitonic_topk.merge_kernel(l, n),
            ops.bitonic_merge_topl(*cols),
            ops.bitonic_merge_topl_plain(*cols), 0.0, 0.0,
            lambda: ops.bitonic_merge_topl(*cols),
            lambda: ops.bitonic_merge_topl_plain(*cols),
            {"sort_and_4_gathers": sort_and_gathers},
            26 * nq * l + 8 * nq * n, network_ops(l + n, nq))

    # the cross-tile merge's sort: P=4 tiles x k=10 candidates a query, with
    # duplicate ids (hot replicas) keyed +inf, -1 ids (+inf) and ties,
    # padded to 64 with +inf keys and position 0, as cross_tile_merge pads
    n_cand, p_pad = NUM_TILES * 10, 64
    c_ids = torch.where(rand(q, n_cand) < 0.1, -1,
                        ints(0, 64, (q, n_cand), torch.int32))
    dup = ((c_ids[:, :, None] == c_ids[:, None, :])
           & torch.ones(n_cand, n_cand, dtype=torch.bool,
                        device=dev).tril(-1)).any(-1)
    c_keys = torch.where(dup | (c_ids < 0), inf,
                         ints(0, 16, (q, n_cand)).float())
    x_keys = torch.nn.functional.pad(c_keys, (0, p_pad - n_cand), value=inf)
    x_pos = torch.nn.functional.pad(
        torch.arange(n_cand, dtype=torch.int32, device=dev),
        (0, p_pad - n_cand)).expand(q, p_pad).contiguous()

    def sort_and_gather():
        sk, order = torch.sort(x_keys, dim=1, stable=True)
        return sk, x_pos.gather(1, order)

    cross = entry(
        f"sort_cross_tile_Q{q}_P{p_pad}", "warp_sort_kernel",
        ops.bitonic_sort_pairs(x_keys, x_pos),
        ops.bitonic_sort_pairs_plain(x_keys, x_pos), 0.0, 0.0,
        lambda: ops.bitonic_sort_pairs(x_keys, x_pos),
        lambda: ops.bitonic_sort_pairs_plain(x_keys, x_pos),
        {"torch.sort+gather": sort_and_gather},
        16 * q * p_pad, network_ops(p_pad))
    cross["inf_share"] = float(torch.isinf(x_keys).float().mean())

    # the base/delta merge's sort (stream/searcher.py merge_order): k_base =
    # 26 base keys (ascending, ~1% tombstoned to +inf where they stand),
    # 26 delta keys (ascending, ~1% tombstoned), +inf padding to 64;
    # payload the column position
    kb = kd = 26
    b_keys = ints(0, 1 << 12, (q, kb)).float().sort(dim=1).values
    d_keys = ints(0, 1 << 12, (q, kd)).float().sort(dim=1).values
    m_keys = torch.nn.functional.pad(torch.cat([
        torch.where(rand(q, kb) < 0.01, inf, b_keys),
        torch.where(rand(q, kd) < 0.01, inf, d_keys)], 1),
        (0, p_pad - kb - kd), value=inf)
    m_pos = torch.arange(p_pad, dtype=torch.int32, device=dev).expand(
        q, p_pad).contiguous()

    def merge_sort_and_gather():
        sk, order = torch.sort(m_keys, dim=1, stable=True)
        return sk, m_pos.gather(1, order)

    stream_merge = entry(
        f"sort_stream_merge_Q{q}_P{p_pad}", "warp_sort_kernel",
        ops.bitonic_sort_pairs(m_keys, m_pos),
        ops.bitonic_sort_pairs_plain(m_keys, m_pos), 0.0, 0.0,
        lambda: ops.bitonic_sort_pairs(m_keys, m_pos),
        lambda: ops.bitonic_sort_pairs_plain(m_keys, m_pos),
        {"torch.sort+gather": merge_sort_and_gather},
        16 * q * p_pad, network_ops(p_pad))
    stream_merge["inf_share"] = float(torch.isinf(m_keys).float().mean())
    record("bitonic_sort_pairs", "src/repro_torch/kernels/csrc/bitonic_topk.cu",
           "src/repro/kernels/bitonic_topk.py:57", merge_entry(r),
           merge_entry(4 * r), merge_entry(r, 4 * l), merge_entry(r, 8 * l),
           merge_entry(r, nq=NUM_TILES * q),
           merge_entry(retr_merge[4].shape[1], retr_merge[0].shape[1],
                       retr_merge[0].shape[0], cols=retr_merge,
                       label=f"merge_L{retr_merge[0].shape[1]}"
                             f"_n{retr_merge[4].shape[1]}_retriever"),
           cross, stream_merge, entry(
               f"sort_P{p}", "warp_sort_kernel",
               ops.bitonic_sort_pairs(keys, pos),
               ops.bitonic_sort_pairs_plain(keys, pos), 0.0, 0.0,
               lambda: ops.bitonic_sort_pairs(keys, pos),
               lambda: ops.bitonic_sort_pairs_plain(keys, pos),
               {"torch.sort": lambda: torch.sort(keys, dim=1, stable=True)},
               16 * q * p, network_ops(p)))

    # ---- l2_rerank: the masked entry at the round's density and asked
    # for every row, and the reference signature on pre-gathered rows --------
    gathered = base[cand.long()]
    acc = torch.where(rand(q, l) < 0.5, rand(q, l), inf)

    def masked_entry(label, mask, cand=cand, acc=acc, gathered=gathered,
                     queries=queries):
        rows = int(torch.unique(cand[mask]).numel())
        nq, k = cand.shape
        return entry(
            label, "l2_rerank",          # either kernel
            ops.l2_rerank_masked(queries, cand, base, acc, mask, "l2"),
            ops.l2_rerank_masked_plain(queries, cand, base, acc, mask, "l2"),
            1e-4, 1e-3,
            lambda: ops.l2_rerank_masked(queries, cand, base, acc, mask, "l2"),
            lambda: ops.l2_rerank_masked_plain(queries, cand, base, acc, mask,
                                               "l2"),
            # every row, pre-gathered, in one call
            {"cdist": lambda: torch.cdist(queries[:, None, :], gathered)},
            # mask and out; an id where the mask is set, acc where not;
            # the asked-for rows and their queries
            9 * nq * k + 4 * rows * d
            + 4 * d * int(mask.any(1).sum()), 3 * int(mask.sum()) * d)

    def rerank_entry(label, qq, ids, table, acc_, mask, metric="l2"):
        """The masked entry on a call site's own arguments."""
        pre = table[ids.clamp(min=0).long()]
        nq, k = ids.shape
        dd = table.shape[1]
        lib = ({"cdist": lambda: torch.cdist(qq[:, None, :], pre)}
               if metric == "l2" else
               {"bmm": lambda: torch.bmm(pre, qq[:, :, None])})
        return entry(
            label, "l2_rerank",          # either kernel
            ops.l2_rerank_masked(qq, ids, table, acc_, mask, metric),
            ops.l2_rerank_masked_plain(qq, ids, table, acc_, mask, metric),
            1e-4, 1e-3,
            lambda: ops.l2_rerank_masked(qq, ids, table, acc_, mask, metric),
            lambda: ops.l2_rerank_masked_plain(qq, ids, table, acc_, mask,
                                               metric), lib,
            9 * nq * k + 4 * int(torch.unique(ids[mask]).numel()) * dd
            + 4 * dd * int(mask.any(1).sum()),
            (3 if metric == "l2" else 2) * int(mask.sum()) * dd)

    def at_density(label, share, k=l, nq=q):
        if k == l and nq == q:
            cols = dict()
        else:
            kc = ints(0, n_base, (nq, k), torch.int32)
            cols = dict(cand=kc,
                        acc=torch.where(rand(nq, k) < 0.5, rand(nq, k), inf),
                        gathered=base[kc.long()],
                        queries=queries.repeat(nq // q, 1))
        mask = rand(nq, k) < share
        e = masked_entry(label, mask, **cols)
        e["mask_share"] = float(mask.float().mean())
        return e

    record("l2_rerank", "src/repro_torch/kernels/csrc/l2_rerank.cu",
           "src/repro/kernels/l2_rerank.py:39",
           at_density("masked", rerank_density["round_mean"]),
           at_density("masked_margin", rerank_density["margin"]),
           at_density(f"masked_K{filter_density['K']}",
                      filter_density["round_mean"], filter_density["K"]),
           at_density(f"masked_Q{NUM_TILES * q}_batched_tiles",
                      rerank_density["round_mean"], nq=NUM_TILES * q),
           masked_entry("masked_all", torch.ones((q, l), dtype=torch.bool,
                                                 device=dev)),
           # the distributed round's exact distances: the shard's rows
           # ("needed and owned and not hot", 0 elsewhere) and the hot
           # replica's ("needed and hot")
           *(rerank_entry(f"masked_distributed_{site}", *dist_inputs[site])
             for site in ("rerank_shard", "rerank_hot")),
           # the image retriever's round: 2048-d angular rows of its corpus,
           # and where its mask's rows fall
           dict(rerank_entry(f"masked_retriever_D{retr_rerank[2].shape[1]}"
                             f"_N{retr_rerank[2].shape[0]}", *retr_rerank),
                mask_rows=_mask_rows(retr_rerank[4])),
           # search_reference's exact distances: one query, the T=16 entries
           # of a round's top-T, every one asked for
           masked_entry("masked_Q1_K16_trace",
                        torch.ones((1, 16), dtype=torch.bool, device=dev),
                        cand=cand[:1, :16].contiguous(),
                        acc=acc[:1, :16].contiguous(),
                        gathered=gathered[:1, :16], queries=queries[:1]),
           entry(
               "pregathered", "l2_rerank_kernel",
               ops.l2_rerank(queries, gathered, "l2"),
               ops.l2_rerank_plain(queries, gathered, "l2"), 1e-4, 1e-3,
               lambda: ops.l2_rerank(queries, gathered, "l2"),
               lambda: ops.l2_rerank_plain(queries, gathered, "l2"),
               {"cdist": lambda: torch.cdist(queries[:, None, :], gathered)},
               4 * (q * d + q * l * d + q * l), 4 * q * l * d))
    return out


def main_path(torch, dev, args, log) -> tuple:
    """Build the index and serve the queries through the port's entry
    points; returns (the numbers the smoke prints and checks, the index,
    the engine's (Q, 10) ids and distances)."""
    import numpy as np

    from repro_torch.configs.base import (
        DatasetConfig, GraphConfig, PQConfig, ProximaConfig, SearchConfig,
    )
    from repro_torch.core.dataset import make_dataset, recall_at_k
    from repro_torch.core.index import build_index
    from repro_torch.kernels import loader
    from repro_torch.plan import Searcher, SearchRequest
    from repro_torch.serve import ServingEngine

    cfg = ProximaConfig(
        dataset=DatasetConfig(name="sift-like", num_base=args.num_base,
                              num_queries=args.num_queries, dim=128,
                              metric="l2", num_clusters=args.num_clusters,
                              cluster_std=args.cluster_std, seed=args.seed),
        pq=PQConfig(num_subvectors=32, num_centroids=256),
        graph=GraphConfig(max_degree=64, build_list_size=128),
        search=SearchConfig(),
        hot_node_fraction=0.03, gap_encode=True,   # the paper's defaults
    )
    res = {"config": {"num_base": args.num_base,
                      "num_queries": args.num_queries,
                      "num_clusters": args.num_clusters,
                      "cluster_std": args.cluster_std}}
    t0 = time.perf_counter()
    ds = make_dataset(cfg.dataset, k_gt=10, device=dev)
    torch.cuda.synchronize()
    stages = {"dataset_and_ground_truth": time.perf_counter() - t0}
    # the reorder trace (one search_reference per sampled base vector) and
    # calibrate_beta run the kernels during the build
    loader.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    idx = build_index(cfg, dataset=ds, device=dev, stage_times=stages,
                      reorder_samples=REORDER_SAMPLES, calibrate=True)
    # what one build of the 1M index allocates at its peak, over what was
    # allocated when it started (the streaming phase's rebuild is held to it)
    res["build_peak_bytes"] = torch.cuda.max_memory_allocated() - mem0
    res["build_launches"] = dict(loader.LAUNCHES)
    res["build_s"] = stages
    log(f"build seconds by stage: {json.dumps(stages)}")
    res["hot_count"] = idx.hot_count
    res["gap"] = {"bit_width": idx.gap.bit_width,
                  "compression_ratio": idx.gap.compression_ratio}
    res["index_bytes"] = idx.index_bytes()
    res["calibrated_beta"] = idx.calibrated_beta
    log(f"hot nodes {idx.hot_count}, gap encoding {idx.gap.bit_width} bits "
        f"a neighbour, compression ratio {idx.gap.compression_ratio:.4f}, "
        f"calibrated beta {idx.calibrated_beta:.4f}, launches in the build "
        f"(trace + calibrate_beta) {json.dumps(res['build_launches'])}")
    log(f"index bytes: {json.dumps(res['index_bytes'])}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = ServingEngine(idx, batch_size=256)
    torch.cuda.synchronize()
    res["engine_warmup_s"] = time.perf_counter() - t0
    corpus = engine.searcher.corpus
    res["corpus_bytes"] = {f: int(getattr(corpus, f).nbytes) for f in
                           ("base", "adjacency", "codes", "centroids")}
    log(f"corpus bytes on the card: {json.dumps(res['corpus_bytes'])}")

    queries = ds.queries
    loader.reset_launch_counts()
    t0 = time.perf_counter()
    for v in queries:
        engine.submit(v)
    engine.drain()
    wall = time.perf_counter() - t0
    res["launches"] = dict(loader.LAUNCHES)
    res["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
    done = [engine.done[i] for i in range(len(queries))]
    ids = np.stack([r.ids for r in done])
    dists = np.stack([r.dists for r in done])
    lat = np.array([r.latency_ms for r in done])
    t_done = sorted({r.t_done for r in done})
    batch_ms = [(b - a) * 1e3 for a, b in zip(t_done, t_done[1:])]
    res.update(
        qps=len(queries) / wall, wall_s=wall, batches=engine.stats["batches"],
        p50_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)),
        batch_ms_median=sorted(batch_ms)[len(batch_ms) // 2]
        if batch_ms else None,
        recall_at_10=recall_at_k(ids, idx.dataset.gt, 10),
    )

    # the same queries through Searcher.search directly, 256 at a time
    searcher = Searcher.open(idx)
    direct, hops, rounds, hot, free = [], [], [], [], []
    for s in range(0, len(queries), 256):
        out = searcher.search(SearchRequest(queries=queries[s : s + 256]))
        direct.append(out.ids)
        hops.append(out.raw.n_hops.double().cpu())
        rounds.append(out.raw.rounds.double().cpu())
        hot.append(out.raw.n_hot_hops.double().cpu())
        free.append(out.raw.n_free_pq.double().cpu())
    direct = np.concatenate(direct)
    res["engine_equals_searcher"] = bool((direct == ids).all())
    res["mean_hops"] = float(torch.cat(hops).mean())
    res["mean_rounds"] = float(torch.cat(rounds).mean())
    res["mean_hot_hops"] = float(torch.cat(hot).mean())
    res["mean_free_pq"] = float(torch.cat(free).mean())
    # a batch runs until its slowest lane is done
    res["mean_batch_max_rounds"] = float(np.mean([float(r.max())
                                                  for r in rounds]))
    return res, ds, idx, ids, dists


def _served(engine) -> list:
    """Step ``engine`` (continuous) until every request is done, as
    ``drain`` does; returns the lanes each tick stepped."""
    occupied = []
    while engine.queue or engine.inflight():
        done = engine.step(force=True)
        occupied.append(engine.inflight() + len(done))
    return occupied


def continuous_phase(torch, idx, batch_ids, batch_dists, log) -> dict:
    """The main path's queries through ``ServingEngine(continuous=True,
    slots=256)``: QPS, latency, ticks, occupied slots, host seconds per tick
    and in the per-tick read of the active flags, recall@10, and whether
    every request's ids and distances equal the batch-flush engine's."""
    import numpy as np

    from repro_torch.core.dataset import recall_at_k
    from repro_torch.kernels import loader
    from repro_torch.plan.rounds import RoundSession
    from repro_torch.serve import ServingEngine

    t0 = time.perf_counter()
    engine = ServingEngine(idx, batch_size=256, continuous=True, slots=256)
    torch.cuda.synchronize()
    res = {"engine_warmup_s": time.perf_counter() - t0}
    queries = idx.dataset.queries
    # time the per-tick host read of the active flags (the retire decision)
    active_s = []
    real_active = RoundSession.active

    def timed_active(self, state):
        a = time.perf_counter()
        out = real_active(self, state)
        active_s.append(time.perf_counter() - a)
        return out

    RoundSession.active = timed_active
    loader.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        for v in queries:
            engine.submit(v)
        occupied = _served(engine)
        wall = time.perf_counter() - t0
    finally:
        RoundSession.active = real_active
    res["launches"] = dict(loader.LAUNCHES)
    done = [engine.done[i] for i in range(len(queries))]
    ids = np.stack([r.ids for r in done])
    dists = np.stack([r.dists for r in done])
    lat = np.array([r.latency_ms for r in done])
    ticks = engine.stats["ticks"]
    res.update(
        qps=len(queries) / wall, wall_s=wall, ticks=ticks,
        p50_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)),
        mean_occupied_slots=float(np.mean(occupied)),
        lane_rounds=int(np.sum(occupied)),
        host_s_per_tick=wall / ticks,
        active_read_s_per_tick=sum(active_s) / len(active_s),
        retired=engine.stats["retired"],
        fallback_batches=engine.stats["fallback_batches"],
        recall_at_10=recall_at_k(ids, idx.dataset.gt, 10),
        equals_batch_engine=bool((ids == batch_ids).all()
                                 and np.array_equal(dists, batch_dists)),
    )
    log(f"continuous engine (slots=256): {len(queries)} queries in "
        f"{wall:.3f} s: QPS={res['qps']:.1f} p50_ms={res['p50_ms']:.2f} "
        f"p99_ms={res['p99_ms']:.2f} ticks={ticks} "
        f"mean_occupied_slots={res['mean_occupied_slots']:.1f} "
        f"lane_rounds={res['lane_rounds']} "
        f"host_s_per_tick={res['host_s_per_tick']:.5f} "
        f"active_read_s_per_tick={res['active_read_s_per_tick']:.6f} "
        f"recall@10={res['recall_at_10']:.4f}")
    log(f"launches on the continuous path: {json.dumps(res['launches'])}")
    log(f"continuous ids and distances equal the batch-flush engine's: "
        f"{res['equals_batch_engine']}")
    return res


DIST_RUNS = (("nsp", 1), ("nsp", 4), ("fetch", 1), ("fetch", 4))
MESH_SHAPE = (2, 2)              # (data, model) gloo ranks on the one card
# the gloo mesh's queries, the first of the world-size-1 runs' SHARD_QUERIES
# (2,048, then 1,024, cut as later phases joined the smoke's time limit)
MESH_QUERIES = 512
MESH_MODES = ("nsp", "fetch")    # at E=1
ROUND_COLLECTIVES = ("adjacency", "scores", "codes", "exact")


def _serve_searcher(searcher, queries, before=None) -> tuple:
    """``queries`` through ``searcher.search`` 256 at a time after one
    untimed batch (``before``, if given, is called between them): (ids,
    wall seconds).  The ids reach the host in each call, so the device's
    work is done when the clock stops."""
    import numpy as np

    from repro_torch.plan import SearchRequest

    searcher.search(SearchRequest(queries=queries[:256]))
    if before is not None:
        before()
    t0 = time.perf_counter()
    ids = np.concatenate([
        searcher.search(SearchRequest(queries=queries[s : s + 256])).ids
        for s in range(0, len(queries), 256)])
    return ids, time.perf_counter() - t0


def _distributed_inputs(searcher, queries, sc) -> dict:
    """One more 256-query batch with the kernel entries wrapped: the
    arguments of each distributed call site in the batch's 20th round (the
    kernel phase times the kernels on them)."""
    from repro_torch.kernels import ops

    seen, kept = {}, {}
    real = {f: getattr(ops, f) for f in ("pq_lookup_gather",
                                         "l2_rerank_masked")}

    def site(name, table):
        if table.shape[0] == sc.hot_codes.shape[0]:
            return name + "_hot"
        return name + ("_shard" if table.shape[0] == sc.base.shape[1]
                       else "_table")

    def lookup(ids, codes, adts, mask=None):
        key = site("lookup", codes)
        seen[key] = seen.get(key, 0) + 1
        if seen[key] == 20:
            kept[key] = (ids.clone(), codes, adts.clone(), mask.clone())
        return real["pq_lookup_gather"](ids, codes, adts, mask)

    def rerank(queries, ids, base, acc, mask, metric="l2"):
        key = site("rerank", base)
        seen[key] = seen.get(key, 0) + 1
        if seen[key] == 20:
            kept[key] = (queries.clone(), ids.clone(), base, acc.clone(),
                         mask.clone())
        return real["l2_rerank_masked"](queries, ids, base, acc, mask,
                                        metric)

    ops.pq_lookup_gather, ops.l2_rerank_masked = lookup, rerank
    try:
        from repro_torch.plan import SearchRequest

        searcher.search(SearchRequest(queries=queries[-256:]))
    finally:
        for f, fn in real.items():
            setattr(ops, f, fn)
    return kept


def distributed_phase(torch, dev, idx, out_dir, repo, log) -> tuple:
    """The distributed search (``repro_torch.core.distributed`` through
    ``Searcher.open(sharded_corpus, mesh=, mode=)``) over the main path's
    index, SHARD_QUERIES queries 256 at a time.  World size 1 over NCCL in
    this process (a 1x1 mesh): both modes at E=1 and 4 against a flat
    ``Searcher`` on the same queries (ids as sorted sets, recall@10, QPS,
    launches per kernel and bytes handed to the collectives, a round),
    and each round-collective's time at its shape.  Then a MESH_SHAPE mesh
    of gloo ranks on the one card (``mesh_rank``, one process each, each
    loading only its own data shard, written once as ``.npy``), MESH_MODES
    at E=1 (ids against world size 1, QPS, seconds).  Then ``python -m
    repro_torch.launch.serve`` at its defaults.  Returns (the record, the
    call sites' arguments for the kernel phase).  On a CPU ``dev`` (a
    rehearsal) the groups are gloo and the mesh's ranks run on the CPU."""
    import datetime
    import shutil

    import numpy as np
    import torch.distributed as dist

    from repro_torch.core import distributed as dmod
    from repro_torch.core.dataset import recall_at_k
    from repro_torch.kernels import loader
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.plan import Searcher

    queries = idx.dataset.queries[:SHARD_QUERIES]
    gt = idx.dataset.gt[:SHARD_QUERIES]
    batches = -(-len(queries) // 256)
    args = (idx.graph.adjacency, idx.codes, idx._search_base(),
            idx.codebook.centroids, int(idx.graph.entry_point),
            idx.hot_count)
    work = out_dir / "distributed"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {"flat": {}, "world_1": {}, "collective_ms": {}}
    flat = {}

    def _reset():
        loader.reset_launch_counts()
        dmod.TRAFFIC.clear()

    for beam in (1, 4):
        flat[beam], wall = _serve_searcher(
            Searcher.open(idx, beam_width=beam), queries)
        out["flat"][beam] = {"qps": len(queries) / wall,
                             "recall_at_10": recall_at_k(flat[beam], gt, 10)}
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        store=dist.FileStore(str(work / "store_1"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=600))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type=dev.type)
        t0 = time.perf_counter()
        sc = dmod.shard_corpus(*args, 1, shard=0, device=dev)
        out["shard_s"] = time.perf_counter() - t0
        world1 = {}
        for mode, beam in DIST_RUNS:
            searcher = Searcher.open(sc, mesh=mesh, mode=mode,
                                     cfg=idx.config.search, beam_width=beam)
            ids, wall = _serve_searcher(searcher, queries, _reset)
            world1[mode, beam] = ids
            launches = dict(loader.LAUNCHES)
            traffic = dict(dmod.TRAFFIC)
            n_batches = batches
            rounds = traffic["rounds"]
            per_round = {k: traffic.get(k, 0) / rounds
                         for k in ROUND_COLLECTIVES if k in traffic}
            rec = out["world_1"][f"{mode}_E{beam}"] = {
                "qps": len(queries) / wall, "wall_s": wall,
                "qps_over_flat": len(queries) / wall
                / out["flat"][beam]["qps"],
                "recall_at_10": recall_at_k(ids, gt, 10),
                "flat_recall_at_10": out["flat"][beam]["recall_at_10"],
                "same_sets_as_flat": float(
                    (np.sort(ids, 1) == np.sort(flat[beam], 1)).all(1)
                    .mean()),
                "rounds": rounds, "batches": n_batches,
                "launches": launches,
                "launches_per_round": {k: v / rounds
                                       for k, v in launches.items()},
                "collective_bytes_per_round": per_round,
                "collective_bytes_per_round_total": sum(per_round.values()),
                "collectives": traffic["collectives"],
                "launch_check": {
                    "pq_adt": [launches["pq_adt"], n_batches],
                    "pq_lookup": [launches["pq_lookup"],
                                  (2 if mode == "nsp" else 1)
                                  * (rounds + n_batches)],
                    "bitonic_sort_pairs": [launches["bitonic_sort_pairs"],
                                           rounds],
                    "l2_rerank": [launches["l2_rerank"],
                                  2 * (rounds + n_batches)]},
            }
            log(f"distributed world 1 {mode} E={beam}: QPS={rec['qps']:.1f} "
                f"({rec['qps_over_flat']:.3f} of flat "
                f"{out['flat'][beam]['qps']:.1f}) recall@10="
                f"{rec['recall_at_10']:.4f} (flat "
                f"{rec['flat_recall_at_10']:.4f}) same sets as flat "
                f"{rec['same_sets_as_flat']:.4f}; rounds {rounds} over "
                f"{n_batches} batches; launches a round "
                f"{json.dumps(rec['launches_per_round'])}; collective bytes "
                f"a round {json.dumps(per_round)}")
        searcher = Searcher.open(sc, mesh=mesh, mode="nsp",
                                 cfg=idx.config.search)
        inputs = _distributed_inputs(searcher, queries, sc)
        fetch = Searcher.open(sc, mesh=mesh, mode="fetch",
                              cfg=idx.config.search)
        inputs["lookup_table"] = _distributed_inputs(
            fetch, queries, sc)["lookup_table"]
        # each collective of a round at its shape (Q=256, E=1, R=64,
        # M=32, L=128), timed as the kernels are
        group = mesh.get_group("data")
        flush = _Flush(torch, dev)
        r, m = idx.graph.adjacency.shape[1], idx.codes.shape[1]
        shapes = {"adjacency": ((256, r), torch.int32),
                  "scores": ((256, r), torch.float32),
                  "codes": ((256, r, m), torch.int32),
                  "exact": ((256, idx.config.search.list_size),
                            torch.float32)}
        for name, (shape, dtype) in shapes.items():
            t = torch.zeros(shape, dtype=dtype, device=dev)
            out["collective_ms"][name] = {
                "bytes": t.numel() * t.element_size(),
                "ms": _time_ms(torch, lambda t=t: dist.all_reduce(
                    t, group=group), flush)}
        log(f"NCCL all_reduce at world size 1, a round's collectives: "
            f"{json.dumps(out['collective_ms'])}")
        del sc
    finally:
        dist.destroy_process_group()

    # the gloo mesh: each data shard written once, each rank loads its own
    p = MESH_SHAPE[0]
    t0 = time.perf_counter()
    for s in range(p):
        part = dmod.shard_corpus(*args, p, shard=s, device="cpu")
        for f in ("adjacency", "codes", "base"):
            np.save(work / f"{f}{s}.npy", getattr(part, f).numpy())
    np.savez(work / "replicated.npz", **{f: getattr(part, f).numpy() for f in (
        "centroids", "hot_adjacency", "hot_codes", "hot_base")})
    np.save(work / "queries.npy", queries[:MESH_QUERIES])
    (work / "meta.json").write_text(json.dumps({
        "entry_point": part.entry_point, "hot_count": part.hot_count,
        "num_vertices": part.num_vertices, "device": dev.type,
        "cfg": dataclasses.asdict(idx.config.search)}))
    del part
    out["mesh_write_s"] = time.perf_counter() - t0
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    t0 = time.perf_counter()
    ranks = math.prod(MESH_SHAPE)
    # one host thread a rank: the ranks share the host's cores
    rank_env = dict(env, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.mesh_rank(sys.argv[1:]))", str(rank),
         str(work)], cwd=repo, env=rank_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(ranks)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            proc.kill()
    out["mesh_s"] = time.perf_counter() - t0
    (out_dir / "distributed_ranks.log").write_text("\n".join(
        f"== rank {i} (exit {proc.returncode})\n{text}"
        for i, (proc, text) in enumerate(zip(procs, logs))))
    out["mesh_exit_codes"] = [proc.returncode for proc in procs]
    mesh_rec = out["mesh"] = {}
    if all(c == 0 for c in out["mesh_exit_codes"]):
        recs = [json.loads((work / f"rank{i}.json").read_text())
                for i in range(ranks)]
        for mode in MESH_MODES:
            ids = [np.load(work / f"ids{i}.npz")[mode] for i in range(ranks)]
            wall = max(rec[mode]["wall_s"] for rec in recs)
            t = recs[0][mode]["traffic"]
            mesh_rec[mode] = {
                "qps": MESH_QUERIES / wall, "wall_s": wall,
                "equals_world_1": all(
                    np.array_equal(x, world1[mode, 1][:MESH_QUERIES])
                    for x in ids),
                "rounds_rank0": t["rounds"],
                "ms_per_round": wall * 1e3 / t["rounds"],
                "collective_bytes_per_round_rank0": {
                    k: t[k] / t["rounds"] for k in ROUND_COLLECTIVES
                    if k in t},
                "launches_rank0": recs[0][mode]["launches"]}
            rec = mesh_rec[mode]
            log(f"distributed gloo mesh {MESH_SHAPE} ({ranks} processes, "
                f"one card) {mode} E=1: QPS={rec['qps']:.1f} "
                f"wall {wall:.3f} s, ids equal world size 1: "
                f"{rec['equals_world_1']}; rank 0: rounds {t['rounds']}, "
                f"ms a round {rec['ms_per_round']:.3f}, collective bytes a "
                f"round {json.dumps(rec['collective_bytes_per_round_rank0'])}")
    log(f"distributed gloo mesh: exit codes {out['mesh_exit_codes']}, "
        f"{out['mesh_s']:.1f} s (shards written in "
        f"{out['mesh_write_s']:.1f} s; rank logs in "
        f"distributed_ranks.log)")
    shutil.rmtree(work, ignore_errors=True)

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device",
         dev.type], cwd=repo, env=env, capture_output=True, text=True,
        timeout=600)
    out["serve"] = {"exit_code": proc.returncode,
                    "s": time.perf_counter() - t0,
                    "stdout": proc.stdout[-2000:],
                    "stderr": proc.stderr[-2000:]}
    line = [x for x in proc.stdout.splitlines() if "recall@" in x]
    out["serve"]["recall_line"] = line[-1] if line else None
    log(f"python -m repro_torch.launch.serve: exit {proc.returncode} in "
        f"{out['serve']['s']:.1f} s: {out['serve']['recall_line']}")
    return out, inputs


def mesh_rank(argv) -> int:
    """One rank of the distributed phase's gloo mesh (``python -c "import
    chip_smoke; chip_smoke.mesh_rank([rank, dir])"`` from the repo root):
    its own data shard from ``dir``, MESH_MODES at E=1 over the queries 256
    at a time after one untimed batch; ids, seconds, launches and
    collective bytes into ``dir``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    rank, work = int(argv[0]), Path(argv[1])
    meta = json.loads((work / "meta.json").read_text())
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(work / "store_mesh"),
                                     math.prod(MESH_SHAPE)),
        rank=rank, world_size=math.prod(MESH_SHAPE),
        timeout=datetime.timedelta(seconds=600))
    try:
        from repro_torch.configs.base import SearchConfig
        from repro_torch.core import distributed as dmod
        from repro_torch.kernels import loader
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.plan import Searcher

        dev = torch.device(meta["device"])
        mesh = make_mesh(MESH_SHAPE, ("data", "model"), device_type=dev.type)
        s = mesh.get_local_rank("data")

        def load(a):
            return torch.from_numpy(a).to(dev)

        rep = np.load(work / "replicated.npz")
        sc = dmod.ShardedCorpus(
            *(load(np.load(work / f"{f}{s}.npy"))
              for f in ("adjacency", "codes", "base")),
            *(load(rep[f]) for f in ("centroids", "hot_adjacency",
                                     "hot_codes", "hot_base")),
            entry_point=meta["entry_point"], hot_count=meta["hot_count"],
            num_vertices=meta["num_vertices"], num_shards=MESH_SHAPE[0],
            shard=s)
        queries = np.load(work / "queries.npy")
        cfg = SearchConfig(**meta["cfg"])
        ids, rec = {}, {}
        for mode in MESH_MODES:
            searcher = Searcher.open(sc, mesh=mesh, mode=mode, cfg=cfg)

            def reset():
                dist.barrier()
                loader.reset_launch_counts()
                dmod.TRAFFIC.clear()

            ids[mode], wall = _serve_searcher(searcher, queries, reset)
            dist.barrier()
            rec[mode] = {"wall_s": wall, "launches": dict(loader.LAUNCHES),
                         "traffic": dict(dmod.TRAFFIC)}
        np.savez(work / f"ids{rank}.npz", **ids)
        (work / f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()
    return 0


FILTER_SPECS = (("isin_category_0_2", "masked"), ("eq_category_3", "masked"),
                ("range_price_0_9", "scan"), ("none_pass", "empty"))


def _specs():
    from repro_torch.filter import FilterSpec

    return {"isin_category_0_2": FilterSpec.isin("category", [0, 1, 2]),
            "eq_category_3": FilterSpec.eq("category", 3),
            "range_price_0_9": FilterSpec.range("price", 0, 9),
            "none_pass": FilterSpec.range("price", 1000, None)}


def filtered_phase(torch, idx, log) -> dict:
    """Filtered serving on the main path's index: four specs (masked at
    ~37.5% and ~12.5%, scan at ~1%, empty), 1,024 queries each,
    interleaved, through the continuous engine and the batch-flush engine;
    then each spec alone through ``Searcher.search`` (strategy, effective
    L, rounds per lane, launches by kernel) and an exact filtered kNN on the
    card (recall@10; every returned id must pass)."""
    import numpy as np

    from repro_torch.core.dataset import exact_knn, recall_at_k
    from repro_torch.filter import random_attributes
    from repro_torch.kernels import loader
    from repro_torch.plan import Searcher, SearchRequest
    from repro_torch.serve import ServingEngine

    n_per_spec = 1024          # of the 10,000 queries, for the smoke's time
    store = random_attributes(idx.dataset.num_base,
                              {"category": 8, "price": 1000}, seed=5)
    specs = _specs()
    queries = idx.dataset.queries[:n_per_spec]
    out = {"n_per_spec": n_per_spec, "specs": {}}
    got = {}
    for mode in ("continuous", "batch"):
        engine = ServingEngine(idx, batch_size=256, attributes=store,
                               continuous=mode == "continuous", slots=256)
        torch.cuda.synchronize()
        rids = {name: [] for name in specs}
        loader.reset_launch_counts()
        t0 = time.perf_counter()
        for v in queries:
            for name, spec in specs.items():
                rids[name].append(engine.submit(v, filter=spec))
        if mode == "continuous":
            occupied = _served(engine)
        else:
            engine.drain()
        wall = time.perf_counter() - t0
        out[mode] = {"wall_s": wall, "qps": 4 * n_per_spec / wall,
                     "launches": dict(loader.LAUNCHES),
                     "stats": engine.stats}
        if mode == "continuous":
            out[mode]["mean_occupied_slots"] = float(np.mean(occupied))
        for name in specs:
            done = [engine.done[r] for r in rids[name]]
            got[mode, name] = (np.stack([r.ids for r in done]),
                               np.stack([r.dists for r in done]))
            spec_wall = max(r.t_done for r in done) - min(
                r.t_submit for r in done)
            out["specs"].setdefault(name, {})[f"{mode}_span_qps"] = \
                n_per_spec / spec_wall
        log(f"filtered {mode} engine: {4 * n_per_spec} queries in "
            f"{wall:.3f} s, QPS={out[mode]['qps']:.1f}, launches "
            f"{json.dumps(out[mode]['launches'])}, stats "
            f"{json.dumps(out[mode]['stats'])}")

    searcher = Searcher.open(idx, attributes=store)
    base = idx.dataset.base
    for name, spec in specs.items():
        mask = store.mask(spec)
        rec = out["specs"][name]
        rounds, strategy, eff_l = [], None, None
        loader.reset_launch_counts()
        for s in range(0, n_per_spec, 256):
            r = searcher.search(SearchRequest(queries=queries[s:s + 256],
                                              filter=spec))
            rounds.append(r.raw.result.rounds.double().cpu())
            strategy, eff_l = r.plan.strategy, r.plan.cfg.list_size
        torch.cuda.synchronize()
        rec.update(strategy=strategy, selectivity=float(mask.mean()),
                   effective_list_size=eff_l,
                   rounds_per_lane=float(torch.cat(rounds).mean()),
                   searcher_launches=dict(loader.LAUNCHES))
        ids, dists = got["continuous", name]
        rec["engines_equal"] = bool(
            (ids == got["batch", name][0]).all()
            and np.array_equal(dists, got["batch", name][1]))
        rec["all_ids_pass"] = bool(mask[ids[ids >= 0]].all())
        pids = np.nonzero(mask)[0]
        if len(pids):
            k_eff = min(10, len(pids))
            gt = pids[exact_knn(queries, base[pids], k_eff, "l2",
                                device=idx.device)]
            rec["recall_at_10"] = recall_at_k(ids, gt, k_eff)
        else:
            rec["recall_at_10"] = None
            rec["all_padding"] = bool((ids == -1).all())
        log(f"filter {name}: strategy={strategy} "
            f"selectivity={rec['selectivity']:.5f} L={eff_l} "
            f"rounds_per_lane={rec['rounds_per_lane']:.2f} "
            f"continuous_span_qps={rec['continuous_span_qps']:.1f} "
            f"batch_span_qps={rec['batch_span_qps']:.1f} "
            f"recall@10={rec['recall_at_10']} "
            f"all_ids_pass={rec['all_ids_pass']} "
            f"engines_equal={rec['engines_equal']} "
            f"searcher_launches={json.dumps(rec['searcher_launches'])}")
    return out, store


def masked_density(torch, idx, store) -> dict:
    """The share of rows ``l2_rerank_masked`` is asked for in one 256-query
    masked search at L=1024 (``eq_category_3``): the rounds' mean and the
    margin's (the batch's last call), as ``rerank_density`` does."""
    from repro_torch.plan import Searcher, SearchRequest
    from repro_torch.kernels import ops

    shares = []
    real = ops.l2_rerank_masked

    def spy(queries, ids, base, acc, mask, metric="l2"):
        shares.append((ids.shape[1], float(mask.float().mean())))
        return real(queries, ids, base, acc, mask, metric)

    searcher = Searcher.open(idx, attributes=store)
    ops.l2_rerank_masked = spy
    try:
        searcher.search(SearchRequest(queries=idx.dataset.queries[-256:],
                                      filter=_specs()["eq_category_3"]))
        torch.cuda.synchronize()
    finally:
        ops.l2_rerank_masked = real
    rounds = [x for _, x in shares[:-1]]
    return {"K": shares[0][0], "round_mean": sum(rounds) / len(rounds),
            "rounds": len(rounds), "margin": shares[-1][1]}


def _serve(engine, queries) -> tuple:
    """Submit every query, drain; (ids, wall seconds, launches by kernel,
    launches by C entry, batches), launch counts zeroed just before."""
    import numpy as np

    from repro_torch.kernels import loader

    b0 = engine.stats["batches"]
    loader.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [engine.submit(v) for v in queries]
    engine.drain()
    wall = time.perf_counter() - t0
    ids = np.stack([engine.done[r].ids for r in rids])
    return (ids, wall, dict(loader.LAUNCHES), dict(loader.ENTRY_LAUNCHES),
            engine.stats["batches"] - b0)


def _searcher_ids(searcher, queries) -> "np.ndarray":
    import numpy as np

    from repro_torch.plan import SearchRequest

    return np.concatenate([
        searcher.search(SearchRequest(queries=queries[s : s + 256])).ids
        for s in range(0, len(queries), 256)])


def _tiled_record(name, engine, searcher, queries, gt, log) -> dict:
    """Serve ``queries`` through a tiled engine: QPS, recall@10, launches
    per kernel, cross-tile merges (sort-entry launches) against batches,
    engine ids against ``Searcher.search``, and 64 queries on the CPU (the
    plain versions over the same tiles) against the card."""
    from repro_torch.core.dataset import recall_at_k
    from repro_torch.plan import Searcher
    from repro_torch.shard import TiledCorpus

    ids, wall, launches, entries, batches = _serve(engine, queries)
    tiled = searcher.tiled
    cpu = Searcher.open(TiledCorpus(*(t.cpu() for t in tiled)),
                        cfg=searcher.cfg, metric=searcher.metric,
                        probe_tiles=searcher.probe_tiles)
    cpu_ids = _searcher_ids(cpu, queries[:64])
    rec = {
        "num_tiles": tiled.num_tiles, "probe_tiles": engine.probe_tiles,
        "queries": len(queries), "wall_s": wall, "qps": len(queries) / wall,
        "recall_at_10": recall_at_k(ids, gt, 10), "launches": launches,
        "entry_launches": entries, "batches": batches,
        "cross_tile_merges": entries.get("bitonic_sort_launch", 0),
        "launches_per_batch": sum(entries.values()) / batches,
        "engine_equals_searcher": bool(
            (_searcher_ids(searcher, queries) == ids).all()),
        "cross_device_identical_rows": float(
            (cpu_ids == ids[:64]).all(1).mean()),
    }
    log(f"tiled {name}: {len(queries)} queries in {wall:.3f} s: "
        f"QPS={rec['qps']:.1f} recall@10={rec['recall_at_10']:.4f} "
        f"batches={batches} cross_tile_merges={rec['cross_tile_merges']} "
        f"launches/batch={rec['launches_per_batch']:.1f} "
        f"engine_equals_searcher={rec['engine_equals_searcher']} "
        f"cross_device={rec['cross_device_identical_rows']:.4f} "
        f"launches={json.dumps(launches)}")
    return rec


def _ab_arm(searcher, queries) -> tuple:
    """``queries`` through ``searcher``, 256 a request: (wall seconds, raw
    results, launches by C entry summed, requests), counts zeroed just
    before."""
    from repro_torch.kernels import loader
    from repro_torch.plan import SearchRequest

    loader.reset_launch_counts()
    t0 = time.perf_counter()
    raws = [searcher.search(SearchRequest(queries=queries[s : s + 256])).raw
            for s in range(0, len(queries), 256)]
    wall = time.perf_counter() - t0
    return wall, raws, sum(loader.ENTRY_LAUNCHES.values()), len(raws)


def _rounds_paid(raw, unrolled: bool) -> int:
    """Rounds a batch pays: its slowest lane's, and with the unrolled
    fan-out each tile's slowest lane's, one tile after another."""
    rounds = raw.per_tile.rounds if hasattr(raw, "per_tile") else raw.rounds
    if unrolled:
        return int(rounds.amax(1).sum())
    return int(rounds.max())


def _same_sharded(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(
        [a.ids, a.dists, a.probed, *a.per_tile],
        [b.ids, b.dists, b.probed, *b.per_tile]))


def fan_out_ab(torch, idx, queries, log) -> dict:
    """AB_PAIRS alternating pairs of AB_QUERIES queries (a pair's two arms
    on the same queries, the first arm alternating): the cluster tiles at
    full fan-out unrolled (``use_vmap=False``) against the batched default,
    then the flat index against the batched tiles.  Per arm: QPS of each
    pair, median and spread, launches and rounds per 256-query request;
    unrolled and batched must agree bit for bit (ids, distances, ``probed``
    and every per-tile counter)."""
    import statistics

    from repro_torch.plan import Searcher

    kw = dict(num_tiles=NUM_TILES, shard_policy="cluster")
    arms = {"unrolled": Searcher.open(idx, use_vmap=False, **kw),
            "batched": Searcher.open(idx, **kw), "flat": Searcher.open(idx)}
    for s in arms.values():                    # warm-up, untimed
        _ab_arm(s, queries[:256])
    out = {}
    for a, b in (("unrolled", "batched"), ("flat", "batched")):
        rec = {n: {"qps": [], "launches_per_batch": [],
                   "rounds_per_batch": []} for n in (a, b)}
        equal = True
        for i in range(AB_PAIRS):
            s = (i * AB_QUERIES) % len(queries)
            qs = queries[s : s + AB_QUERIES]
            raws = {}
            for name in ((a, b) if i % 2 == 0 else (b, a)):
                wall, raws[name], launches, batches = _ab_arm(arms[name], qs)
                r = rec[name]
                r["qps"].append(len(qs) / wall)
                r["launches_per_batch"].append(launches / batches)
                r["rounds_per_batch"].append(statistics.mean(
                    _rounds_paid(x, name == "unrolled") for x in raws[name]))
            if a == "unrolled":
                equal &= all(_same_sharded(x, y)
                             for x, y in zip(raws[a], raws[b]))
        for name, r in rec.items():
            r["median_qps"] = statistics.median(r["qps"])
            r["spread_qps"] = [min(r["qps"]), max(r["qps"])]
            r["mean_launches_per_batch"] = statistics.mean(
                r["launches_per_batch"])
            r["mean_rounds_per_batch"] = statistics.mean(
                r["rounds_per_batch"])
        ratios = [y / x for x, y in zip(rec[a]["qps"], rec[b]["qps"])]
        rec["median_ratio"] = statistics.median(ratios)
        rec["ratio_spread"] = [min(ratios), max(ratios)]
        if a == "unrolled":
            rec["bit_equal"] = bool(equal)
        out[f"{a}_vs_{b}"] = rec
        log(f"fan-out A/B {a} vs {b}, {AB_PAIRS} alternating pairs of "
            f"{AB_QUERIES} queries: " + "; ".join(
                f"{n} QPS median {rec[n]['median_qps']:.1f} spread "
                f"{rec[n]['spread_qps'][0]:.1f}-{rec[n]['spread_qps'][1]:.1f}"
                f" launches/batch {rec[n]['mean_launches_per_batch']:.1f} "
                f"rounds/batch {rec[n]['mean_rounds_per_batch']:.2f} "
                f"(pairs {[round(x, 1) for x in rec[n]['qps']]})"
                for n in (a, b))
            + f"; {b}/{a} median {rec['median_ratio']:.3f} spread "
            f"{rec['ratio_spread'][0]:.3f}-{rec['ratio_spread'][1]:.3f}"
            + (f"; bit_equal={rec['bit_equal']}" if a == "unrolled" else ""))
    return out


def ivf_phase(torch, idx, flat_ids, log) -> tuple:
    """fig11's IVF-PQ baseline on the main path's corpus: ``build_ivf``
    (nlist=64, PQ 32 x 256 with 8 k-means iterations, residual) on the
    card, then SHARD_QUERIES queries through ``search_ivf`` at each nprobe
    of IVF_NPROBES: recall@10 beside the graph's on the same queries, QPS,
    rows scanned a query, launches (zeroed before each).  Then
    IVF_CHECK_QUERIES queries on the card against the same index on the
    CPU (the plain versions).  Returns (the record, the arguments of one
    chunk's ``pq_adt`` and lookup launches at the largest nprobe, for the
    kernel phase)."""
    from repro_torch.configs.base import PQConfig
    from repro_torch.core.dataset import recall_at_k
    from repro_torch.core.ivf import IVFIndex, build_ivf, search_ivf
    from repro_torch.kernels import loader, ops

    import numpy as np

    ds = idx.dataset
    queries, gt = ds.queries[:SHARD_QUERIES], ds.gt[:SHARD_QUERIES]
    stages = {}
    t0 = time.perf_counter()
    ivf = build_ivf(ds.base, PQConfig(num_subvectors=32, num_centroids=256,
                                      kmeans_iters=8), ds.metric,
                    nlist=IVF_NLIST, device=idx.device,
                    stage_times=stages)
    torch.cuda.synchronize()
    stages["total"] = time.perf_counter() - t0
    lens = (ivf.lists >= 0).sum(1)
    out = {"build_s": stages, "list_len_max": int(lens.max()),
           "list_len_mean": float(lens.float().mean()),
           "graph_recall_at_10": recall_at_k(flat_ids[:SHARD_QUERIES], gt,
                                             10),
           "sweep": {}}
    log(f"IVF-PQ build (nlist={IVF_NLIST}, PQ 32 x 256, residual) seconds "
        f"{json.dumps(stages)}; list lengths max {out['list_len_max']} "
        f"mean {out['list_len_mean']:.1f}")
    search_ivf(ivf, queries[:256], 10, IVF_NPROBES[0])     # warm-up
    for nprobe in IVF_NPROBES:
        loader.reset_launch_counts()
        t0 = time.perf_counter()
        ids, _, scanned = search_ivf(ivf, queries, 10, nprobe)
        wall = time.perf_counter() - t0
        rec = out["sweep"][nprobe] = {
            "wall_s": wall, "qps": len(queries) / wall,
            "recall_at_10": recall_at_k(ids, gt, 10),
            "scanned_per_query": float(scanned.mean()),
            "launches": dict(loader.LAUNCHES)}
        log(f"IVF-PQ nprobe={nprobe}: {len(queries)} queries in {wall:.3f} s"
            f": QPS={rec['qps']:.1f} recall@10={rec['recall_at_10']:.4f} "
            f"(graph {out['graph_recall_at_10']:.4f}) scanned/query="
            f"{rec['scanned_per_query']:.1f} launches="
            f"{json.dumps(rec['launches'])}")

    nq = IVF_CHECK_QUERIES
    cpu = IVFIndex(coarse_centroids=ivf.coarse_centroids.cpu(),
                   lists=ivf.lists.cpu(), list_codes=ivf.list_codes.cpu(),
                   lengths=ivf.lengths.cpu(), codebook=ivf.codebook,
                   residual=ivf.residual, metric=ivf.metric)
    g_ids, g_d, g_n = search_ivf(ivf, queries[:nq], 10, 8)
    c_ids, c_d, c_n = search_ivf(cpu, queries[:nq], 10, 8)
    fin = np.isfinite(c_d)
    out["cross_device"] = {
        "queries": nq, "nprobe": 8,
        "ids_equal": bool((g_ids == c_ids).all()),
        "rows_identical": float((g_ids == c_ids).all(1).mean()),
        "scanned_equal": bool((g_n == c_n).all()),
        "finite_equal": bool((np.isfinite(g_d) == fin).all()),
        "max_rel_err": float(np.max(np.abs(g_d[fin] - c_d[fin])
                                    / np.maximum(np.abs(c_d[fin]), 1e-6))),
        # rtol 1e-4 plus 1e-6 of the largest (the repo's distance bar)
        "dists_close": bool(np.allclose(
            g_d[fin], c_d[fin], rtol=1e-4,
            atol=1e-6 * float(np.abs(c_d[fin]).max())))}
    log(f"IVF-PQ card vs CPU ({nq} queries, nprobe 8): "
        f"{json.dumps(out['cross_device'])}")

    # one chunk's launches at the largest nprobe, for the kernel phase
    captured = {}
    real = {"adt": ops.pq_adt, "lists": ops.pq_lookup_lists}

    def spy(key):
        def call(*args):
            captured.setdefault(key, args)
            return real[key](*args)
        return call

    ops.pq_adt, ops.pq_lookup_lists = spy("adt"), spy("lists")
    try:
        search_ivf(ivf, queries, 10, IVF_NPROBES[-1])
    finally:
        ops.pq_adt, ops.pq_lookup_lists = real["adt"], real["lists"]
    probes, lengths, list_codes, _ = captured["lists"]
    max_len = list_codes.shape[1]
    valid = (torch.arange(max_len, device=probes.device)
             < lengths[probes.long()][..., None])
    out["kernel_shapes"] = {"adt_lanes": captured["adt"][0].shape[0],
                            "lookup": [probes.numel(), max_len],
                            "valid_share": float(valid.float().mean())}
    return out, captured


def tiled_phase(torch, idx, flat_ids, log) -> tuple:
    """The main path's index served in NUM_TILES channel tiles through
    ``ServingEngine(num_tiles=, shard_policy=, probe_tiles=)``: cluster
    tiles at full fan-out and routed to 2 tiles, SHARD_QUERIES queries each.  Each policy's tiles are built
    once (per-tile graphs rebuilt on the card; the seconds of the
    assignment and of the tile graphs) and reused by its engines and
    Searchers.  Returns (the record, {(num_tiles, policy): tiles})."""
    from repro_torch.core import index as index_mod
    from repro_torch.plan import Searcher
    from repro_torch.serve import ServingEngine

    from repro_torch.core.dataset import recall_at_k

    queries = idx.dataset.queries[:SHARD_QUERIES]
    gt = idx.dataset.gt[:SHARD_QUERIES]
    real = index_mod.ProximaIndex.sharded_corpus
    # the flat engine's recall over the same queries, the tiles' yardstick
    built, out = {}, {"tile_build_s": {}, "variants": {},
                      "flat_recall_at_10": recall_at_k(
                          flat_ids[:SHARD_QUERIES], gt, 10)}
    log(f"flat recall@10 over the tiled phase's {SHARD_QUERIES} queries: "
        f"{out['flat_recall_at_10']:.4f}")

    def sharded_corpus(self, num_tiles=None, policy=None, replicate_hot=None):
        if (num_tiles, policy) not in built:
            from repro_torch.shard import partition_index

            stages = {}
            t0 = time.perf_counter()
            built[num_tiles, policy] = partition_index(
                self, num_tiles, policy, stage_times=stages)
            torch.cuda.synchronize()
            stages["total"] = time.perf_counter() - t0
            out["tile_build_s"][policy] = stages
            part = built[num_tiles, policy][1]
            log(f"tiles ({policy}, P={num_tiles}) built in "
                f"{json.dumps(stages)} s; sizes {part.tile_sizes.tolist()}")
        return built[num_tiles, policy]

    index_mod.ProximaIndex.sharded_corpus = sharded_corpus
    try:
        for policy, probe in TILED_VARIANTS:
            name = f"{policy}_probe{probe}" if probe else f"{policy}_full"
            kw = dict(num_tiles=NUM_TILES, shard_policy=policy,
                      probe_tiles=probe)
            engine = ServingEngine(idx, batch_size=256, **kw)
            searcher = Searcher.open(idx, **kw)
            out["variants"][name] = _tiled_record(
                name, engine, searcher, queries, gt, log)
        out["ab"] = fan_out_ab(torch, idx, queries, log)
    finally:
        index_mod.ProximaIndex.sharded_corpus = real
    return out, built


def segmented_phase(torch, cfg, ds, dev, log) -> tuple:
    """``build_segmented`` of the main path's first SEGMENTED_BASE vectors
    in SEGMENT_SIZE segments on the card (stage seconds summed over the
    segments, the stitch's seconds and patched rows; the ground truth
    recomputed over those vectors), then SHARD_QUERIES queries served
    tiled through its segments and flat through ``to_flat()`` (the
    stitched graph).  Returns (the record, the segmented index)."""
    from repro_torch.core.dataset import Dataset, exact_knn, recall_at_k
    from repro_torch.core.segmented import build_segmented
    from repro_torch.plan import Searcher
    from repro_torch.serve import ServingEngine

    n = min(SEGMENTED_BASE, ds.num_base)
    base = ds.base[:n]
    ds = Dataset(base=base, queries=ds.queries,
                 gt=exact_knn(ds.queries, base, ds.gt.shape[1], ds.metric,
                              device=dev),
                 metric=ds.metric,
                 config=dataclasses.replace(ds.config, num_base=n))
    cfg = dataclasses.replace(
        cfg, dataset=ds.config,
        build=dataclasses.replace(cfg.build, stitch_sample=STITCH_SAMPLE))
    stages = {}
    t0 = time.perf_counter()
    seg = build_segmented(cfg, dataset=ds, segment_size=SEGMENT_SIZE,
                          reorder_samples=REORDER_SAMPLES, device=dev,
                          stage_times=stages)
    torch.cuda.synchronize()
    stages["total"] = time.perf_counter() - t0
    out = {"segments": seg.num_segments, "build_s": stages,
           "stitch_anchors": len(seg.stitch.anchors),
           "patched_rows": seg.stitch.patched_rows,
           "cross_edges": seg.stitch.cross_edges,
           "hot_counts": [s.hot_count for s in seg.segments]}
    log(f"segmented build ({seg.num_segments} x {SEGMENT_SIZE}): seconds "
        f"{json.dumps(stages)}, {len(seg.stitch.anchors)} anchors stitched, "
        f"{seg.stitch.patched_rows} rows patched, {seg.stitch.cross_edges} "
        f"cross-segment edges")
    queries = ds.queries[:SHARD_QUERIES]
    # tiled through the segments: global built ids
    engine = ServingEngine(seg, batch_size=256)
    out["tiled"] = _tiled_record(
        "segments", engine, Searcher.open(seg), queries,
        seg.global_perm()[ds.gt[:SHARD_QUERIES]], log)
    flat = seg.to_flat()
    engine = ServingEngine(flat, batch_size=256)
    ids, wall, launches, _, batches = _serve(engine, queries)
    out["flat"] = {"wall_s": wall, "qps": len(queries) / wall,
                   "recall_at_10": recall_at_k(
                       ids, flat.dataset.gt[:SHARD_QUERIES], 10),
                   "launches": launches, "batches": batches}
    log(f"segmented flat (stitched graph): {len(queries)} queries in "
        f"{wall:.3f} s: QPS={out['flat']['qps']:.1f} "
        f"recall@10={out['flat']['recall_at_10']:.4f} "
        f"launches={json.dumps(launches)}")
    out["launches"] = {k: out["tiled"]["launches"][k] + launches[k]
                       for k in launches}
    return out, seg


OBS_PAIRS = 3                    # obs on / off QPS pairs, alternating
NAND_FIGURES = ("nand_model_qps", "nand_latency_us", "nand_pj_per_query",
                "nand_core_utilization")


def _hist_medians(metrics, name: str) -> dict:
    """{label string: p50} of one histogram of an obs registry."""
    cells = metrics.snapshot()["histograms"].get(name, {})
    return {label or "-": cell["p50"] for label, cell in cells.items()}


def _nand_medians(metrics) -> dict:
    """The NAND model's per-batch figures (``nand/simulator.py`` fed with
    the run's traversal counters), median over the billed batches, per
    plan label."""
    return {f: _hist_medians(metrics, f) for f in NAND_FIGURES}


def _serve_ids(engine, queries, continuous=False) -> tuple:
    """Submit ``queries``, serve them all; (ids, dists, wall seconds,
    lanes stepped per tick in continuous mode)."""
    import numpy as np

    t0 = time.perf_counter()
    rids = [engine.submit(v) for v in queries]
    occupied = _served(engine) if continuous else engine.drain()
    wall = time.perf_counter() - t0
    done = [engine.done[r] for r in rids]
    return (np.stack([r.ids for r in done]), np.stack([r.dists for r in done]),
            wall, occupied)


def obs_phase(torch, idx, tiles, seg, log) -> dict:
    """Observability and NAND billing on the 1M index (``repro_torch.obs``,
    ``repro_torch.nand``): SHARD_QUERIES queries through the batch engine
    with ``Observability.on(quality=True, quality_sample_rate=1.0)`` and
    with obs off (ids and distances must be equal, the kernel hooks' calls
    equal the launches, every query billed, the shadow recall within 0.002
    of recall@10 against the exact ground truth); the continuous engine
    with ``convergence=True`` (one record per lane-round); the cluster
    tiles at full fan-out with obs on (and one execution's channel traces
    through ``simulate_sharded``); the segmented index's ``build_trace()``
    through ``simulate_build``; then the QPS of ``Observability.on()``
    (metrics, tracing, billing) against obs off, OBS_PAIRS alternating
    pairs on the same engines."""
    import dataclasses

    import numpy as np

    from repro_torch.core import index as index_mod
    from repro_torch.core.dataset import recall_at_k
    from repro_torch.kernels import loader
    from repro_torch.nand import (
        simulate_build, simulate_sharded, traces_from_plan_execution,
    )
    from repro_torch.obs import NULL_OBS, Observability
    from repro_torch.plan import Searcher, SearchRequest
    from repro_torch.serve import ServingEngine

    t_phase = time.perf_counter()
    queries = idx.dataset.queries[:SHARD_QUERIES]
    gt = idx.dataset.gt[:SHARD_QUERIES]
    out = {"queries": len(queries)}

    # batch engine, obs on with shadow recall on every request, then off
    obs = Observability.on(quality=True, quality_sample_rate=1.0)
    engine = ServingEngine(idx, batch_size=256, obs=obs)
    m = obs.metrics
    calls0 = {k: m.counter_value("kernel_calls", kernel=k)
              for k in loader.LAUNCHES}
    loader.reset_launch_counts()
    ids_on, dists_on, wall, _ = _serve_ids(engine, queries)
    launches = dict(loader.LAUNCHES)
    calls = {k: m.counter_value("kernel_calls", kernel=k) - calls0[k]
             for k in launches}
    NULL_OBS.install_kernel_hooks()
    ids_off, dists_off, _, _ = _serve_ids(
        ServingEngine(idx, batch_size=256), queries)
    recall = recall_at_k(ids_off, gt, 10)
    shadow = obs.quality.overall()
    out["batch"] = {
        "wall_s": wall, "launches": launches, "kernel_calls": calls,
        "bit_equal": bool(np.array_equal(ids_on, ids_off)
                          and np.array_equal(dists_on, dists_off)),
        "billed_queries": m.counter_total("nand_billed_queries"),
        "unbilled_batches": m.counter_total("nand_unbilled_batches"),
        "shadow_errors": m.counter_total("shadow_errors"),
        "shadow_samples": shadow["samples"],
        "shadow_recall": shadow["estimate"], "recall_at_10": recall,
        "nand": _nand_medians(m),
        "kernel_wall_ms": _hist_medians(m, "kernel_wall_ms"),
        "kernel_wall_count": {
            k: getattr(m.histogram("kernel_wall_ms", kernel=k), "count", 0)
            for k in launches},
        "kernel_execute_ms": _hist_medians(m, "kernel_execute_ms"),
    }
    log(f"obs batch: bit_equal={out['batch']['bit_equal']} "
        f"shadow_recall={shadow['estimate']:.4f} recall@10={recall:.4f} "
        f"billed={out['batch']['billed_queries']} launches="
        f"{json.dumps(launches)} kernel_calls={json.dumps(calls)}")
    log(f"in-search kernel_wall_ms medians (CUDA events around each launch, "
        f"L2 warm): {json.dumps(out['batch']['kernel_wall_ms'])}")
    log(f"NAND model medians, flat batch: {json.dumps(out['batch']['nand'])}")

    # continuous engine with the convergence log
    obs = Observability.on(convergence=True, convergence_capacity=1 << 20)
    engine = ServingEngine(idx, batch_size=256, continuous=True, slots=256,
                           obs=obs)
    ids_c, dists_c, wall, occupied = _serve_ids(engine, queries, True)
    NULL_OBS.install_kernel_hooks()
    conv = obs.convergence
    out["continuous"] = {
        "wall_s": wall, "lane_rounds": int(sum(occupied)),
        "records": conv.count, "dropped": conv.dropped,
        "label_rounds": int(sum(conv.labels.values())),
        "labels": len(conv.labels),
        "equals_batch": bool(np.array_equal(ids_c, ids_off)
                             and np.array_equal(dists_c, dists_off)),
        "billed_queries": obs.metrics.counter_total("nand_billed_queries"),
        "unbilled_batches": obs.metrics.counter_total(
            "nand_unbilled_batches"),
        "nand": _nand_medians(obs.metrics),
    }
    log(f"obs continuous: records={conv.count} lane_rounds="
        f"{out['continuous']['lane_rounds']} labels={len(conv.labels)} "
        f"equals_batch={out['continuous']['equals_batch']} NAND medians "
        f"{json.dumps(out['continuous']['nand'])}")

    # cluster tiles at full fan-out, the tiled phase's tiles reused
    real = index_mod.ProximaIndex.sharded_corpus
    index_mod.ProximaIndex.sharded_corpus = \
        lambda self, num_tiles=None, policy=None, replicate_hot=None: \
        tiles[num_tiles, policy]
    try:
        obs = Observability.on()
        kw = dict(num_tiles=NUM_TILES, shard_policy="cluster", probe_tiles=0)
        engine = ServingEngine(idx, batch_size=256, obs=obs, **kw)
        served0 = obs.metrics.counter_total("tile_lanes_served")
        ids_t, _, wall, _ = _serve_ids(engine, queries)
        NULL_OBS.install_kernel_hooks()
        res = Searcher.open(idx, **kw).search(
            SearchRequest(queries=queries[:256]))
    finally:
        index_mod.ProximaIndex.sharded_corpus = real
    sharded = simulate_sharded(traces_from_plan_execution(res, index=idx))
    tm = obs.metrics
    out["tiled"] = {
        "wall_s": wall, "recall_at_10": recall_at_k(ids_t, gt, 10),
        "billed_queries": tm.counter_total("nand_billed_queries"),
        "unbilled_batches": tm.counter_total("nand_unbilled_batches"),
        "tile_lanes_served": tm.counter_total("tile_lanes_served") - served0,
        "tile_load_imbalance": tm.gauge_value("tile_load_imbalance"),
        "nand": _nand_medians(tm),
        "sharded": {"channels": len(sharded.per_channel),
                    "qps": sharded.qps, "latency_us": sharded.latency_us,
                    "qps_per_watt": sharded.qps_per_watt,
                    "load_imbalance": sharded.load_imbalance,
                    "channel_utilization": sharded.channel_utilization},
    }
    log(f"obs tiled (cluster, full fan-out): recall@10="
        f"{out['tiled']['recall_at_10']:.4f} billed="
        f"{out['tiled']['billed_queries']} tile_lanes_served="
        f"{out['tiled']['tile_lanes_served']} NAND medians "
        f"{json.dumps(out['tiled']['nand'])}; simulate_sharded over one "
        f"batch's channel traces: {json.dumps(out['tiled']['sharded'])}")

    # the segmented build's NAND program/erase cost
    bt = seg.build_trace(index_bits=seg.segments[0].gap.bit_width
                         if seg.segments[0].gap else 32)
    build = simulate_build(bt)
    out["build"] = {"trace": dataclasses.asdict(bt),
                    "patched_rows": seg.stitch.patched_rows,
                    "sim": build.to_dict()}
    log(f"NAND build model: trace {json.dumps(out['build']['trace'])} -> "
        f"{json.dumps(out['build']['sim'])}")

    # QPS with metrics + tracing + billing on, against off, alternating
    obs = Observability.on()
    engines = {"on": ServingEngine(idx, batch_size=256, obs=obs),
               "off": ServingEngine(idx, batch_size=256)}
    qps = {"on": [], "off": []}
    for i in range(OBS_PAIRS):
        for mode in (("on", "off") if i % 2 == 0 else ("off", "on")):
            (obs if mode == "on" else NULL_OBS).install_kernel_hooks()
            torch.cuda.synchronize()
            qps[mode].append(SHARD_QUERIES
                             / _serve_ids(engines[mode], queries)[2])
    NULL_OBS.install_kernel_hooks()
    out["qps_pairs"] = qps
    out["pair_kernel_wall_ms"] = _hist_medians(obs.metrics, "kernel_wall_ms")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"QPS with Observability.on() / off, {OBS_PAIRS} alternating pairs "
        f"of {SHARD_QUERIES} queries: {json.dumps(qps)}; in-search "
        f"kernel_wall_ms medians over the pairs' obs-on runs "
        f"{json.dumps(out['pair_kernel_wall_ms'])}; observability phase "
        f"{out['phase_s']:.1f} s")
    return out


def _stream_serve(engine, queries, continuous, counts) -> dict:
    """One run of ``queries`` through a streaming engine, launch counts
    zeroed just before: ids and distances, wall seconds, launches by kernel
    and by C entry, the merged batches it fused (flushed batches, or
    retired sets of lanes), and the seconds the host spent in the delta
    segment's search (``counts`` is the phase's spy record)."""
    from repro_torch.kernels import loader

    b0 = engine.stats["batches"]
    counts.update(merges=0, delta_s=0.0)
    loader.reset_launch_counts()
    ids, dists, wall, _ = _serve_ids(engine, queries, continuous)
    batches = engine.stats["batches"] - b0
    return {"ids": ids, "dists": dists, "wall_s": wall,
            "qps": len(queries) / wall, "launches": dict(loader.LAUNCHES),
            "entry_launches": dict(loader.ENTRY_LAUNCHES),
            "merged_batches": batches + counts["merges"],
            "delta_s": counts["delta_s"],
            "delta_share": counts["delta_s"] / wall}


def _corpus_bytes(corpus) -> int:
    return sum(int(getattr(corpus, f).nbytes)
               for f in ("base", "adjacency", "codes", "centroids"))


def stream_phase(torch, idx, flat_qps: dict, build_peak: int, seed: int,
                 out_dir, log) -> dict:
    """The streaming target on the main path's index: a ``MutableIndex``
    over it (the rebuilt base is the mutable's own; ``idx`` is untouched)
    at ``StreamConfig``'s defaults but a ``delta_capacity`` of
    STREAM_DELTA_CAPACITY, served by ``ServingEngine(mutable,
    batch_size=256)`` and the continuous engine (slots=256), both with
    ``auto_consolidate=False`` so that the full delta is served before the
    capacity-forced consolidation.  Updates, from ``seed``: STREAM_DELETES
    random base ext ids and each of the first 2,048 queries' exact top-1
    base neighbour tombstoned; ``delta_capacity`` inserts, each a
    random base vector plus N(0, 0.1^2) noise, through the continuous
    engine, filling the delta.  STREAM_QUERIES of the main path's queries and
    STREAM_SELF_QUERIES of the inserted vectors are served through both
    engines and ``merged_search_kernel``; then, with 256 continuous lanes in
    flight, insert number ``delta_capacity + 1`` consolidates inside
    ``insert``, and the
    same sets are served again.  Records inserts a second, QPS beside the
    flat engine's, the delta search's share of the wall time, recall@10
    against the exact kNN of ``live_vectors()`` (on the card), the
    consolidation's seconds by build stage, device memory around it (at
    its start, when the rebuild starts, at the rebuild's peak, after it;
    ``build_peak`` is the main path's build's peak over its start) and
    ``write_amplification()``; ``stream_failures`` checks them.  The
    inserts, the self-queries' rows and the delta's search ids for them go
    to ``out_dir/stream_inserts.npz``, for ``tests/_delta_self_recall.py``
    to replay through the reference's delta segment."""
    import dataclasses

    import numpy as np

    from repro_torch.core.dataset import exact_knn, recall_at_k
    from repro_torch.plan.rounds import RoundSession
    import repro_torch.stream.mutable as mutable_mod
    from repro_torch.serve import ServingEngine
    from repro_torch.stream import MutableIndex, merged_search_kernel
    from repro_torch.stream.delta import DeltaSegment

    t_phase = time.perf_counter()
    dev = idx.device
    rng = np.random.default_rng(seed + 17)
    n = idx.dataset.num_base
    mutable = MutableIndex(idx, dataclasses.replace(
        idx.config.stream, delta_capacity=STREAM_DELTA_CAPACITY))
    cap = mutable.stream_cfg.delta_capacity
    queries = idx.dataset.queries[:STREAM_QUERIES]
    dead = np.union1d(rng.choice(n, STREAM_DELETES, replace=False),
                      idx.dataset.gt[:2048, 0]).astype(np.int64)
    picks = idx.dataset.base[rng.choice(n, cap + 1)]
    inserts = (picks + 0.1 * rng.standard_normal(picks.shape)).astype(
        np.float32)
    self_rows = rng.choice(cap, STREAM_SELF_QUERIES, replace=False)
    served = np.concatenate([queries, inserts[self_rows]])
    kw = dict(batch_size=256, auto_consolidate=False)
    cont = ServingEngine(mutable, continuous=True, slots=256, **kw)
    batch = ServingEngine(mutable, **kw)
    out = {"stream_cfg": dataclasses.asdict(mutable.stream_cfg),
           "queries": len(queries), "self_queries": STREAM_SELF_QUERIES}

    t0 = time.perf_counter()
    for e in dead:
        cont.delete(int(e))
    out["delete_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ext_ins = np.array([cont.insert(v) for v in inserts[:cap]], np.int64)
    out["insert_s"] = time.perf_counter() - t0
    out["inserts_per_s"] = cap / out["insert_s"]
    out["delta_full"] = bool(mutable.delta_full)
    log(f"streaming: {len(dead)} deletes in {out['delete_s']:.2f} s, {cap} "
        f"inserts in {out['insert_s']:.1f} s ({out['inserts_per_s']:.2f} "
        f"inserts/s on the host), delta full {out['delta_full']}")

    counts = {}
    real_search, real_complete = DeltaSegment.search_batch, \
        RoundSession.complete

    def search_batch(self, q, k):
        a = time.perf_counter()
        res = real_search(self, q, k)
        counts["delta_s"] += time.perf_counter() - a
        return res

    def complete(self, q, core):
        counts["merges"] += self.plan.kind == "merged"
        return real_complete(self, q, core)

    def segment_found(rows, in_delta):
        """Whether the search of the segment holding each of the inserted
        vectors ``rows`` returns it among the merged kernel's candidates
        from that segment (k + over-fetch): the delta's greedy search while
        it is there, the base's graph search after the consolidation."""
        k_seg = 10 + mutable.stream_cfg.base_overfetch
        vecs = inserts[rows]
        if in_delta:                # delta local id i is insert i
            ids, _ = mutable.delta.search_batch(vecs, k_seg)
            return [r in row for r, row in zip(rows, ids)]
        from repro_torch.core.search import graph_search

        cfg = dataclasses.replace(mutable.base.config.search, k=k_seg)
        res = graph_search(mutable.corpus(), vecs, cfg, mutable.metric)
        ext = mutable.ext_base[res.ids.clamp(min=0).cpu().numpy()]
        return [e in row for e, row in zip(ext_ins[rows], ext)]

    def check(name, runs, in_delta):
        """Hold a before/after pair of runs: bit-equal engines, ids equal
        merged_search_kernel's, no tombstoned id, recall, self hits."""
        ext_ids, vecs = mutable.live_vectors()
        gt = ext_ids[exact_knn(queries, vecs, 10, "l2", device=dev)]
        b, c = runs["batch"], runs["continuous"]
        kernel_ids = np.concatenate([
            merged_search_kernel(mutable, served[s : s + 256]).ids
            for s in range(0, len(served), 256)])
        rec = {
            "batch": {k: v for k, v in b.items() if k not in ("ids", "dists")},
            "continuous": {k: v for k, v in c.items()
                           if k not in ("ids", "dists")},
            "engines_equal": bool(np.array_equal(b["ids"], c["ids"])
                                  and np.array_equal(b["dists"], c["dists"])),
            "equals_kernel": bool(np.array_equal(b["ids"], kernel_ids)),
            "tombstones_returned": int(np.isin(b["ids"], dead).sum()
                                       + np.isin(c["ids"], dead).sum()),
            "recall_at_10": recall_at_k(b["ids"][: len(queries)], gt, 10),
            "live": int(len(ext_ids)),
        }
        found = np.array([ext_ins[r] in row for r, row in
                          zip(self_rows, b["ids"][len(queries):])])
        missed = self_rows[~found]
        rec["self_found"] = float(found.mean())
        rec["self_missed"] = missed.tolist()
        # a miss the segment's own search also makes is the algorithm's;
        # one it does not make would be the merge's
        rec["self_missed_by_segment"] = int(
            len(missed) - sum(segment_found(missed, in_delta)))
        log(f"streaming {name}: batch QPS={b['qps']:.1f} (flat "
            f"{flat_qps['batch']:.1f}) continuous QPS={c['qps']:.1f} (flat "
            f"{flat_qps['continuous']:.1f}); delta search share of the wall "
            f"time batch {b['delta_share']:.3f} continuous "
            f"{c['delta_share']:.3f}; recall@10={rec['recall_at_10']:.4f} "
            f"over {rec['live']} live vectors; self-queries found "
            f"{rec['self_found']:.4f} (missed {len(rec['self_missed'])}, the "
            f"segment's own search missed {rec['self_missed_by_segment']} of "
            f"them); engines equal {rec['engines_equal']}, "
            f"== merged_search_kernel {rec['equals_kernel']}; tombstoned ids "
            f"returned {rec['tombstones_returned']}; merged batches "
            f"{b['merged_batches']} / {c['merged_batches']}, sort-entry "
            f"launches {b['entry_launches'].get('bitonic_sort_launch', 0)} / "
            f"{c['entry_launches'].get('bitonic_sort_launch', 0)}; launches "
            f"{json.dumps(b['launches'])} / {json.dumps(c['launches'])}")
        return rec

    DeltaSegment.search_batch, RoundSession.complete = search_batch, complete
    try:
        before = {"batch": _stream_serve(batch, served, False, counts),
                  "continuous": _stream_serve(cont, served, True, counts)}
        out["before"] = check("before the consolidation", before, True)
        # the delta's own search of the self-queries, as the merge calls it
        seg_ids, _ = mutable.delta.search_batch(
            inserts[self_rows], 10 + mutable.stream_cfg.base_overfetch)
        seg_found = np.array([r in row for r, row in zip(self_rows, seg_ids)])
        np.savez(out_dir / "stream_inserts.npz", inserts=inserts,
                 self_rows=self_rows, centroids=mutable.delta.centroids,
                 port_ids=seg_ids, port_missed=self_rows[~seg_found])
        # 256 lanes in flight, then the capacity-forced consolidation
        rids = [cont.submit(v) for v in served]
        cont.step()
        flying = [r.rid for p in cont._pools.values() for r in p.requests
                  if r is not None]
        real_consolidate = mutable.consolidate
        real_build = mutable_mod.build_index
        seen = {}

        def consolidate(*a, **k):
            seen["retired_first"] = all(r in cont.done for r in flying)
            torch.cuda.synchronize()
            seen["mem_before"] = torch.cuda.memory_allocated()
            seen["old_corpus"] = _corpus_bytes(mutable.corpus())
            torch.cuda.reset_peak_memory_stats()
            return real_consolidate(*a, **k)

        def build_index(*a, **k):
            torch.cuda.synchronize()
            seen["mem_rebuild_start"] = torch.cuda.memory_allocated()
            return real_build(*a, **k)

        mutable.consolidate, mutable_mod.build_index = \
            consolidate, build_index
        t0 = time.perf_counter()
        try:
            cont.insert(inserts[cap])
        finally:
            del mutable.consolidate
            mutable_mod.build_index = real_build
        torch.cuda.synchronize()
        out["consolidate_insert_s"] = time.perf_counter() - t0
        out.update(
            lanes_in_flight=len(flying),
            lanes_retired_before_rebuild=seen.get("retired_first", False),
            consolidate_stage_s=mutable.consolidate_stage_s,
            mem_before_bytes=seen.get("mem_before"),
            old_corpus_bytes=seen.get("old_corpus"),
            mem_rebuild_start_bytes=seen.get("mem_rebuild_start"),
            mem_rebuild_peak_bytes=torch.cuda.max_memory_allocated(),
            build_peak_bytes=build_peak,
            mem_after_bytes=torch.cuda.memory_allocated())
        cont.drain()
        out["inflight_run_complete"] = all(r in cont.done for r in rids)
        mutable.corpus()                     # the new base on the card
        torch.cuda.synchronize()
        after = {"batch": _stream_serve(batch, served, False, counts),
                 "continuous": _stream_serve(cont, served, True, counts)}
        out["after"] = check("after the consolidation", after, False)
    finally:
        DeltaSegment.search_batch, RoundSession.complete = \
            real_search, real_complete
    out["stats"] = {k: cont.stats[k]
                    for k in ("inserts", "deletes", "consolidations")}
    out["deletes_applied"] = len(dead)
    out["write_amplification"] = mutable.write_amplification()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"streaming consolidation inside insert {cap + 1}: "
        f"{out['consolidate_insert_s']:.1f} s, stages "
        f"{json.dumps(out['consolidate_stage_s'])}; {len(flying)} lanes in "
        f"flight retired before the rebuild: "
        f"{out['lanes_retired_before_rebuild']}; device memory bytes: "
        f"{out['mem_before_bytes']} at its start (the old corpus "
        f"{out['old_corpus_bytes']}), {out['mem_rebuild_start_bytes']} when "
        f"the rebuild starts, peak {out['mem_rebuild_peak_bytes']} (one "
        f"build's peak over its start: {build_peak}), "
        f"{out['mem_after_bytes']} after; "
        f"engine stats {json.dumps(out['stats'])}; write amplification "
        f"{out['write_amplification']:.4f}; streaming phase "
        f"{out['phase_s']:.1f} s")
    return out


def stream_failures(rec: dict) -> list:
    """The streaming phase's checks."""
    fails = []
    cap = rec["stream_cfg"]["delta_capacity"]
    if not rec["delta_full"]:
        fails.append("the delta was not full after the inserts")
    for when in ("before", "after"):
        r = rec[when]
        if r["tombstones_returned"]:
            fails.append(f"streaming {when}: {r['tombstones_returned']} "
                         "tombstoned ids returned")
        if not r["engines_equal"]:
            fails.append(f"streaming {when}: batch and continuous differ")
        if not r["equals_kernel"]:
            fails.append(f"streaming {when}: engine ids differ from "
                         "merged_search_kernel's")
        if r["recall_at_10"] < 0.5:
            fails.append(f"streaming {when}: recall@10 "
                         f"{r['recall_at_10']:.4f} < 0.5")
        if r["self_missed_by_segment"] != len(r["self_missed"]):
            fails.append(f"streaming {when}: the merge dropped an inserted "
                         f"vector its segment's search found")
        if r["self_found"] < STREAM_SELF_FLOOR:
            fails.append(f"streaming {when}: inserted vectors found "
                         f"themselves in {r['self_found']:.4f} of queries "
                         f"< {STREAM_SELF_FLOOR}")
        for eng in ("batch", "continuous"):
            e = r[eng]
            sorts = e["entry_launches"].get("bitonic_sort_launch", 0)
            if sorts != e["merged_batches"]:
                fails.append(f"streaming {when} {eng}: {sorts} sort-entry "
                             f"launches for {e['merged_batches']} merged "
                             "batches")
            if min(e["launches"].values()) <= 0:
                fails.append(f"streaming {when} {eng}: a kernel never "
                             f"launched: {e['launches']}")
    s = rec["stats"]
    if s["consolidations"] != 1 or s["inserts"] != cap + 1 \
            or s["deletes"] != rec["deletes_applied"] \
            or s["deletes"] < STREAM_DELETES:
        fails.append(f"streaming engine stats {s}")
    if not rec["lanes_in_flight"] or not rec["lanes_retired_before_rebuild"]:
        fails.append(f"{rec['lanes_in_flight']} lanes in flight, retired "
                     f"before the rebuild: "
                     f"{rec['lanes_retired_before_rebuild']}")
    if not rec["inflight_run_complete"]:
        fails.append("the run in flight at the consolidation did not finish")
    if rec["mem_before_bytes"] is None \
            or rec["mem_rebuild_start_bytes"] is None:
        fails.append("the consolidation's memory was not read")
        return fails
    # the old base's corpus is freed before the rebuild allocates the new
    # one, and the rebuild's peak is one build's on top of what remains
    freed = rec["mem_before_bytes"] - rec["old_corpus_bytes"]
    if rec["mem_rebuild_start_bytes"] > freed + (64 << 20):
        fails.append(f"the old corpus was held into the rebuild: "
                     f"{rec['mem_rebuild_start_bytes']} bytes at its start, "
                     f"{freed} without the old corpus")
    if rec["mem_rebuild_peak_bytes"] > freed + rec["build_peak_bytes"] \
            + (128 << 20):
        fails.append(f"the rebuild's peak {rec['mem_rebuild_peak_bytes']} "
                     f"bytes exceeds {freed} + one build's "
                     f"{rec['build_peak_bytes']}")
    if rec["mem_after_bytes"] > rec["mem_before_bytes"] + (64 << 20):
        fails.append(f"device memory grew across the consolidation: "
                     f"{rec['mem_before_bytes']} -> {rec['mem_after_bytes']}")
    return fails


def distributed_failures(rec: dict) -> list:
    """The distributed phase's checks: at world size 1 every mode's ids are
    the flat Searcher's as sorted sets, recall@10 >= 0.5 and every kernel
    launched as the round prescribes; the gloo mesh's ranks exit 0 and
    return the world-size-1 ids; the serving launcher exits 0 with its
    recall line."""
    out = []
    for name, run in rec["world_1"].items():
        if run["same_sets_as_flat"] < 1.0:
            out.append(f"distributed {name}: {run['same_sets_as_flat']:.4f} "
                       "of rows as sets equal the flat search's")
        if run["recall_at_10"] < 0.5:
            out.append(f"distributed {name}: recall@10 "
                       f"{run['recall_at_10']:.4f} < 0.5")
        for kernel, (got, want) in run["launch_check"].items():
            if got != want or got <= 0:
                out.append(f"distributed {name}: {kernel} launched {got} "
                           f"times, expected {want}")
    if any(rec["mesh_exit_codes"]):
        out.append(f"distributed gloo mesh: rank exit codes "
                   f"{rec['mesh_exit_codes']} (distributed_ranks.log)")
    for mode in MESH_MODES:
        if not rec["mesh"].get(mode, {}).get("equals_world_1"):
            out.append(f"distributed gloo mesh {mode}: ids differ from "
                       "world size 1")
    if rec["serve"]["exit_code"] != 0 or not rec["serve"]["recall_line"]:
        out.append(f"python -m repro_torch.launch.serve exited "
                   f"{rec['serve']['exit_code']}: "
                   f"{rec['serve']['stderr'][-500:]}")
    return out


def ivf_failures(rec: dict) -> list:
    out = []
    for nprobe, r in rec["sweep"].items():
        if min(r["launches"]["pq_adt"], r["launches"]["pq_lookup"]) <= 0:
            out.append(f"IVF nprobe={nprobe}: pq_adt or pq_lookup never "
                       f"launched: {r['launches']}")
    cd = rec["cross_device"]
    if not (cd["ids_equal"] and cd["scanned_equal"] and cd["finite_equal"]
            and cd["dists_close"]):
        out.append(f"IVF on the card differs from the CPU's plain versions: "
                   f"{cd}")
    return out


def obs_failures(rec: dict) -> list:
    """The observability phase's checks."""
    fails = []
    b, c, t = rec["batch"], rec["continuous"], rec["tiled"]
    n = rec["queries"]
    if not b["bit_equal"]:
        fails.append("obs on changed ids or distances")
    if b["kernel_calls"] != b["launches"] or min(b["launches"].values()) <= 0:
        fails.append(f"kernel_calls {b['kernel_calls']} != launches "
                     f"{b['launches']}")
    if min(b["kernel_wall_count"].values()) <= 0:
        fails.append(f"a kernel has no in-search time: "
                     f"{b['kernel_wall_count']}")
    for name, r in (("batch", b), ("continuous", c), ("tiled", t)):
        if r["billed_queries"] != n or r["unbilled_batches"]:
            fails.append(f"obs {name}: billed {r['billed_queries']} of {n}, "
                         f"{r['unbilled_batches']} unbilled batches")
    if b["shadow_errors"] or b["shadow_samples"] != n:
        fails.append(f"shadow: {b['shadow_errors']} errors, "
                     f"{b['shadow_samples']} samples of {n}")
    elif abs(b["shadow_recall"] - b["recall_at_10"]) > 0.002:
        fails.append(f"shadow recall {b['shadow_recall']:.4f} vs recall@10 "
                     f"{b['recall_at_10']:.4f}")
    if not (c["records"] == c["lane_rounds"] == c["label_rounds"]
            and c["labels"] == n and not c["dropped"]):
        fails.append(f"convergence log: {c['records']} records, "
                     f"{c['lane_rounds']} lane-rounds, {c['label_rounds']} "
                     f"label rounds, {c['labels']} labels")
    if not c["equals_batch"]:
        fails.append("obs continuous ids differ from the batch engine's")
    if t["tile_lanes_served"] != NUM_TILES * n:
        fails.append(f"tile lanes served {t['tile_lanes_served']}")
    if t["sharded"]["channels"] != NUM_TILES:
        fails.append(f"simulate_sharded: {t['sharded']['channels']} channels")
    if rec["build"]["trace"]["stitched_rows"] != rec["build"]["patched_rows"]:
        fails.append("build trace's stitched rows differ from the stitch's")
    return fails


ZOO_STEPS = 4                    # decode steps a zoo model, card and CPU
ZOO_CHUNKED = ("stablelm-1.6b", "mixtral-8x22b", "granite-moe-3b-a800m",
               "falcon-mamba-7b", "zamba2-1.2b")
SERVE_ARCH = "paligemma-3b"
SERVE_BATCH = 8                  # requests: 256 patches + 32 prompt tokens
SERVE_PROMPT = 32
SERVE_STEPS = 32                 # greedy decode steps
SERVE_TF_RTOL = 1e-3             # f32 decode vs teacher forcing, of max|logit|
SERVE_MESH_SHAPE = (2, 2)        # (data, model) gloo ranks on the one card
SERVE_MESH_STEPS = 2             # of SERVE_STEPS, on that mesh: cut for time
                                 # (8, then 4, before: PERF.md)
# 256 classes x 32 images = 8,192 (512 x 32 before: cut for the smoke's
# time, PERF.md).  Not 32 a class x 2: with 64 a class the
# retriever's build list (2R = 64) holds only the point's own class, the
# graph falls into cliques and recall@10 collapses, in the reference as in
# the port (PERF.md, the model phase)
RETR_CLASSES = 256
RETR_PER_CLASS = 32
RETR_QUERIES = 1024              # fresh noise draws around the same centres
RETR_NOISE = 0.3
RETR_PROMPT = 4                  # prompt tokens of id 0 after the patches
RETR_EMBED_BATCH = 64
RETR_SEARCH_BATCH = 256
RETR_CAPTURE_CALL = 8            # the kernel phase's arguments: a call from
                                 # the 9th on (a round well into the search)
RETR_KERNELS = ("pq_adt", "pq_lookup_gather", "bitonic_merge_topl",
                "l2_rerank_masked")


def _zoo_tol(cfg) -> tuple:
    """(rtol, atol) of card against CPU: 1e-3 in f32; bf16 5e-2, the
    hybrid's 0.15 (PERF.md: bf16 rounding its mamba2 and shared attention
    layers compound, measured against the reference)."""
    if cfg.dtype == "float32":
        return 1e-3, 1e-3
    return (5e-2, 1.5e-1) if cfg.family == "hybrid" else (5e-2, 5e-2)


def zoo_phase(torch, dev, seed: int, log) -> dict:
    """Every architecture's smoke config in f32 and bf16, one set of seeded
    weights on the card and on the CPU: prefill, ZOO_STEPS decode steps and,
    for ZOO_CHUNKED, ``prefill_chunked``; the card's logits against the
    CPU's."""
    import numpy as np

    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch in ARCH_IDS:
        for dt in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_smoke_config(arch), dtype=dt)
            kw = dict(q_chunk=64, ssm_chunk=8)
            cpu = build_model(cfg, device="cpu", generator=torch.Generator(
                ).manual_seed(seed), **kw)
            card = build_model(cfg, device=dev, **kw)
            card.load_state_dict(cpu.state_dict())
            rng = np.random.default_rng(seed)
            b, s = 2, 16
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
            if cfg.family == "vlm":
                batch["frontend"] = rng.standard_normal(
                    (b, cfg.frontend_tokens, cfg.frontend_dim), np.float32)
            if cfg.family == "encdec":
                batch["frontend"] = rng.standard_normal(
                    (b, s, cfg.frontend_dim), np.float32)
            steps = rng.integers(0, cfg.vocab_size, (ZOO_STEPS, b, 1))
            long_prompt = rng.integers(0, cfg.vocab_size, (b, 64))

            def run(model):
                on = {k: torch.as_tensor(v, device=model.device)
                      for k, v in batch.items()}
                lg, cache = model.prefill(
                    on, max_len=s + ZOO_STEPS + cfg.frontend_tokens)
                logits = [lg]
                for t in steps:
                    lg, cache = model.decode_step(
                        cache, torch.as_tensor(t, device=model.device))
                    logits.append(lg)
                if arch in ZOO_CHUNKED:
                    logits.append(model.prefill_chunked({
                        "tokens": torch.as_tensor(long_prompt,
                                                  device=model.device)},
                        seg_len=16)[0])
                return [x.float().cpu() for x in logits]

            got, want = run(card), run(cpu)
            rtol, atol = _zoo_tol(cfg)
            out[f"{arch}/{dt}"] = {
                "max_abs_err": max(float((a - b_).abs().max())
                                   for a, b_ in zip(got, want)),
                "rtol": rtol, "atol": atol, "logits_compared": len(got),
                "ok": all(torch.allclose(a, b_, rtol=rtol, atol=atol)
                          for a, b_ in zip(got, want))}
            del cpu, card
    worst = {k: v["max_abs_err"] for k, v in out.items()}
    log(f"model zoo, card vs CPU (prefill, {ZOO_STEPS} decode steps, "
        f"prefill_chunked for {len(ZOO_CHUNKED)} archs; f32 with TF32 off "
        f"at 1e-3, bf16 at 5e-2, the hybrid's at 0.15): max abs err "
        f"{json.dumps(worst)}; all within: "
        f"{all(v['ok'] for v in out.values())}")
    return out


def _count_ops(fn) -> dict:
    """The aten ops that ``fn()`` dispatches, views apart: the host's work
    items (a non-view op launches about one kernel on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = {"ops": 0, "views": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts["views" if func.is_view else "ops"] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return counts


def serve_phase(torch, dev, cfg, seed: int, log) -> tuple:
    """PaliGemma at ``cfg``'s width in its own dtype, weights from a seeded
    generator on the card: SERVE_BATCH requests of 256 patch embeddings +
    SERVE_PROMPT tokens through ``prefill`` (max_len 320), then SERVE_STEPS
    greedy ``decode_step``s, timed (one untimed round first).  Then the
    same requests on an f32 copy of the weights: the decode steps' logits
    against one teacher-forced forward over prompt + generated tokens.
    Returns (record, the bf16 model, for the retrieval)."""
    from repro_torch.models.model import build_model

    rec = {"config": cfg.name, "dtype": cfg.dtype}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    rec["params"] = sum(p.numel() for p in model.parameters())
    rec["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in model.parameters())
    batch = _serve_inputs(torch, dev, cfg, seed)
    toks, front = batch["tokens"], batch["frontend"]
    internal = cfg.frontend_tokens + SERVE_PROMPT
    max_len = internal + SERVE_STEPS

    def serve(m, keep_logits=False):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, cache = m.prefill(batch, max_len=max_len)
        tok = lg.argmax(-1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        fed, logits, step_s = [], [], []
        for _ in range(SERVE_STEPS):
            fed.append(tok)
            t = time.perf_counter()
            lg, cache = m.decode_step(cache, tok)
            tok = lg.argmax(-1)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            if keep_logits:
                logits.append(lg[:, 0])
        return prefill_s, step_s, torch.cat(fed, 1), logits, cache

    serve(model)                                     # untimed: warm-up
    torch.cuda.reset_peak_memory_stats()
    prefill_s, step_s, fed, _, cache = serve(model)
    med = _median(step_s)
    rec.update(prefill_ms=prefill_s * 1e3,
               decode_ms=[t * 1e3 for t in step_s], decode_ms_median=med * 1e3,
               decode_tokens_per_s=SERVE_BATCH / med,
               kv_cache_bytes=cache.nbytes(), cache_capacity=max_len,
               peak_bytes=torch.cuda.max_memory_allocated())
    # what the host dispatches for one decode step (after the timed run)
    short = model.prefill(batch, max_len=internal + 1)[1]
    rec["decode_step_ops"] = _count_ops(
        lambda: model.decode_step(short, fed[:, :1]))
    del cache, short
    log(f"{cfg.name} ({rec['params']:,} parameters, {rec['param_bytes']:,} "
        f"bytes, {cfg.dtype}, weights drawn in {rec['init_s']:.2f} s): "
        f"{SERVE_BATCH} requests of {cfg.frontend_tokens} patches + "
        f"{SERVE_PROMPT} tokens: prefill_ms={rec['prefill_ms']:.2f} "
        f"decode_ms_median={rec['decode_ms_median']:.3f} "
        f"decode_tokens_per_s={rec['decode_tokens_per_s']:.1f} "
        f"kv_cache_bytes={rec['kv_cache_bytes']:,} "
        f"peak_bytes={rec['peak_bytes']:,}; one decode step dispatches "
        f"{json.dumps(rec['decode_step_ops'])} aten ops")

    m32 = build_model(dataclasses.replace(cfg, dtype="float32"), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(seed))
    m32.load_state_dict(model.state_dict())
    _, _, fed, logits, _ = serve(m32, keep_logits=True)
    x, pos, pre = m32._embed_inputs({"tokens": torch.cat([toks, fed], 1),
                                     "frontend": front})
    h, _, _ = m32._decoder_stack(x, pos, prefix_len=pre)
    forced = m32._logits(h[:, internal : internal + SERVE_STEPS])
    decoded = torch.stack(logits, 1)
    err = float((decoded - forced).abs().max())
    scale = float(forced.abs().max())
    rec["f32_teacher_forcing"] = {
        "max_abs_err": err, "max_abs_logit": scale,
        "bound": SERVE_TF_RTOL * scale, "ok": err <= SERVE_TF_RTOL * scale}
    del m32, x, h, forced, decoded, logits
    torch.cuda.empty_cache()
    log(f"{cfg.name} f32 copy: {SERVE_STEPS} decode steps against one "
        f"teacher-forced forward: max abs err {err:.3g} of max |logit| "
        f"{scale:.3g} (bound {SERVE_TF_RTOL} x): "
        f"{rec['f32_teacher_forcing']['ok']}")
    return rec, model


def _greedy(torch, prefill, step, steps: int, gather=None, forced=None):
    """Greedy serving through ``prefill()`` and ``step(cache, tokens)``:
    (prefill seconds, each step's seconds, the greedy tokens (B, steps +
    1) — each logits row's argmax, the prefill's first —, the logits (B,
    V) of the prefill and of every step, the last cache).  ``gather``
    makes a sharded step's logits whole; ``forced`` (B, >= steps) feeds
    those tokens instead of the greedy ones (teacher forcing)."""
    gather = gather or (lambda x: x)
    sync = (torch.cuda.synchronize if torch.cuda.is_available()
            else (lambda: None))
    sync()
    t = time.perf_counter()
    lg, cache = prefill()
    lg = gather(lg)[:, -1]
    sync()
    prefill_s = time.perf_counter() - t
    logits, toks, step_s = [lg], [lg.argmax(-1, keepdim=True)], []
    for i in range(steps):
        feed = toks[-1] if forced is None else forced[:, i : i + 1]
        t = time.perf_counter()
        lg, cache = step(cache, feed)
        lg = gather(lg)[:, -1]
        toks.append(lg.argmax(-1, keepdim=True))
        sync()
        step_s.append(time.perf_counter() - t)
        logits.append(lg)
    return prefill_s, step_s, torch.cat(toks, 1), logits, cache


def _serve_inputs(torch, dev, cfg, seed: int) -> dict:
    """``serve_phase``'s SERVE_BATCH requests (a seeded generator on the
    card)."""
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    front = torch.randn((SERVE_BATCH, cfg.frontend_tokens, cfg.frontend_dim),
                        generator=g, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                         generator=g, device=dev)
    return {"tokens": toks, "frontend": front}


def _traffic_bytes(counter) -> int:
    return sum(v for k, v in counter.items() if k != "collectives")


def serve_sharded(torch, dev, model, unsharded: dict, seed: int, out_dir,
                  repo, log) -> dict:
    """``serve_phase``'s requests through the sharded serving steps
    (``train.loop.serve_params`` / ``make_prefill_step`` /
    ``make_serve_step``).  On a (1, 1) NCCL mesh in this process, on
    ``model``'s own weights: SERVE_STEPS greedy steps, whose tokens and
    logits must equal the unsharded run's bit for bit (every collective is
    over an axis of size 1); prefill ms and decode ms a step beside
    ``unsharded``'s.  Then a SERVE_MESH_SHAPE mesh of gloo rank processes
    on the one card (``serve_mesh_rank``): the same model from the same
    seed, each rank its rows of the batch, its q heads, its block of the
    cache's positions (1 kv head) and of the vocabulary; SERVE_MESH_STEPS
    decode steps teacher-forced on the one-rank greedy tokens.  Its
    greedy tokens against the one-rank ones: each must be the same, or a
    tie within the zoo's bf16 bar (``_zoo_tol``) in the one-rank logits.
    Its logits against an f32 copy of the model fed the same tokens: no
    further from them than the one-rank bf16 run's, plus that bar's atol
    (at full width bf16 itself is ~4x the bar from f32, PERF.md; the
    distance from the one-rank run's, and whether it is within the bar,
    are printed)."""
    import datetime
    import shutil

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.loop import (
        make_prefill_step, make_serve_step, serve_params)

    from repro_torch.models.model import build_model

    cfg = model.config
    batch = _serve_inputs(torch, dev, cfg, seed)
    max_len = cfg.frontend_tokens + SERVE_PROMPT + SERVE_STEPS
    one = _greedy(torch, lambda: model.prefill(batch, max_len=max_len),
                  model.decode_step, SERVE_STEPS)
    # an f32 copy fed the same tokens: how far bf16 itself is from f32
    m32 = build_model(dataclasses.replace(cfg, dtype="float32"), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(seed))
    m32.load_state_dict(model.state_dict())
    f32 = [x.cpu() for x in _greedy(
        torch, lambda: m32.prefill(batch, max_len=max_len), m32.decode_step,
        SERVE_MESH_STEPS, forced=one[2])[3]]
    del m32
    torch.cuda.empty_cache()
    rec = {"unsharded_prefill_ms": unsharded["prefill_ms"],
           "unsharded_decode_ms_median": unsharded["decode_ms_median"]}
    (out_dir / "store_serve").unlink(missing_ok=True)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        store=dist.FileStore(str(out_dir / "store_serve"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type=dev.type)
        params = serve_params(model, mesh)
        prefill = make_prefill_step(model, mesh, max_len=max_len)
        step = make_serve_step(model, mesh)

        def run():
            return _greedy(torch, lambda: prefill(params, batch),
                           lambda c, t: step(params, c, t), SERVE_STEPS)

        run()                                        # untimed: warm-up
        prefill_s, step_s, toks, logits, cache = run()
    finally:
        dist.destroy_process_group()
    rec["mesh_1x1"] = {
        "prefill_ms": prefill_s * 1e3,
        "decode_ms_median": _median(step_s) * 1e3,
        "tokens_equal": bool(torch.equal(toks, one[2])),
        "logits_bit_equal": all(torch.equal(a, b)
                                for a, b in zip(logits, one[3])),
        "cache_bit_equal": all(
            torch.equal(a, b) for a, b in zip(cache[:5], one[4][:5])
            if a is not None),
        "max_abs_err": max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(logits, one[3]))}
    r = rec["mesh_1x1"]
    log(f"{cfg.name} sharded serving on a (1, 1) NCCL mesh (serve_params, "
        f"make_prefill_step, make_serve_step; {SERVE_STEPS} greedy steps): "
        f"prefill_ms={r['prefill_ms']:.2f} (unsharded "
        f"{rec['unsharded_prefill_ms']:.2f}) decode_ms_median="
        f"{r['decode_ms_median']:.3f} (unsharded "
        f"{rec['unsharded_decode_ms_median']:.3f}); tokens equal "
        f"{r['tokens_equal']}, logits bit-equal {r['logits_bit_equal']}, "
        f"cache bit-equal {r['cache_bit_equal']}")
    del params, cache, logits

    work = out_dir / "serve_mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    torch.save({k: v.cpu() for k, v in batch.items()}, work / "batch.pt")
    torch.save(one[2].cpu(), work / "forced.pt")
    (work / "meta.json").write_text(json.dumps({
        "seed": seed, "max_len": max_len, "device": dev.type,
        "config": dataclasses.asdict(cfg)}))
    ranks = math.prod(SERVE_MESH_SHAPE)
    env = dict(os.environ, PYTHONPATH=str(repo / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.serve_mesh_rank(sys.argv[1:]))", str(rank),
         str(work)], cwd=repo, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(ranks)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=900)[0])
    finally:
        for proc in procs:
            proc.kill()
    (out_dir / "serve_mesh_ranks.log").write_text("\n".join(
        f"== rank {i} (exit {proc.returncode})\n{text}"
        for i, (proc, text) in enumerate(zip(procs, logs))))
    m = rec["mesh"] = {"shape": list(SERVE_MESH_SHAPE),
                       "exit_codes": [p.returncode for p in procs],
                       "s": time.perf_counter() - t0}
    if all(c == 0 for c in m["exit_codes"]):
        ranks_rec = [json.loads((work / f"rank{i}.json").read_text())
                     for i in range(ranks)]
        got = torch.load(work / "logits.pt")
        rtol, atol = _zoo_tol(cfg)
        want = [x.float().cpu() for x in one[3][:SERVE_MESH_STEPS + 1]]
        got = [x.float() for x in got]
        want_tok = one[2][:, :SERVE_MESH_STEPS + 1].cpu()
        mism, ties = 0, 0
        t = torch.tensor(ranks_rec[0]["tokens"])
        for i, j in zip(*torch.nonzero(t != want_tok, as_tuple=True)):
            mism += 1
            a = want[j][i, want_tok[i, j]]
            b = want[j][i, t[i, j]]
            ties += bool(abs(a - b) <= atol + rtol * abs(a))
        m.update(
            one_rank_bf16_vs_f32=max(float((a - b).abs().max())
                                     for a, b in zip(want, f32)),
            mesh_bf16_vs_f32=max(float((a - b).abs().max())
                                 for a, b in zip(got, f32)),
            ranks_agree=all(r_["tokens"] == ranks_rec[0]["tokens"]
                            for r_ in ranks_rec),
            within_zoo_bar=all(torch.allclose(a, b, rtol=rtol, atol=atol)
                               for a, b in zip(got, want)),
            max_abs_err=max(float((a - b).abs().max())
                            for a, b in zip(got, want)),
            rtol=rtol, atol=atol, token_mismatches=mism,
            mismatches_within_bar=ties,
            tokens_ok=mism == ties, tokens_compared=int(t.numel()),
            ranks=ranks_rec)
        m["logits_ok"] = (m["mesh_bf16_vs_f32"]
                          <= m["one_rank_bf16_vs_f32"] + atol)
        r0 = ranks_rec[0]
        log(f"{cfg.name} sharded serving on a {SERVE_MESH_SHAPE} gloo mesh "
            f"({ranks} processes, one card; {SERVE_MESH_STEPS} decode steps "
            f"on the one-rank tokens): logits max abs err from one rank's "
            f"{m['max_abs_err']:.3g} (within rtol {rtol} / atol {atol}: "
            f"{m['within_zoo_bar']}); from an f32 copy fed the same tokens: "
            f"mesh {m['mesh_bf16_vs_f32']:.3g}, one rank "
            f"{m['one_rank_bf16_vs_f32']:.3g} (the mesh within one rank's "
            f"+ {atol}: {m['logits_ok']}), greedy tokens that differ "
            f"{mism} of "
            f"{m['tokens_compared']} ({ties} ties within the bar), the "
            f"ranks' tokens agree {m['ranks_agree']}; rank 0: rows "
            f"{r0['rows']}, q heads "
            f"{r0['q_heads']}, vocab block {r0['vocab_block']}, cache "
            f"{json.dumps(r0['cache_local_shapes'])} = "
            f"{r0['cache_local_bytes']:,} bytes, prefill_ms "
            f"{r0['prefill_ms']:.1f}, decode_ms_median "
            f"{r0['decode_ms_median']:.1f}, collective bytes a step "
            f"{r0['collective_bytes_per_step']:,} "
            f"({json.dumps(r0['collective_bytes_by_kind_per_step'])}), "
            f"weights {r0['param_local_bytes']:,} bytes, peak "
            f"{r0['peak_bytes']:,}")
    log(f"sharded serving gloo mesh: exit codes {m['exit_codes']}, "
        f"{m['s']:.1f} s (rank logs in serve_mesh_ranks.log)")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


def serve_mesh_rank(argv) -> int:
    """One rank of ``serve_sharded``'s gloo mesh (``python -c "import
    chip_smoke; chip_smoke.serve_mesh_rank([rank, dir])"`` from the repo
    root): the config and seed in ``dir``/meta.json on its device, its
    shards placed by ``serve_params`` and the whole weights freed, the
    requests in ``dir``/batch.pt prefilled and SERVE_MESH_STEPS decode
    steps fed the tokens in ``dir``/forced.pt; its greedy tokens, its
    cache's local bytes, ms a step and collective bytes a step into
    ``dir``/rank<r>.json, the gathered logits (rank 0) into
    ``dir``/logits.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    rank, work = int(argv[0]), Path(argv[1])
    meta = json.loads((work / "meta.json").read_text())
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(work / "store"),
                                     math.prod(SERVE_MESH_SHAPE)),
        rank=rank, world_size=math.prod(SERVE_MESH_SHAPE),
        timeout=datetime.timedelta(seconds=600))
    try:
        from repro_torch.configs import ModelConfig
        from repro_torch.distributed import sharding as shard_lib
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.model import build_model
        from repro_torch.train.loop import (
            make_prefill_step, make_serve_step, serve_params)

        dev = torch.device(meta["device"])
        cuda = dev.type == "cuda"
        cfg = ModelConfig(**meta["config"])
        mesh = make_mesh(SERVE_MESH_SHAPE, ("data", "model"),
                         device_type=dev.type)
        model = build_model(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(meta["seed"]))
        params = serve_params(model, mesh)
        model.to("meta")
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        batch = {k: v.to(dev) for k, v in torch.load(
            work / "batch.pt").items()}
        forced = torch.load(work / "forced.pt").to(dev)
        prefill = make_prefill_step(model, mesh, max_len=meta["max_len"])
        step = make_serve_step(model, mesh)
        traffic = []

        def stepped(cache, tok):
            before = dict(shard_lib.TRAFFIC)
            out = step(params, cache, tok)
            traffic.append({k: v - before.get(k, 0)
                            for k, v in shard_lib.TRAFFIC.items()})
            return out

        prefill_s, step_s, toks, logits, cache = _greedy(
            torch, lambda: prefill(params, batch), stepped,
            SERVE_MESH_STEPS, lambda x: shard_lib.full_tensor(x, mesh),
            forced)
        per_step = {k: _median([t.get(k, 0) for t in traffic])
                    for k in traffic[0] if k != "collectives"}
        rec = {
            "tokens": toks.cpu().tolist(),
            "rows": SERVE_BATCH // SERVE_MESH_SHAPE[0],
            "q_heads": cfg.num_heads // SERVE_MESH_SHAPE[1],
            "vocab_block": int(params["unembed"].shape[-1]),
            "cache_local_shapes": {
                f: list(getattr(cache, f).shape) for f in ("kv_k", "kv_v")},
            "cache_local_bytes": cache.nbytes(),
            "param_local_bytes": sum(t.numel() * t.element_size()
                                     for t in params.values()),
            "prefill_ms": prefill_s * 1e3,
            "decode_ms": [t * 1e3 for t in step_s],
            "decode_ms_median": _median(step_s) * 1e3,
            "collective_bytes_per_step": _traffic_bytes(per_step),
            "collective_bytes_by_kind_per_step": per_step,
            "collectives_per_step": _median([t.get("collectives", 0)
                                             for t in traffic]),
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
        if rank == 0:
            torch.save([x.cpu() for x in logits], work / "logits.pt")
        (work / f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()
    return 0


def retrieval_phase(torch, dev, model, seed: int, log) -> tuple:
    """``examples/image_retrieval.py`` at scale: RETR_CLASSES x
    RETR_PER_CLASS synthetic images (class centres of (patches, width)
    N(0, 1), noise RETR_NOISE) embedded RETR_EMBED_BATCH at a time by
    ``model`` and pooled over the patch prefix, indexed by
    ``EmbeddingRetriever(metric="angular")`` on the card, and RETR_QUERIES
    fresh images searched RETR_SEARCH_BATCH at a time.  Frees ``model``'s
    weights once the images are embedded.  Returns (record, the arguments
    of the RETR_CAPTURE_CALL-th call of each kernel in one more batch)."""
    import numpy as np

    from repro_torch.core.dataset import exact_knn, recall_at_k
    from repro_torch.kernels import loader, ops
    from repro_torch.serve.retrieval import EmbeddingRetriever

    cfg = model.config
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    centres = torch.randn((RETR_CLASSES, cfg.frontend_tokens,
                           cfg.frontend_dim), generator=g, device=dev)
    labels = torch.arange(RETR_CLASSES, device=dev).repeat_interleave(
        RETR_PER_CLASS)
    q_labels = torch.randint(0, RETR_CLASSES, (RETR_QUERIES,), generator=g,
                             device=dev)

    def embed(lab):
        out = []
        for s in range(0, lab.shape[0], RETR_EMBED_BATCH):
            part = lab[s : s + RETR_EMBED_BATCH]
            front = centres[part] + RETR_NOISE * torch.randn(
                (part.shape[0], cfg.frontend_tokens, cfg.frontend_dim),
                generator=g, device=dev)
            x, pos, pre = model._embed_inputs({
                "tokens": torch.zeros((part.shape[0], RETR_PROMPT),
                                      dtype=torch.long, device=dev),
                "frontend": front})
            h, _, _ = model._decoder_stack(x, pos, prefix_len=pre)
            out.append(h[:, :pre, :].mean(dim=1).float())   # pooled image
        return torch.cat(out)

    embed(labels[:RETR_EMBED_BATCH])                 # untimed: warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embs = embed(labels)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    q_embs = embed(q_labels)
    base, queries = embs.cpu().numpy(), q_embs.cpu().numpy()
    labels, q_labels = labels.cpu().numpy(), q_labels.cpu().numpy()
    model.to("meta")      # frees the weights while callers hold the module
    del embs, q_embs, centres
    torch.cuda.empty_cache()
    rec = {"images": int(base.shape[0]), "dim": int(base.shape[1]),
           "embed_s": embed_s, "images_per_s": base.shape[0] / embed_s,
           "finite": bool(np.isfinite(base).all()
                          and np.isfinite(queries).all())}
    log(f"embedded {rec['images']} images ({RETR_EMBED_BATCH} a batch, "
        f"{cfg.frontend_tokens} patches + {RETR_PROMPT} tokens, {cfg.dtype}) "
        f"in {embed_s:.2f} s: {rec['images_per_s']:.1f} images/s")

    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    retr = EmbeddingRetriever(base, metric="angular", device=dev,
                              stage_times=stages)
    torch.cuda.synchronize()
    stages["total"] = time.perf_counter() - t0
    gt = exact_knn(queries, base, 10, "angular", device=dev)
    idx = retr.index
    rec.update(build_s=stages, pq_subvectors=idx.config.pq.num_subvectors,
               pq_centroids=idx.config.pq.num_centroids,
               max_degree=idx.config.graph.max_degree,
               hot_count=idx.hot_count)
    retr.query(queries[:RETR_SEARCH_BATCH])          # untimed: warm-up
    loader.reset_launch_counts()
    t0 = time.perf_counter()
    ids = np.concatenate([
        retr.query(queries[s : s + RETR_SEARCH_BATCH], k=10)[0]
        for s in range(0, RETR_QUERIES, RETR_SEARCH_BATCH)])
    wall = time.perf_counter() - t0
    rec.update(launches=dict(loader.LAUNCHES), search_s=wall,
               qps=RETR_QUERIES / wall,
               recall_at_10=recall_at_k(ids, gt, 10),
               purity_at_5=float((labels[np.clip(ids[:, :5], 0, None)]
                                  == q_labels[:, None]).mean()))
    log(f"EmbeddingRetriever over {rec['images']} x {rec['dim']} (angular, "
        f"PQ {rec['pq_subvectors']} x {rec['pq_centroids']}, R="
        f"{rec['max_degree']}, {rec['hot_count']} hot): build seconds "
        f"{json.dumps(stages)}; {RETR_QUERIES} queries: QPS={rec['qps']:.1f}"
        f" recall@10={rec['recall_at_10']:.4f} (exact angular kNN over the "
        f"embeddings) label purity@5={rec['purity_at_5']:.4f} (random "
        f"{1 / RETR_CLASSES:.4f}); launches {json.dumps(rec['launches'])}")

    # one more batch, its kernels' arguments kept for the kernel phase: of
    # each kernel the first call from the RETR_CAPTURE_CALL-th on whose mask
    # asks for a row (else the last such call)
    captured, calls, at = {}, {}, {}
    real = {n: getattr(ops, n) for n in RETR_KERNELS}
    mask_arg = {"pq_lookup_gather": 3, "l2_rerank_masked": 4}

    def spy(name):
        def call(*args):
            calls[name] = calls.get(name, 0) + 1
            mask = args[mask_arg[name]] if name in mask_arg else None
            if at.get(name, 0) <= RETR_CAPTURE_CALL \
                    and (mask is None or bool(mask.any())):
                captured[name], at[name] = args, calls[name]
            return real[name](*args)
        return call

    for n in RETR_KERNELS:
        setattr(ops, n, spy(n))
    try:
        retr.query(queries[:RETR_SEARCH_BATCH])
    finally:
        for n in RETR_KERNELS:
            setattr(ops, n, real[n])
    rec["kernel_shapes"] = {n: [list(a.shape) for a in args
                                if hasattr(a, "shape")]
                            for n, args in captured.items()}
    del retr
    return rec, captured


def model_phase(torch, dev, serve_cfg, seed: int, out_dir, repo,
                log) -> tuple:
    """The model zoo on the card (``zoo_phase``), PaliGemma served at
    ``serve_cfg``'s width (``serve_phase``), sharded (``serve_sharded``),
    and its image embeddings retrieved through the four kernels
    (``retrieval_phase``).  Frees every model before it returns (record,
    the retriever's kernel arguments)."""
    rec = {"zoo": zoo_phase(torch, dev, seed, log)}
    rec["serve"], model = serve_phase(torch, dev, serve_cfg, seed, log)
    rec["sharded"] = serve_sharded(torch, dev, model, rec["serve"], seed,
                                   out_dir, repo, log)
    rec["retrieval"], captured = retrieval_phase(torch, dev, model, seed, log)
    del model
    torch.cuda.empty_cache()
    return rec, captured


def model_failures(rec: dict) -> list:
    fails = [f"model zoo {k}: card vs CPU max abs err {v['max_abs_err']:.3g}"
             f" beyond rtol {v['rtol']} / atol {v['atol']}"
             for k, v in rec["zoo"].items() if not v["ok"]]
    sh = rec["sharded"]
    r = sh["mesh_1x1"]
    if not (r["tokens_equal"] and r["logits_bit_equal"]
            and r["cache_bit_equal"]):
        fails.append(f"sharded serving on (1, 1) differs from unsharded: "
                     f"{json.dumps(r)}")
    m = sh["mesh"]
    if any(c != 0 for c in m["exit_codes"]):
        fails.append(f"sharded serving gloo mesh: exit codes "
                     f"{m['exit_codes']}")
    elif not (m["logits_ok"] and m["tokens_ok"] and m["ranks_agree"]):
        fails.append(f"sharded serving gloo mesh: logits max abs err "
                     f"{m['max_abs_err']:.3g}, from the f32 copy's "
                     f"{m['mesh_bf16_vs_f32']:.3g} against one rank's "
                     f"{m['one_rank_bf16_vs_f32']:.3g} (ok "
                     f"{m['logits_ok']}), "
                     f"{m['token_mismatches']} greedy tokens differ, "
                     f"{m['mismatches_within_bar']} of them ties; ranks "
                     f"agree {m['ranks_agree']}")
    tf = rec["serve"]["f32_teacher_forcing"]
    if not tf["ok"]:
        fails.append(f"{rec['serve']['config']} f32 decode vs teacher "
                     f"forcing: {tf['max_abs_err']:.3g} > {tf['bound']:.3g}")
    r = rec["retrieval"]
    if not r["finite"]:
        fails.append("image embeddings are not finite")
    if r["recall_at_10"] < 0.5:
        fails.append(f"retrieval recall@10 {r['recall_at_10']:.4f} < 0.5")
    if min(r["launches"].values()) <= 0:
        fails.append(f"retrieval: a kernel never launched: {r['launches']}")
    if set(r["kernel_shapes"]) != set(RETR_KERNELS):
        fails.append(f"retrieval: kernel calls not captured: "
                     f"{sorted(r['kernel_shapes'])}")
    return fails


# the SSM phase: each model's own requests through prefill_chunked (one
# segment of the whole prompt), then greedy decode steps; zamba2's f32 copy
# held to teacher forcing
SSM_SERVE = (("zamba2-1.2b", 8, 32, True), ("falcon-mamba-7b", 2, 8, False))
SSM_PROMPT = 2048
SSM_SEG = 2048
SSM_CHUNK = 256                  # Model's ssm_chunk: the plain version's
SSM_RAGGED = 300                 # a scan length no multiple of the chunk
SCAN_TOL = 1e-5                  # kernel vs plain, of max|y| (max|h_last|)
# exp results a second: 16 a clock an SM on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput), 132 SMs, 1.98 GHz
SFU_PER_S = 16 * 132 * 1.98e9
TF32_FLOP_PER_S = 495e12         # H100 SXM dense TF32, tensor cores
# the scan's kernels by route: (forward, backward) counters
SCAN_KERNELS = {"step": ("selective_scan", "selective_scan_bwd"),
                "ssd": ("selective_scan_ssd", "selective_scan_ssd_bwd")}


def ssm_serve(torch, dev, arch: str, requests: int, steps: int, tf: bool,
              seed: int, log) -> dict:
    """``arch`` at its published width and depth in bf16, weights from a
    seeded generator on the card: ``requests`` prompts of SSM_PROMPT tokens
    through ``prefill_chunked`` and ``steps`` greedy decode steps, timed
    after an untimed round; the scan's launches counted from zero over the
    timed round.  With ``tf`` an f32 copy's decode logits against one
    teacher-forced forward over prompt + generated tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import loader
    from repro_torch.models.model import build_model

    cfg = get_config(arch)
    rec = {"config": cfg.name, "dtype": cfg.dtype, "requests": requests,
           "prompt": SSM_PROMPT, "seg_len": SSM_SEG, "steps": steps}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    rec["params"] = sum(p.numel() for p in model.parameters())
    rec["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in model.parameters())
    toks = torch.randint(0, cfg.vocab_size, (requests, SSM_PROMPT),
                         generator=torch.Generator(device=dev).manual_seed(
                             seed + 1), device=dev)
    n_ssm = sum(k in ("mamba1", "mamba2") for k in cfg.block_pattern())
    # the prefill's route: Mamba-2's (SSD where ssd_route takes its head and
    # state widths), Mamba-1 the step kernel
    from repro_torch.kernels.selective_scan import ssd_route
    from repro_torch.models.ssm import MAMBA2_HEAD_DIM
    mamba2 = "mamba2" in cfg.block_pattern()
    prefill_kernel = SCAN_KERNELS[
        "ssd" if mamba2 and ssd_route(SSM_SEG, MAMBA2_HEAD_DIM,
                                      cfg.ssm_state)
        else "step"][0]

    def scan_counts():
        return {k: loader.MODEL_LAUNCHES[k] for k in
                (SCAN_KERNELS["step"][0], SCAN_KERNELS["ssd"][0])}

    def serve(m):
        """``_greedy`` over ``m``, and the scan's launch counts at the end
        of the prefill."""
        at_prefill = []

        def prefill():
            out = m.prefill_chunked({"tokens": toks}, seg_len=SSM_SEG,
                                    max_len=SSM_PROMPT + steps + 1)
            at_prefill.append(scan_counts())
            return out

        return (*_greedy(torch, prefill, m.decode_step, steps), at_prefill[0])

    serve(model)                                     # untimed: warm-up
    torch.cuda.reset_peak_memory_stats()
    loader.reset_launch_counts()
    prefill_s, step_s, _, logits, cache, n_prefill = serve(model)
    n_all = scan_counts()
    med = _median(step_s)
    finite = all(bool(torch.isfinite(lg).all()) for lg in logits)
    rec.update(
        prefill_ms=prefill_s * 1e3,
        prefill_tokens_per_s=requests * SSM_PROMPT / prefill_s,
        decode_ms=[t * 1e3 for t in step_s], decode_ms_median=med * 1e3,
        decode_tokens_per_s=requests / med, cache_bytes=cache.nbytes(),
        peak_bytes=torch.cuda.max_memory_allocated(), finite=finite,
        ssm_layers=n_ssm,
        launches={"prefill": {k: v for k, v in n_prefill.items() if v},
                  "decode": {k: n_all[k] - v for k, v in n_prefill.items()
                             if n_all[k] - v},
                  "want_prefill": {prefill_kernel:
                                   n_ssm * SSM_PROMPT // SSM_SEG},
                  "want_decode": {SCAN_KERNELS["step"][0]: n_ssm * steps}})
    del cache, logits
    log(f"{cfg.name} ({rec['params']:,} parameters, {rec['param_bytes']:,} "
        f"bytes, {cfg.dtype}, weights drawn in {rec['init_s']:.2f} s): "
        f"{requests} requests of {SSM_PROMPT} tokens through "
        f"prefill_chunked (seg {SSM_SEG}) + {steps} greedy steps: "
        f"prefill_ms={rec['prefill_ms']:.2f} "
        f"prefill_tokens_per_s={rec['prefill_tokens_per_s']:.1f} "
        f"decode_ms_median={rec['decode_ms_median']:.3f} "
        f"decode_tokens_per_s={rec['decode_tokens_per_s']:.1f} "
        f"cache_bytes={rec['cache_bytes']:,} "
        f"peak_bytes={rec['peak_bytes']:,}; the scan's launches by kernel "
        f"{json.dumps(rec['launches'])}; finite {finite}")
    if tf:
        torch.backends.cuda.matmul.allow_tf32 = False
        m32 = build_model(dataclasses.replace(cfg, dtype="float32"),
                          device=dev, generator=torch.Generator(
                              device=dev).manual_seed(seed))
        m32.load_state_dict(model.state_dict())
        del model
        torch.cuda.empty_cache()
        _, _, fed, logits, _, _ = serve(m32)
        with torch.no_grad():      # the tokens each decode step was fed
            seq = torch.cat([toks, fed[:, :steps]], 1)
            h, _, _ = m32._decoder_stack(m32._embed_tokens(seq),
                                         m32._positions(requests,
                                                        seq.shape[1]))
            forced = m32._logits(h[:, SSM_PROMPT:SSM_PROMPT + steps])
        decoded = torch.stack(logits[1:], 1)
        err = float((decoded - forced).abs().max())
        scale = float(forced.abs().max())
        rec["f32_teacher_forcing"] = {
            "max_abs_err": err, "max_abs_logit": scale,
            "bound": SERVE_TF_RTOL * scale,
            "ok": err <= SERVE_TF_RTOL * scale}
        del m32, h, forced, decoded, logits
        log(f"{cfg.name} f32 copy: {steps} decode steps against one "
            f"teacher-forced forward: max abs err {err:.3g} of max |logit| "
            f"{scale:.3g} (bound {SERVE_TF_RTOL} x): "
            f"{rec['f32_teacher_forcing']['ok']}")
    else:
        del model
    torch.cuda.empty_cache()
    return rec


def _scan_inputs(torch, dev, g, bsz: int, s: int, di: int, ds: int,
                 nh=None, carried: bool = False) -> list:
    """(dt, a, x, b, c, h0) on the card, drawn as the blocks make them:
    Mamba-1 (falcon-mamba) dt = softplus(N(0, 0.5^2) + its dt_bias draw,
    softplus^-1 of U(1e-3, 0.1)) and a = -(1..ds) a channel; Mamba-2
    (zamba2, ``nh`` heads) dt = softplus(N(0, 1)) a head and a =
    -exp(N(0, 0.5^2)); x, b, c and a carried h0 N(0, 1)."""
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    if nh is None:
        lo, hi = 1e-3, 0.1
        u = torch.rand((di,), generator=g, device=dev) * (hi - lo) + lo
        dt = F.softplus(0.5 * randn(bsz, s, di) + torch.log(torch.expm1(u)))
        a = -torch.arange(1, ds + 1, dtype=torch.float32,
                          device=dev).repeat(di, 1)
    else:
        dt = F.softplus(randn(bsz, s, nh))
        a = -torch.exp(0.5 * randn(nh))
    x, b, c = randn(bsz, s, di), randn(bsz, s, ds), randn(bsz, s, ds)
    h0 = (randn(bsz, di, ds) if carried
          else torch.zeros((bsz, di, ds), device=dev))
    return [dt, a, x, b, c, h0]


def _ssd_flops(bsz: int, s: int, nh: int, hd: int, ds: int, bwd: bool,
               kernel: bool = False) -> float:
    """The flops of the scan's SSD form on these shapes, each product once:
    per 64-step chunk and batch row, G = C B^T once for all the heads and,
    a head, the forward's (G o E) U over the causal half and two state
    products, the backward's two state passes, three state products and
    four causal ones.  With ``kernel``, the work of
    ``csrc/selective_scan_ssd.cu`` instead: its backward forms G once per 8
    heads, and every product runs as three TF32 passes."""
    from repro_torch.kernels.selective_scan import SSD_CHUNK as q

    nc = -(-s // q)
    state, causal, g = q * hd * ds, q * (q + 1) // 2, q * q * ds
    if bwd:
        grams = -(-nh // 8) if kernel else 1
        macs = bsz * nc * (nh * (5 * state + 2 * causal * (hd + ds))
                           + grams * g)
    else:
        macs = bsz * nc * (g + nh * (causal * hd + 2 * state))
    return 2 * (3 if kernel else 1) * macs


def _scan_route(args: list, bwd: bool = False) -> str:
    """The kernel route a call on ``args`` (a backward's with ``bwd``)
    takes: "ssd" for the Mamba-2 shapes ``ssd_route`` takes, else
    "step"."""
    from repro_torch.kernels.selective_scan import ssd_route

    a, x, b = args[1], args[2], args[3]
    bsz, s, di = x.shape
    return ("ssd" if a.dim() == 1 and ssd_route(
        s, di // a.shape[0], b.shape[-1], bwd=bwd) else "step")


def _scan_case(torch, dev, seed: int, k: int, case: tuple,
               bwd: bool) -> list:
    """Case ``k``'s inputs (dt, a, x, b, c, h0; a backward case's with the
    cotangents gy and gh_last, N(0, 1)), from a generator of its own: the
    same draws on every call."""
    _, bsz, s, shape, carried = case[:5]
    g = torch.Generator(device=dev).manual_seed(seed * 1000 + k)
    args = _scan_inputs(torch, dev, g, bsz, s, carried=carried, **shape)
    if bwd:
        args += [torch.randn(args[2].shape, generator=g, device=dev),
                 torch.randn(args[5].shape, generator=g, device=dev)]
    return args


# the backward's kernels, by route (the SSD call's three launches; the step
# route's Mamba-1 calls take the tiled kernel, "tiles")
SCAN_BWD_SYMBOLS = {
    "step": ("selective_scan_bwd_kernel", "selective_scan_bwd_reduce"),
    "tiles": ("scan_bwd_tiles", "selective_scan_bwd_reduce"),
    "ssd": ("ssd_state_walks", "ssd_chunk_grads", "ssd_grads_reduce")}


def scan_time(torch, args: list, bwd: bool, flush) -> dict:
    """Events and CUPTI ms of the scan's kernel (its backward with ``bwd``;
    ``args`` then ends with the cotangents) on ``args``, 30 calls as
    ``_time_ms`` times them: CUPTI over the route's launches."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as ss

    heads = args[1].dim() == 1
    route = _scan_route(args, bwd)
    if bwd:
        op = ss.scan_heads_bwd_op if heads else ss.scan_bwd_op
        ms, cupti = _time_ms(torch, lambda: op(*args, SSM_CHUNK), flush,
                             SCAN_BWD_SYMBOLS["tiles" if not heads
                                              else route])
    else:
        op = ops.selective_scan_heads if heads else ops.selective_scan
        ms, cupti = _time_ms(
            torch, lambda: op(*args, SSM_CHUNK), flush,
            ("ssd_gram", "ssd_chunk_scan") if route == "ssd"
            else "scan_lanes")
    return {"ms": ms, "cupti_ms": cupti}


def _scan_bounds(args: list, route: str, bwd: bool) -> dict:
    """The bound of the scan (its backward) on ``args``: the largest of the
    bytes (each input, output, cotangent and gradient once) at
    HBM_BYTES_PER_S, the exps (B S di ds, Mamba-2's B S nh) at SFU_PER_S
    and, on the SSD route, the SSD form's flops (``_ssd_flops``, each
    product once) at TF32_FLOP_PER_S; beside it ``mma_ms``, the SSD
    kernels' own three-pass products at that rate (the design's floor, not
    the function's)."""
    dt, a, x, b = args[:4]
    heads = a.dim() == 1
    bsz, s, di = x.shape
    ds = b.shape[-1]
    nh = a.shape[0] if heads else None
    ins = args[:6]
    if bwd:
        nbytes = 4 * (2 * sum(t.numel() for t in ins)
                      + sum(t.numel() for t in args[6:]))
    else:
        nbytes = 4 * (sum(t.numel() for t in ins) + bsz * s * di
                      + bsz * di * ds)
    exps = bsz * s * (nh if heads else di * ds)
    ssd = route == "ssd"
    flops = _ssd_flops(bsz, s, nh, di // nh, ds, bwd) if ssd else 0
    mma = (_ssd_flops(bsz, s, nh, di // nh, ds, bwd, kernel=True) if ssd
           else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_exps = exps / SFU_PER_S * 1e3
    t_ops = flops / TF32_FLOP_PER_S * 1e3
    bound = max(t_bytes, t_exps, t_ops)
    return {"bytes": nbytes, "exps": exps, "flops": flops,
            "kernel_flops": mma, "bytes_ms": t_bytes, "exps_ms": t_exps,
            "ops_ms": t_ops, "mma_ms": mma / TF32_FLOP_PER_S * 1e3,
            "bound_ms": bound,
            "bound_by": "bytes" if bound == t_bytes else "operations"}


def _tiles_floor(args: list) -> dict:
    """The floor of Mamba-1's tiled backward (``csrc/selective_scan_bwd.cu``
    ``scan_bwd_tiles_kernel``) on ``args``, its own work rather than the
    function's: the bytes it moves (pass 1 reads dt, x and B, the reverse
    dt, x, gy, B and C, each chunk's stored state written and read, dx and
    ddt written, the dB / dC partials and da's written and summed) at
    HBM_BYTES_PER_S, and its exps (passes 1 and 2 and the rerun of pass 3
    over the padded states) at SFU_PER_S: the larger of the two."""
    x, b = args[2], args[3]
    bsz, s, di = x.shape
    ds = b.shape[-1]
    kds = max(4, 1 << (ds - 1).bit_length())
    chunk = min(32, 2 * kds)
    sub, nc = chunk // 8, -(-s // chunk)
    nblk = -(-di // (1024 // kds))
    seq, rows = bsz * s * di, bsz * s * ds
    nbytes = 4 * (2 * seq + rows + 3 * seq + 2 * rows       # the reads
                  + 2 * bsz * nc * nblk * 256 * 4         # stored states
                  + 2 * seq                               # dx, ddt
                  + 2 * 2 * bsz * nblk * s * ds           # dB / dC partials
                  + 2 * bsz * di * ds)                    # da's
    exps = bsz * s * di * kds * ((nc - 1) / nc + (sub - 1) / sub + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_exps = exps / SFU_PER_S * 1e3
    return {"design_bytes": nbytes, "design_exps": exps,
            "design_ms": max(t_bytes, t_exps),
            "design_by": "bytes" if t_bytes >= t_exps else "exps"}


def scan_entry(torch, label: str, args: list, flush, timing: dict,
               want_route: str) -> dict:
    """The scan kernel against the plain loop on ``args`` (Mamba-2's entry
    when ``a`` is per head; the SSD kernel where ``ssd_route`` takes the
    shape, else the step kernel): max errors of y and h_last against
    SCAN_TOL of their largest magnitudes; ``timing`` (``scan_time``'s),
    the plain version's ms (3 calls: the SSD kernel's chunked plain
    version, beside the loop's) and the bound (``_scan_bounds``)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as ss

    heads = args[1].dim() == 1
    bsz, s, di = args[2].shape
    ds = args[3].shape[-1]
    nh = args[1].shape[0] if heads else None
    route = _scan_route(args)
    kernel = ops.selective_scan_heads if heads else ops.selective_scan
    loop = (ss.selective_scan_heads_plain if heads
            else ss.selective_scan_plain)
    got = kernel(*args, SSM_CHUNK)
    want = loop(*args, SSM_CHUNK)
    torch.cuda.synchronize()
    errs = [float((g_ - w).abs().max()) for g_, w in zip(got, want)]
    scales = [float(w.abs().max()) for w in want]
    ok = (all(bool(torch.isfinite(g_).all()) for g_ in got)
          and all(e <= SCAN_TOL * sc for e, sc in zip(errs, scales)))
    rec = {}
    if route == "ssd":
        blue = ss.selective_scan_ssd_plain(*args)
        rec["ssd_plain_err_of_scale"] = max(
            float((p - w).abs().max()) / sc
            for p, w, sc in zip(blue, want, scales))
        del blue
    del got, want
    loop_ms = _time_ms(torch, lambda: loop(*args, SSM_CHUNK), flush,
                       reps=3, warmup=1)
    plain_ms = loop_ms if route == "step" else _time_ms(
        torch, lambda: ss.selective_scan_ssd_plain(*args), flush, reps=3,
        warmup=1)
    rec.update({
        "entry": label, "route": route, "want_route": want_route,
        "kernel": SCAN_KERNELS[route][0],
        "shape": {"B": bsz, "S": s, "di": di, "ds": ds, "nh": nh},
        "max_abs_err": max(errs), "y_err": errs[0], "h_err": errs[1],
        "y_scale": scales[0], "h_scale": scales[1], "tol": SCAN_TOL,
        "ok": ok, **timing, "plain_ms": plain_ms, "loop_ms": loop_ms,
        **_scan_bounds(args, route, False), "library_ms": None})
    return rec


def scan_bwd_entry(torch, label: str, args: list, flush, want_route: str,
                   timing: dict = None) -> dict:
    """The backward kernel (SSD or step, as ``scan_entry``) against the
    plain loop's backward on ``args`` (the inputs and the cotangents of y
    and h_last): each gradient's max error against SCAN_TOL of its largest
    magnitude, and whether a second run gives the same bits; with
    ``timing`` (``scan_time``'s), the plain backward's ms (one call: the
    SSD's chunked plain version, beside the loop's) and the bound
    (``_scan_bounds``)."""
    from repro_torch.kernels import selective_scan as ss

    heads = args[1].dim() == 1
    bsz, s, di = args[2].shape
    ds = args[3].shape[-1]
    nh = args[1].shape[0] if heads else None
    route = _scan_route(args, bwd=True)
    kernel = ss.scan_heads_bwd_op if heads else ss.scan_bwd_op
    loop = (ss.selective_scan_heads_bwd_plain if heads
            else ss.selective_scan_bwd_plain)
    ins = [*args, SSM_CHUNK]
    got = kernel(*ins)
    again = kernel(*ins)
    want = loop(*ins)
    torch.cuda.synchronize()
    names = ("dt", "a", "x", "b", "c", "h0")
    errs = {n: float((p - q).abs().max()) for n, p, q in zip(names, got, want)}
    scales = {n: float(q.abs().max()) for n, q in zip(names, want)}
    ok = (all(bool(torch.isfinite(p).all()) for p in got)
          and all(errs[n] <= SCAN_TOL * scales[n] for n in names))
    bit_equal = all(torch.equal(p, q) for p, q in zip(got, again))
    del got, again, want
    rec = {"entry": label, "route": route, "want_route": want_route,
           "kernel": SCAN_KERNELS[route][1],
           "shape": {"B": bsz, "S": s, "di": di, "ds": ds, "nh": nh},
           "errs": errs, "scales": scales, "tol": SCAN_TOL, "ok": ok,
           "bit_equal": bit_equal, "max_abs_err": max(errs.values()),
           "max_err_of_scale": max(errs[n] / max(scales[n], 1e-30)
                                   for n in names)}
    if timing is None:
        return rec
    # one call: seconds at the train microbatch, warm from the check above
    loop_ms = _time_ms(torch, lambda: loop(*ins), flush, reps=1, warmup=0)
    plain_ms = loop_ms if route == "step" else _time_ms(
        torch, lambda: ss.selective_scan_ssd_bwd_plain(*args), flush,
        reps=1, warmup=1)
    rec.update(**timing, plain_ms=plain_ms, loop_ms=loop_ms,
               **_scan_bounds(args, route, True), library_ms=None)
    if not heads:
        rec.update(_tiles_floor(args))
    return rec


def ssm_phase(torch, dev, seed: int, log) -> dict:
    """zamba2-1.2B and falcon-mamba-7b served at full width and depth
    (``ssm_serve``, the scan's launches counted over each timed round)."""
    return {"serve": {arch: ssm_serve(torch, dev, arch, n, steps, tf, seed,
                                      log)
                      for arch, n, steps, tf in SSM_SERVE}}


def scan_phase(torch, dev, seed: int, serve: dict, log) -> dict:
    """The scan's kernels against the plain loop at the SSM models' layer
    shapes (``scan_entry``): zamba2's (8, 2048, 4096, 64, 64 heads) from a
    zero and a carried state and its train microbatch's (2, 4096),
    falcon-mamba's (8, 2048, 8192, 16) and its served (2, 2048, ...), each
    model's decode step (S = 1, its requests) and a ragged S = SSM_RAGGED.
    Then the backward kernels against the plain backward
    (``scan_bwd_entry``) at both models' layer widths: the train
    microbatch's (2, 4096) for zamba2 (the plain loop's autograd holds ~17
    GB there) and falcon-mamba's (2, 2048), each from a zero and a carried
    state, S = 1 and S = SSM_RAGGED; the two zero-state cases timed.
    Each case names the route it must take (zamba2's calls with S > 1 the
    SSD kernels, the others the step kernels).  Every timed kernel runs first (``scan_time``), before any
    plain loop: the loops launch ~10^4-10^5 kernels a call, and the
    profiler has dropped records of the sessions that follow such work
    (PERF.md); the whole phase runs after every other profiled
    measurement for the same reason.  Returns {"entries", "bwd_entries",
    "scan_kernels": the kernels line's four records, their launches set by
    main()}."""
    flush = _Flush(torch, dev)
    z = dict(di=4096, ds=64, nh=64)
    f = dict(di=8192, ds=16)
    # (label, B, S, widths, carried state, the route it must take[, timed])
    cases = (("zamba2 (8, 2048), zero state (the prefill's)", 8, 2048, z,
              False, "ssd"),
             ("zamba2 (8, 2048), carried state", 8, 2048, z, True, "ssd"),
             ("zamba2 (2, 4096), zero state (the train microbatch's)", 2,
              4096, z, False, "ssd"),
             ("zamba2 decode (8, 1)", 8, 1, z, True, "step"),
             (f"zamba2 ragged (8, {SSM_RAGGED})", 8, SSM_RAGGED, z, True,
              "ssd"),
             ("falcon-mamba (8, 2048), zero state", 8, 2048, f, False,
              "step"),
             ("falcon-mamba (2, 2048), zero state (the prefill's)", 2, 2048,
              f, False, "step"),
             ("falcon-mamba decode (2, 1)", 2, 1, f, True, "step"),
             (f"falcon-mamba ragged (8, {SSM_RAGGED})", 8, SSM_RAGGED, f,
              True, "step"))
    bwd_cases = (
        ("zamba2 (2, 4096), zero state (the train microbatch's)", 2, 4096,
         z, False, "ssd", True),
        ("zamba2 (2, 4096), carried state", 2, 4096, z, True, "ssd", False),
        ("zamba2 (2, 1)", 2, 1, z, True, "step", False),
        (f"zamba2 ragged (2, {SSM_RAGGED})", 2, SSM_RAGGED, z, True, "ssd",
         False),
        ("falcon-mamba (2, 2048), zero state", 2, 2048, f, False, "step",
         True),
        ("falcon-mamba (2, 2048), carried state", 2, 2048, f, True, "step",
         False),
        ("falcon-mamba (2, 1)", 2, 1, f, True, "step", False),
        (f"falcon-mamba ragged (2, {SSM_RAGGED})", 2, SSM_RAGGED, f, True,
         "step", False))
    n_fwd = len(cases)
    fwd_time, bwd_time = [], {}
    for k, case in enumerate(cases):                 # the kernels, timed
        args = _scan_case(torch, dev, seed, k, case, False)
        fwd_time.append(scan_time(torch, args, False, flush))
        del args
    for k, case in enumerate(bwd_cases):
        if case[6]:
            args = _scan_case(torch, dev, seed, n_fwd + k, case, True)
            bwd_time[k] = scan_time(torch, args, True, flush)
            del args
    torch.cuda.empty_cache()
    entries = []
    for k, case in enumerate(cases):                 # against the plain
        label = case[0]
        args = _scan_case(torch, dev, seed, k, case, False)
        entries.append(scan_entry(torch, label, args, flush, fwd_time[k],
                                  case[5]))
        del args
        torch.cuda.empty_cache()
        e = entries[-1]
        log(f"kernel {e['kernel']} [{label}] ({e['route']}): y err "
            f"{e['y_err']:.3g} of {e['y_scale']:.3g}, h err "
            f"{e['h_err']:.3g} of {e['h_scale']:.3g} (tol {SCAN_TOL} x) "
            f"ok={e['ok']} ms={e['ms']:.4f} cupti_ms={e['cupti_ms']:.4f} "
            f"plain_ms={e['plain_ms']:.2f} loop_ms={e['loop_ms']:.2f} "
            f"bound_ms={e['bound_ms']:.5f} ({e['bound_by']}: bytes "
            f"{e['bytes_ms']:.5f}, exps {e['exps_ms']:.5f}, tf32 "
            f"{e['ops_ms']:.5f}; three-pass mma {e['mma_ms']:.5f}) "
            f"library_ms=None" + (
                f"; the chunked plain version's err "
                f"{e['ssd_plain_err_of_scale']:.3g} of max"
                if "ssd_plain_err_of_scale" in e else ""))
    bwd = []
    for k, case in enumerate(bwd_cases):
        label = case[0]
        args = _scan_case(torch, dev, seed, n_fwd + k, case, True)
        bwd.append(scan_bwd_entry(torch, label, args, flush, case[5],
                                  bwd_time.get(k)))
        del args
        torch.cuda.empty_cache()
        e = bwd[-1]
        log(f"kernel {e['kernel']} [{label}] ({e['route']}): worst gradient "
            f"err {e['max_err_of_scale']:.3g} of its max |g| (tol "
            f"{SCAN_TOL}; "
            f"{json.dumps({k_: round(v, 9) for k_, v in e['errs'].items()})}"
            f") ok={e['ok']} bit-equal reruns {e['bit_equal']}" + (
                f" ms={e['ms']:.4f} cupti_ms={e['cupti_ms']:.4f} "
                f"plain_ms={e['plain_ms']:.2f} loop_ms={e['loop_ms']:.2f} "
                f"bound_ms={e['bound_ms']:.5f} ({e['bound_by']}: bytes "
                f"{e['bytes_ms']:.5f}, exps {e['exps_ms']:.5f}, tf32 "
                f"{e['ops_ms']:.5f}; three-pass mma {e['mma_ms']:.5f}) "
                f"library_ms=None" if "ms" in e else "") + (
                f"; the tiled design's floor {e['design_ms']:.5f} "
                f"({e['design_by']}: {e['design_bytes'] / 1e6:.1f} MB, "
                f"{e['design_exps'] / 1e6:.1f} M exps)"
                if "design_ms" in e else ""))

    def record(name, source, what, main, group):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": "src/repro/models/ssm.py:70",
                "replaces_what": what, "launches": None,
                **{k: main[k] for k in ("max_abs_err", "ms", "cupti_ms",
                                        "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
                "main_entry": main["entry"],
                "entries": [e for e in group if e["kernel"] == name]}

    by_label = {e["entry"]: e for e in entries + bwd}
    csrc = "src/repro_torch/kernels/csrc/"
    fwd_what = ("selective_scan, which the reference computes outside "
                "Pallas (no TPU kernel)")
    bwd_what = "the JAX gradient of selective_scan (no TPU kernel)"
    rec = {"entries": entries, "bwd_entries": bwd, "scan_kernels": [
        record("selective_scan", csrc + "selective_scan.cu",
               fwd_what + "; Mamba-1, and Mamba-2's decode",
               by_label["falcon-mamba (2, 2048), zero state (the "
                        "prefill's)"], entries),
        record("selective_scan_bwd", csrc + "selective_scan_bwd.cu",
               bwd_what + "; Mamba-1",
               by_label["falcon-mamba (2, 2048), zero state"], bwd),
        record("selective_scan_ssd", csrc + "selective_scan_ssd.cu",
               fwd_what + "; Mamba-2 in its chunked matrix form",
               by_label["zamba2 (8, 2048), zero state (the prefill's)"],
               entries),
        record("selective_scan_ssd_bwd", csrc + "selective_scan_ssd.cu",
               bwd_what + "; Mamba-2 in its chunked matrix form",
               by_label["zamba2 (2, 4096), zero state (the train "
                        "microbatch's)"], bwd)]}
    for k in rec["scan_kernels"]:
        k["max_err_of_scale"] = max(_err_of_scale(e) for e in k["entries"])
    return rec


def _err_of_scale(e: dict) -> float:
    """A scan entry's worst error over its output's (gradient's) largest
    magnitude."""
    if "max_err_of_scale" in e:
        return e["max_err_of_scale"]
    return max(e["y_err"] / max(e["y_scale"], 1e-30),
               e["h_err"] / max(e["h_scale"], 1e-30))


def ssm_failures(rec: dict) -> list:
    fails = []
    for arch, r in rec["serve"].items():
        n = r["launches"]
        if not r["finite"]:
            fails.append(f"{arch}: non-finite logits")
        if (n["prefill"], n["decode"]) != (n["want_prefill"],
                                           n["want_decode"]):
            fails.append(f"{arch}: the scan launched {n}, not once a mamba "
                         "layer a segment and a decode step on the asked "
                         "kernel")
        tf = r.get("f32_teacher_forcing")
        if tf is not None and not tf["ok"]:
            fails.append(f"{arch} f32 decode vs teacher forcing: "
                         f"{tf['max_abs_err']:.3g} > {tf['bound']:.3g}")
    for e in rec.get("entries", ()) + rec.get("bwd_entries", ()):
        if e["route"] != e["want_route"]:
            fails.append(f"scan [{e['entry']}]: ran the {e['route']} "
                         f"kernel, not the {e['want_route']} one")
    for e in rec.get("entries", ()):
        if not e["ok"]:
            fails.append(f"selective_scan [{e['entry']}]: kernel vs plain y "
                         f"{e['y_err']:.3g} of {e['y_scale']:.3g}, h "
                         f"{e['h_err']:.3g} of {e['h_scale']:.3g} beyond "
                         f"{SCAN_TOL} x (or not finite)")
    for e in rec.get("bwd_entries", ()):
        if not e.get("bit_equal", True):
            fails.append(f"selective_scan_bwd [{e['entry']}]: two runs "
                         "differ")
        if not e["ok"]:
            fails.append(f"selective_scan_bwd [{e['entry']}]: kernel vs "
                         f"plain {json.dumps(e['errs'])} of "
                         f"{json.dumps(e['scales'])} beyond {SCAN_TOL} x "
                         "(or not finite)")
    return fails


TRAIN_ARCH = "stablelm-1.6b"
TRAIN_STEPS = 20                 # AdamW warmup max(20 // 20, 5) = 5
TRAIN_SEQ = 4097                 # train_4k's 4,096 tokens, + 1 for the labels
TRAIN_BATCH = 4                  # train_4k's global batch of 256, cut for time
TRAIN_MICROBATCHES = 2
TRAIN_LOSS_DROP = 0.3            # tests/test_train_ckpt_fault.py's margin
BF16_PEAK_FLOPS = 989e12         # H100 SXM dense bf16 (NVIDIA data sheet)
TRAIN_SSM_ARCH = "zamba2-1.2b"   # trained as TRAIN_ARCH, its own steps
TRAIN_SSM_STEPS = 12
FAULT_PARAMS_M = 100             # custom_dense_config(100): d 704, 11 layers
FAULT_STEPS = 15
FAULT_EVERY = 5
FAULT_AT = 7                     # the step whose forward meets a NaN
FAULT_REPLAY_FROM = 10
FAULT_REPLAY_RTOL = 1e-3


def _tree_close(got: dict, want: dict, tol: float) -> tuple:
    """(every leaf within ``tol`` of its largest |want|, the worst such
    ratio) over two dicts of tensors with the same keys."""
    worst = 0.0
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-30)
        worst = max(worst, float((got[k].cpu() - w).abs().max()) / scale)
    return worst <= tol, worst


def train_zoo(torch, dev, seed: int, log) -> dict:
    """Each architecture's smoke config in f32 (TF32 off): one set of
    weights and one batch, one ``make_train_step`` step with 2 microbatches
    on the card and on the CPU; the losses and the gradients the optimizer
    is handed, and the scan's launches in the card's step (falcon-mamba's
    smoke config the step kernels', zamba2's the SSD kernels')."""
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.kernels import loader
    from repro_torch.models.model import build_model
    from repro_torch.train.data import DataConfig, batch_for_step
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamW

    class Spy(AdamW):
        def apply(self, grads, state, params):
            self.seen.update(grads)
            return super().apply(grads, state, params)

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        kw = dict(q_chunk=64, ssm_chunk=8)
        cpu = build_model(cfg, device="cpu", generator=torch.Generator(
            ).manual_seed(seed), **kw)
        card = build_model(cfg, device=dev, **kw)
        card.load_state_dict(cpu.state_dict())
        batch = batch_for_step(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=17, global_batch=4,
            copy_period=4, family=cfg.family,
            frontend_tokens=cfg.frontend_tokens,
            frontend_dim=cfg.frontend_dim, seed=seed), 0)
        got = {}
        for side, model in (("card", card), ("cpu", cpu)):
            opt = Spy(lr=1e-3, warmup_steps=5, total_steps=20)
            object.__setattr__(opt, "seen", {})
            state, _ = init_train_state(model, opt)
            ts, _ = make_train_step(model, opt, microbatches=2)
            loader.reset_launch_counts()
            _, m = ts(state, batch)
            got[side] = (float(m["loss"]), opt.seen,
                         {k: v for k, v in loader.MODEL_LAUNCHES.items()
                          if v})
        tol = 1e-3 if cfg.family in ("ssm", "hybrid") else 1e-4
        ok, worst = _tree_close(got["card"][1], got["cpu"][1], tol)
        lerr = abs(got["card"][0] - got["cpu"][0]) / abs(got["cpu"][0])
        out[arch] = {"loss_rel_err": lerr, "grad_err_of_max": worst,
                     "grad_tol": tol, "ok": ok and lerr <= 1e-5,
                     "scan_launches": got["card"][2]}
        del cpu, card
    errs = {k: [v["loss_rel_err"], v["grad_err_of_max"]]
            for k, v in out.items()}
    log(f"train step, card vs CPU (f32, TF32 off, 2 microbatches): loss "
        f"rel err / worst gradient err of its leaf's max |g| "
        f"{json.dumps(errs)}; all within: "
        f"{all(v['ok'] for v in out.values())}")
    return out


def train_full(torch, dev, log) -> dict:
    """StableLM-1.6B at full width through ``launch.train.train``: the
    launcher's model, optimizer, data and step, TRAIN_STEPS steps timed
    from one step's metrics (host floats, so the card has finished) to the
    next's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher

    cfg = get_config(TRAIN_ARCH)
    marks, steps = [], []

    def on_metrics(step, m):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        steps.append(dict(m, step=step))
        log(f"  {cfg.name} step {step:2d} loss {m['loss']:.4f} "
            f"grad_norm {m['grad_norm']:.4f} lr {m['lr']:.3e}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, state, _ = launcher.train(
        cfg, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ,
        microbatches=TRAIN_MICROBATCHES, lr=1e-3, device=dev,
        on_metrics=on_metrics)
    peak = torch.cuda.max_memory_allocated()
    n = sum(p.numel() for p in state.params.values())
    tokens = TRAIN_BATCH * (TRAIN_SEQ - 1)
    s = TRAIN_SEQ - 1
    attn = 12 * cfg.num_layers * s * s * cfg.d_model * TRAIN_BATCH
    flops = 6 * n * tokens + attn
    step_s = [b - a for a, b in zip(marks, marks[1:])]     # steps 2-20
    med = _median(step_s[1:])                              # steps 3-20
    losses = [x["loss"] for x in steps]
    rec = {"config": cfg.name, "params": n,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in state.params.values()),
           "steps": steps, "step_ms": [t * 1e3 for t in step_s],
           "first_step_s": marks[0] - t0, "step_ms_median": med * 1e3,
           "tokens_per_step": tokens, "tokens_per_s": tokens / med,
           "model_flops_per_step": flops, "attention_flops_per_step": attn,
           "model_tflops_per_s": flops / med / 1e12,
           "mfu_of_989": flops / med / BF16_PEAK_FLOPS,
           "peak_bytes": peak, "losses": losses,
           "finite": all(math.isfinite(x) for x in losses),
           "last5_mean": sum(losses[-5:]) / 5}
    rec["drop"] = losses[0] - rec["last5_mean"]
    del model, state
    torch.cuda.empty_cache()
    log(f"{cfg.name} trained ({n:,} parameters, {rec['param_bytes']:,} "
        f"bytes bf16; {TRAIN_BATCH} x {TRAIN_SEQ - 1} tokens a step, "
        f"{TRAIN_MICROBATCHES} microbatches, remat per block): "
        f"step_ms_median={rec['step_ms_median']:.1f} (steps 3-20) "
        f"tokens_per_s={rec['tokens_per_s']:.0f} "
        f"model_TFLOP_per_step={flops / 1e12:.2f} "
        f"(attention {attn / 1e12:.2f}) "
        f"model_TFLOP_per_s={rec['model_tflops_per_s']:.1f} "
        f"mfu_of_989={rec['mfu_of_989']:.4f} peak_bytes={peak:,} "
        f"first_step_s={rec['first_step_s']:.1f}; loss {losses[0]:.4f} -> "
        f"mean of the last 5 {rec['last5_mean']:.4f} "
        f"(drop {rec['drop']:.4f}, >= {TRAIN_LOSS_DROP} asked)")
    return rec


class _PlainOnCard:
    """A dispatch mode that counts the ops dispatched on the card from
    inside the selective scan's plain versions (forward or backward: the
    call stack holds their code), and the ops of the scan's custom ops by
    name.  Entered over one train step (``train_ssm``)."""

    def __init__(self, torch):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        from repro_torch.kernels import selective_scan as ss

        codes = {f.__code__ for f in (ss.selective_scan_plain,
                                      ss.selective_scan_heads_plain,
                                      ss._rerun)}
        self.plain_on_card, self.scan_ops = 0, {}
        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = str(func)
                if name.startswith("repro_torch."):
                    outer.scan_ops[name] = outer.scan_ops.get(name, 0) + 1
                if any(isinstance(t, torch.Tensor) and t.is_cuda
                       for t in tree_leaves((args, kwargs))):
                    f = sys._getframe()
                    while f is not None and f.f_code not in codes:
                        f = f.f_back
                    outer.plain_on_card += f is not None
                return func(*args, **(kwargs or {}))

        self.mode = Mode()


def train_ssm(torch, dev, log) -> dict:
    """TRAIN_SSM_ARCH at published width and depth through
    ``launch.train.train`` on ``train_full``'s shape (TRAIN_BATCH x
    TRAIN_SEQ - 1 tokens, TRAIN_MICROBATCHES, remat per block),
    TRAIN_SSM_STEPS steps timed as ``train_full``'s; the scan's launches
    counted from zero over the run, and over step 2 by kernel, with the ops
    dispatched from the plain versions on the card (``_PlainOnCard``: step
    2 is outside the median)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import loader
    from repro_torch.launch import train as launcher

    cfg = get_config(TRAIN_SSM_ARCH)
    n_ssm = sum(k in ("mamba1", "mamba2") for k in cfg.block_pattern())
    marks, steps, probe = [], [], {}

    def on_metrics(step, m):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        steps.append(dict(m, step=step))
        if step == 1:
            probe["before"] = dict(loader.MODEL_LAUNCHES)
            probe["watch"] = _PlainOnCard(torch)
            probe["watch"].mode.__enter__()
        elif step == 2:
            probe["watch"].mode.__exit__(None, None, None)
            probe["step2"] = {k: v - probe["before"][k]
                              for k, v in loader.MODEL_LAUNCHES.items()}
        log(f"  {cfg.name} step {step:2d} loss {m['loss']:.4f} "
            f"grad_norm {m['grad_norm']:.4f} lr {m['lr']:.3e}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loader.reset_launch_counts()
    t0 = time.perf_counter()
    model, state, _ = launcher.train(
        cfg, TRAIN_SSM_STEPS, TRAIN_BATCH, TRAIN_SEQ,
        microbatches=TRAIN_MICROBATCHES, lr=1e-3, device=dev,
        on_metrics=on_metrics)
    launches = dict(loader.MODEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n = sum(p.numel() for p in state.params.values())
    tokens = TRAIN_BATCH * (TRAIN_SEQ - 1)
    step_s = [b - a for a, b in zip(marks, marks[1:])]     # steps 2-12
    med = _median(step_s[1:])                              # steps 3-12
    losses = [x["loss"] for x in steps]
    watch = probe["watch"]
    rec = {"config": cfg.name, "params": n,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in state.params.values()),
           "steps": steps, "step_ms": [t * 1e3 for t in step_s],
           "first_step_s": marks[0] - t0, "step_ms_median": med * 1e3,
           "tokens_per_step": tokens, "tokens_per_s": tokens / med,
           "peak_bytes": peak, "losses": losses,
           "finite": all(math.isfinite(x) for x in losses),
           "last3_mean": sum(losses[-3:]) / 3, "ssm_layers": n_ssm,
           "launches": launches, "launches_step2": probe["step2"],
           "want_bwd_a_step": n_ssm * TRAIN_MICROBATCHES,
           "fwd_a_step": probe["step2"]["selective_scan_ssd"],
           "scan_ops_step2": watch.scan_ops,
           "plain_ops_on_card_step2": watch.plain_on_card}
    rec["drop"] = losses[0] - rec["last3_mean"]
    del model, state
    torch.cuda.empty_cache()
    log(f"{cfg.name} trained ({n:,} parameters, {rec['param_bytes']:,} "
        f"bytes bf16; {TRAIN_BATCH} x {TRAIN_SEQ - 1} tokens a step, "
        f"{TRAIN_MICROBATCHES} microbatches, remat per block; "
        f"{_card_line()}): step_ms_median={rec['step_ms_median']:.1f} "
        f"(steps 3-{TRAIN_SSM_STEPS}) tokens_per_s="
        f"{rec['tokens_per_s']:.0f} peak_bytes={peak:,} "
        f"first_step_s={rec['first_step_s']:.1f}; losses "
        f"{[round(x, 4) for x in losses]}: {losses[0]:.4f} -> mean of the "
        f"last 3 {rec['last3_mean']:.4f} (drop {rec['drop']:.4f}, >= "
        f"{TRAIN_LOSS_DROP} asked); launches over the run "
        f"{json.dumps(launches)}, over step 2 {json.dumps(probe['step2'])} "
        f"(SSD backward: {rec['want_bwd_a_step']} asked, one a mamba layer "
        f"a microbatch; SSD forward {rec['fwd_a_step']} a step, the "
        f"recompute of remat per block included; no step kernel), scan ops "
        f"over step 2 {json.dumps(watch.scan_ops)}, "
        f"ops from the plain versions on the card {watch.plain_on_card}")
    return rec


def train_fault(torch, dev, repo, out_dir, log) -> dict:
    """``FaultTolerantLoop`` over ``custom_dense_config(FAULT_PARAMS_M)``
    with a NaN in ``ln_f`` before step FAULT_AT's forward, checkpoints every
    FAULT_EVERY steps; the last checkpoint restored against the live state,
    steps replayed from an earlier one, and an ``elastic_restore`` onto a
    one-card mesh."""
    import datetime
    import shutil

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.distributed import sharding as shard_lib
    from repro_torch.distributed.fault import (
        FaultConfig, FaultTolerantLoop, elastic_restore)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import custom_dense_config
    from repro_torch.models.model import build_model
    from repro_torch.train.data import (
        DataConfig, batch_for_step, device_put_batch)
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamW

    cfg = custom_dense_config(FAULT_PARAMS_M)
    ckpt_dir = repo / "chiprun_out" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    model = build_model(cfg, device=dev, q_chunk=128)
    opt = AdamW(lr=1e-3, warmup_steps=5, total_steps=FAULT_STEPS)
    state, specs = init_train_state(model, opt)
    ts, _ = make_train_step(model, opt)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=129, global_batch=8,
                      copy_period=16)
    injected, losses = [], {}

    def step_fn(st, step):
        if step == FAULT_AT and not injected:
            injected.append(step)
            with torch.no_grad():
                st.params["ln_f"][0] = float("nan")
        st, m = ts(st, device_put_batch(batch_for_step(dcfg, step), dev))
        return st, {k: float(v) for k, v in m.items()}

    def on_metrics(step, m):
        losses[step - 1] = m["loss"]

    rec = {"config": cfg.name, "params": cfg.param_count()}
    try:
        t0 = time.perf_counter()
        loop = FaultTolerantLoop(step_fn, state, FaultConfig(
            ckpt_dir=str(ckpt_dir), ckpt_every=FAULT_EVERY))
        loop.run(FAULT_STEPS, on_metrics=on_metrics)
        torch.cuda.synchronize()
        rec.update(run_s=time.perf_counter() - t0, restarts=loop.restarts,
                   final_step=loop.step, losses=losses,
                   ckpt_bytes=sum(f.stat().st_size for f in
                                  (ckpt_dir / f"step_{loop.step:08d}")
                                  .iterdir()))
        t0 = time.perf_counter()
        restored, step, _ = ck.restore_checkpoint(str(ckpt_dir), loop.state,
                                                  validate_digests=True)
        rec["restore_s"] = time.perf_counter() - t0
        live = [*loop.state.params.items(), *loop.state.opt.mu.items(),
                *loop.state.opt.nu.items()]
        back = [*restored.params.values(), *restored.opt.mu.values(),
                *restored.opt.nu.values()]
        rec["restore_step"] = step
        rec["restore_bit_equal"] = bool(
            all(torch.equal(a, b) for (_, a), b in zip(live, back))
            and torch.equal(loop.state.opt.step, restored.opt.step))
        # replay from an earlier checkpoint
        st, _, _ = ck.restore_checkpoint(str(ckpt_dir), loop.state,
                                         step=FAULT_REPLAY_FROM)
        replay = {}
        for k in range(FAULT_REPLAY_FROM, FAULT_STEPS):
            st, m = step_fn(st, k)
            replay[k] = m["loss"]
        del st
        rec["replay_losses"] = replay
        rec["replay_max_rel_err"] = max(abs(replay[k] - losses[k])
                                        / abs(losses[k]) for k in replay)
        # elastic restore onto a one-card mesh
        (out_dir / "store_train").unlink(missing_ok=True)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.FileStore(str(out_dir / "store_train"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            mesh = make_mesh((1, 1), ("data", "model"),
                             device_type=dev.type)
            ck.save_checkpoint(str(ckpt_dir / "params"), loop.step,
                               loop.state.params)
            el, el_step, _ = elastic_restore(str(ckpt_dir / "params"),
                                             loop.state.params, mesh, specs)
            sh = shard_lib.param_shardings(specs, loop.state.params, mesh)
            rec["elastic"] = {
                "step": el_step,
                "all_dtensor": all(isinstance(t, DTensor)
                                   for t in el.values()),
                "placements_follow_specs": all(
                    tuple(el[k].placements) == sh[k].placements()
                    for k in sh),
                "full_equal": all(
                    torch.equal(el[k].full_tensor(), v)
                    for k, v in loop.state.params.items())}
            del el
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del model, state, loop, restored
    torch.cuda.empty_cache()
    log(f"fault-tolerant loop ({cfg.name}, {rec['params']:,} parameters, "
        f"checkpoints of {rec['ckpt_bytes']:,} bytes every {FAULT_EVERY} "
        f"steps, async; NaN before step {FAULT_AT}): {FAULT_STEPS} steps in "
        f"{rec['run_s']:.1f} s, final step {rec['final_step']}, restarts "
        f"{rec['restarts']}; restore of step {rec['restore_step']} in "
        f"{rec['restore_s']:.2f} s bit-equal to the live state: "
        f"{rec['restore_bit_equal']}; {len(rec['replay_losses'])} steps "
        f"replayed from step {FAULT_REPLAY_FROM}: max loss rel err "
        f"{rec['replay_max_rel_err']:.3g} (bound {FAULT_REPLAY_RTOL}); "
        f"elastic restore onto a 1x1 mesh: {json.dumps(rec['elastic'])}")
    return rec


SHARDED_STEPS = 3                # the sharded step's, against train_full's
SHARDED_RTOL = 1e-3              # its losses against train_full's, relative
# launch.dryrun's --mesh: (16, 16) and (2, 16, 16), a process each
DRYRUN_MESHES = ("single", "multi")
DRYRUN_PEAK_TOL = 0.25           # the traced (1, 1) cell's peak vs the card's
# the serving cells the dry-run traces on the (16, 16) mesh
DRYRUN_SERVE_CELLS = ((TRAIN_ARCH, "prefill_32k"), (TRAIN_ARCH, "decode_32k"),
                      (SERVE_ARCH, "decode_32k"))
# the SSM models' train_4k cells on (16, 16) at full depth, a process each
DRYRUN_SSM_ARCHS = ("zamba2-1.2b", "falcon-mamba-7b")


def start_dryrun(repo, out_dir) -> list:
    """Starts the dry-run as processes of its own (fake process groups,
    fake tensors, no card) that run beside the card-bound train phase:
    ``launch.dryrun`` over TRAIN_ARCH's train_4k cell, one process for each
    production mesh of DRYRUN_MESHES, and over each DRYRUN_SSM_ARCHS
    model's on (16, 16); ``dryrun_anchor`` (the train phase's own cell on a
    (1, 1) mesh) and ``dryrun_serve``.  Returns [(name, process, its output
    file)]."""
    env = dict(os.environ, PYTHONPATH=str(repo / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    cmds = {
        mesh: [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", TRAIN_ARCH, "--shape", "train_4k", "--mesh", mesh,
               "--force", "--out", str(out_dir / f"dryrun_torch_{mesh}.json")]
        for mesh in DRYRUN_MESHES}
    cmds.update({
        f"ssm_{arch}": [sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", arch, "--shape", "train_4k", "--mesh",
                        "single", "--force", "--out",
                        str(out_dir / f"dryrun_ssm_{arch}.json")]
        for arch in DRYRUN_SSM_ARCHS})
    cmds.update({
        "anchor": [sys.executable, "-c",
                   "import sys, chip_smoke; chip_smoke.dryrun_anchor("
                   "sys.argv[1])", str(out_dir / "dryrun_anchor.json")],
        "serve": [sys.executable, "-c",
                  "import sys, chip_smoke; chip_smoke.dryrun_serve("
                  "sys.argv[1])", str(out_dir / "dryrun_serve.json")]})
    import atexit

    procs = []
    atexit.register(lambda: [p.kill() for _, p, _ in procs
                             if p.poll() is None])
    for name, cmd in cmds.items():
        f = open(out_dir / f"dryrun_{name}.log", "w")
        procs.append((name, subprocess.Popen(
            cmd, cwd=str(repo), env=env, stdout=f, stderr=subprocess.STDOUT),
            f))
    return procs


def dryrun_anchor(out: str) -> None:
    """Traces the train phase's own cell (TRAIN_ARCH, TRAIN_BATCH x
    TRAIN_SEQ - 1 tokens, TRAIN_MICROBATCHES, the launcher's q_chunk) on a
    (1, 1) mesh with ``launch.dryrun.lower_cell``; writes the record to
    ``out``.  Run in a process of its own (``start_dryrun``)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import fake_mesh, lower_cell

    shape = ShapeConfig("train_phase", TRAIN_SEQ - 1, TRAIN_BATCH, "train")
    with fake_mesh((1, 1), ("data", "model")) as mesh:
        rec = lower_cell(TRAIN_ARCH, shape, mesh,
                         model_kw={"q_chunk": max(TRAIN_SEQ - 1, 64)},
                         microbatches=TRAIN_MICROBATCHES)
    Path(out).write_text(json.dumps(rec, indent=1))


def dryrun_serve(out: str) -> None:
    """Traces DRYRUN_SERVE_CELLS on the (16, 16) production mesh with
    ``launch.dryrun.lower_cell`` (a cell that raises is recorded with
    ``status: "error"``); writes the records to ``out``.  Run in a process
    of its own (``start_dryrun``)."""
    import traceback

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import (
        PRODUCTION_MESHES, fake_mesh, lower_cell)

    recs = {}
    shape, axes = PRODUCTION_MESHES[False]
    with fake_mesh(shape, axes) as mesh:
        for arch, cell in DRYRUN_SERVE_CELLS:
            key = f"{arch}|{cell}|16x16"
            try:
                recs[key] = lower_cell(arch, SHAPES[cell], mesh)
            except Exception as e:
                recs[key] = {"status": "error",
                             "error": f"{type(e).__name__}: {e}",
                             "trace": traceback.format_exc()[-2000:]}
            Path(out).write_text(json.dumps(recs, indent=1))


def finish_dryrun(procs, out_dir, sharded, full, log) -> dict:
    """Waits for ``start_dryrun``'s processes and reads their records: the
    production cells' (status, per-device FLOPs, collective bytes, peak,
    bottleneck), and the anchor's traced peak against the sharded step's
    measured peak and its per-device dot FLOPs beside the step's model
    FLOPs and measured ms."""
    rcs = {}
    for name, p, f in procs:
        try:
            rcs[name] = p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            rcs[name] = "timeout"
        f.close()
    rec = {"returncodes": rcs, "cells": {}}
    cells = {}
    for mesh in DRYRUN_MESHES:
        path = out_dir / f"dryrun_torch_{mesh}.json"
        if path.exists():
            cells.update(json.loads(path.read_text()))
    if cells:
        for key, cell in cells.items():
            c = {"status": cell["status"]}
            if cell["status"] == "ok":
                rl = cell["roofline"]
                c.update(trace_s=cell["trace_s"],
                         microbatches=cell["microbatches"],
                         flops_per_device=rl["flops"],
                         coll_bytes_per_device=rl["coll_bytes"],
                         coll_breakdown=rl["coll_breakdown"],
                         peak_bytes=cell["memory"]["peak_memory_in_bytes"],
                         temp_bytes=cell["memory"]["temp_size_in_bytes"],
                         bottleneck=rl["bottleneck"],
                         compute_s=rl["compute_s"],
                         collective_s=rl["collective_s"],
                         memory_s=rl["memory_s"],
                         useful_ratio=rl["useful_ratio"])
            rec["cells"][key] = c
            log(f"dry-run {key}: {json.dumps(c)}")
    rec["ssm_cells"] = {}
    for arch in DRYRUN_SSM_ARCHS:
        path = out_dir / f"dryrun_ssm_{arch}.json"
        for key, cell in (json.loads(path.read_text()).items()
                          if path.exists() else ()):
            c = {"status": cell["status"]}
            if cell["status"] == "ok":
                rl = cell["roofline"]
                c.update(trace_s=cell["trace_s"],
                         microbatches=cell["microbatches"],
                         flops_per_device=rl["flops"],
                         coll_bytes_per_device=rl["coll_bytes"],
                         coll_breakdown=rl["coll_breakdown"],
                         peak_bytes=cell["memory"]["peak_memory_in_bytes"],
                         temp_bytes=cell["memory"]["temp_size_in_bytes"],
                         bottleneck=rl["bottleneck"],
                         compute_s=rl["compute_s"],
                         collective_s=rl["collective_s"],
                         memory_s=rl["memory_s"],
                         useful_ratio=rl["useful_ratio"])
            else:
                c["error"] = cell.get("error")
            rec["ssm_cells"][key] = c
            log(f"dry-run SSM train cell {key}: {json.dumps(c)}")
    rec["serve_cells"] = {}
    path = out_dir / "dryrun_serve.json"
    for key, cell in (json.loads(path.read_text()).items()
                      if path.exists() else ()):
        c = {"status": cell["status"]}
        if cell["status"] == "ok":
            rl = cell["roofline"]
            c.update(trace_s=cell["trace_s"], bottleneck=rl["bottleneck"],
                     coll_breakdown=rl["coll_breakdown"],
                     flops_per_device=rl["flops"],
                     peak_bytes=cell["memory"]["peak_memory_in_bytes"],
                     temp_bytes=cell["memory"]["temp_size_in_bytes"],
                     kv_bytes_local=cell["kv_bytes_local"],
                     cache_bytes_local=cell["cache_bytes_local"],
                     compute_s=rl["compute_s"], memory_s=rl["memory_s"],
                     collective_s=rl["collective_s"],
                     useful_ratio=rl["useful_ratio"])
        else:
            c["error"] = cell.get("error")
        rec["serve_cells"][key] = c
        log(f"dry-run serving cell {key}: {json.dumps(c)}")
    path = out_dir / "dryrun_anchor.json"
    if path.exists():
        a = json.loads(path.read_text())
        peak = a["memory"]["peak_memory_in_bytes"]
        rec["anchor"] = {
            "traced_peak_bytes": peak,
            "measured_peak_bytes": sharded["peak_bytes"],
            "peak_rel_err": abs(peak - sharded["peak_bytes"])
            / sharded["peak_bytes"],
            "traced_dot_flops": a["roofline"]["flops"],
            "model_flops_per_step": full["model_flops_per_step"],
            "step_ms_median": sharded["step_ms_median"],
            "trace_s": a["trace_s"],
            "coll_bytes": a["roofline"]["coll_bytes"]}
        log(f"dry-run of the train phase's cell on a (1, 1) mesh: "
            f"{json.dumps(rec['anchor'])}")
    return rec


def train_sharded(torch, dev, out_dir, full, log) -> dict:
    """StableLM-1.6B as ``train_full`` (its model, optimizer and data), its
    state held by ``shard_state`` and SHARDED_STEPS steps through
    ``make_train_step(..., mesh, param_shardings=...)`` on a (1, 1) NCCL
    mesh (NCCL takes one rank a card); its losses against ``train_full``'s
    first steps."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.train.data import (
        DataConfig, batch_for_step, device_put_batch)
    from repro_torch.train.loop import (
        init_train_state, make_train_step, shard_state, state_shardings)
    from repro_torch.train.optimizer import AdamW

    cfg = get_config(TRAIN_ARCH)
    (out_dir / "store_sharded").unlink(missing_ok=True)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(out_dir / "store_sharded"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type=dev.type)
        torch.cuda.empty_cache()
        model = build_model(cfg, device=dev, q_chunk=max(TRAIN_SEQ - 1, 64))
        opt = AdamW(lr=1e-3, warmup_steps=max(TRAIN_STEPS // 20, 5),
                    total_steps=TRAIN_STEPS)
        state, specs = init_train_state(model, opt)
        sh = state_shardings(specs, state, mesh)
        state = shard_state(state, specs, mesh)
        ts, _ = make_train_step(model, opt, mesh, TRAIN_MICROBATCHES,
                                param_shardings=sh.params)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, copy_period=16,
                          family=cfg.family)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks, losses = [time.perf_counter()], []
        for step in range(SHARDED_STEPS):
            state, m = ts(state, device_put_batch(batch_for_step(dcfg, step),
                                                  dev))
            losses.append(float(m["loss"]))
            marks.append(time.perf_counter())
        peak = torch.cuda.max_memory_allocated()
        del model, state
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    want = full["losses"][:SHARDED_STEPS]
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    rec = {"losses": losses, "unsharded_losses": want,
           "max_rel_err": max(abs(a - b) / abs(b)
                              for a, b in zip(losses, want)),
           "bit_equal": losses == want, "step_ms": step_ms,
           "step_ms_median": _median(step_ms[1:]), "peak_bytes": peak}
    log(f"{cfg.name} sharded step on a (1, 1) NCCL mesh (shard_state, "
        f"param_shardings; {TRAIN_BATCH} x {TRAIN_SEQ - 1} tokens, "
        f"{TRAIN_MICROBATCHES} microbatches, bf16): losses {losses} vs the "
        f"unsharded run's {want}: max rel err {rec['max_rel_err']:.3g} "
        f"(bound {SHARDED_RTOL}), bit-equal {rec['bit_equal']}; step_ms "
        f"{[round(t, 1) for t in step_ms]} (median of steps 2-"
        f"{SHARDED_STEPS} {rec['step_ms_median']:.1f}) peak_bytes={peak:,}")
    return rec


def train_phase(torch, dev, repo, out_dir, seed: int, log) -> dict:
    """The training half on the card: the dry-run started
    (``start_dryrun``), ``train_zoo``, ``train_full``, ``train_ssm``,
    ``train_sharded``, ``train_fault``, then the dry-run's records
    (``finish_dryrun``)."""
    dryrun = start_dryrun(repo, out_dir)
    rec = {"zoo": train_zoo(torch, dev, seed, log)}
    rec["full"] = train_full(torch, dev, log)
    rec["ssm"] = train_ssm(torch, dev, log)
    rec["sharded"] = train_sharded(torch, dev, out_dir, rec["full"], log)
    rec["fault"] = train_fault(torch, dev, repo, out_dir, log)
    rec["dryrun"] = finish_dryrun(dryrun, out_dir, rec["sharded"],
                                  rec["full"], log)
    return rec


def train_failures(rec: dict) -> list:
    fails = [f"train step {k}: card vs CPU loss rel err "
             f"{v['loss_rel_err']:.3g} / gradient err "
             f"{v['grad_err_of_max']:.3g} of max |g| beyond 1e-5 / "
             f"{v['grad_tol']}" for k, v in rec["zoo"].items()
             if not v["ok"]]
    full = rec["full"]
    if not full["finite"]:
        fails.append(f"{full['config']}: a loss is not finite")
    if not full["drop"] >= TRAIN_LOSS_DROP:
        fails.append(f"{full['config']}: the mean of the last 5 losses is "
                     f"{full['drop']:.4f} below the first, not "
                     f">= {TRAIN_LOSS_DROP}")
    ssm = rec["ssm"]
    if not ssm["finite"]:
        fails.append(f"{ssm['config']}: a loss is not finite")
    if not ssm["drop"] >= TRAIN_LOSS_DROP:
        fails.append(f"{ssm['config']}: the mean of the last 3 losses is "
                     f"{ssm['drop']:.4f} below the first, not "
                     f">= {TRAIN_LOSS_DROP}")
    n_bwd = ssm["launches_step2"]["selective_scan_ssd_bwd"]
    if (n_bwd != ssm["want_bwd_a_step"]
            or ssm["launches"]["selective_scan_ssd_bwd"]
            != ssm["want_bwd_a_step"] * TRAIN_SSM_STEPS):
        fails.append(f"{ssm['config']}: the scan's SSD backward launched "
                     f"{n_bwd} times in step 2 and "
                     f"{ssm['launches']['selective_scan_ssd_bwd']} in the "
                     f"run, not {ssm['want_bwd_a_step']} a step")
    if ssm["fwd_a_step"] < ssm["want_bwd_a_step"]:
        fails.append(f"{ssm['config']}: the scan's SSD forward launched "
                     f"{ssm['fwd_a_step']} times in step 2, under one a "
                     "mamba layer a microbatch")
    step_route = {k: ssm["launches_step2"][k] for k in SCAN_KERNELS["step"]
                  if ssm["launches_step2"][k]}
    if step_route:
        fails.append(f"{ssm['config']}: the scan's step kernels launched in "
                     f"step 2: {step_route}")
    if ssm["plain_ops_on_card_step2"]:
        fails.append(f"{ssm['config']}: {ssm['plain_ops_on_card_step2']} "
                     "ops of the scan's plain versions ran on the card")
    f = rec["fault"]
    if f["restarts"] != 1 or f["final_step"] != FAULT_STEPS:
        fails.append(f"fault loop: {f['restarts']} restarts, final step "
                     f"{f['final_step']} (1 and {FAULT_STEPS} expected)")
    if not f["restore_bit_equal"] or f["restore_step"] != FAULT_STEPS:
        fails.append(f"fault loop: checkpoint of step {f['restore_step']} "
                     f"differs from the live state")
    if not f["replay_max_rel_err"] <= FAULT_REPLAY_RTOL:
        fails.append(f"fault loop: replayed losses "
                     f"{f['replay_max_rel_err']:.3g} from the loop's")
    el = f["elastic"]
    if not (el["all_dtensor"] and el["placements_follow_specs"]
            and el["full_equal"] and el["step"] == FAULT_STEPS):
        fails.append(f"elastic restore onto a 1x1 mesh: {json.dumps(el)}")
    sh = rec["sharded"]
    if not sh["max_rel_err"] <= SHARDED_RTOL:
        fails.append(f"sharded step: losses {sh['losses']} vs "
                     f"{sh['unsharded_losses']} beyond {SHARDED_RTOL}")
    dr = rec["dryrun"]
    if any(rc != 0 for rc in dr["returncodes"].values()):
        fails.append(f"dry-run processes: {dr['returncodes']}")
    ok = [k for k, c in dr["cells"].items() if c["status"] == "ok"
          and c["flops_per_device"] > 0 and c["coll_bytes_per_device"] > 0]
    if len(ok) != 2:
        fails.append(f"dry-run: {len(ok)} ok production cells, not 2: "
                     f"{json.dumps(dr['cells'])}")
    want = {f"{a}|train_4k|16x16" for a in DRYRUN_SSM_ARCHS}
    ok = {k for k, c in dr["ssm_cells"].items() if c["status"] == "ok"}
    if ok != want:
        fails.append(f"dry-run SSM train cells not ok: "
                     f"{json.dumps(dr['ssm_cells'])}")
    want = {f"{a}|{c}|16x16" for a, c in DRYRUN_SERVE_CELLS}
    ok = {k for k, c in dr["serve_cells"].items() if c["status"] == "ok"}
    if ok != want:
        fails.append(f"dry-run serving cells not ok: "
                     f"{json.dumps(dr['serve_cells'])}")
    a = dr.get("anchor")
    if a is None or not a["peak_rel_err"] <= DRYRUN_PEAK_TOL:
        fails.append(f"dry-run of the train phase's cell: traced peak vs "
                     f"the card's beyond {DRYRUN_PEAK_TOL}: {json.dumps(a)}")
    return fails


def cross_device(torch, idx, gpu_ids, n: int = 64) -> float:
    """Share of the first n queries whose top-10 ids on the CPU (plain
    versions) equal the card's."""
    import dataclasses

    from repro_torch.plan import Searcher, SearchRequest

    cpu = Searcher.open(dataclasses.replace(idx, device="cpu"))
    got = cpu.search(SearchRequest(queries=idx.dataset.queries[:n])).ids
    return float((got == gpu_ids[:n]).all(1).mean())


def loop_control(torch, idx, reps: int = 3) -> dict:
    """Per-batch seconds of graph_search (a host check every
    DONE_CHECK_EVERY rounds) and graph_search_stepped (every round), in
    turns on the same 256 queries."""
    from repro_torch.core import search as S

    corpus = idx.corpus()
    q = idx.dataset.queries[:256]
    cfg = idx.config.search
    times = {"every_4": [], "every_1": []}
    for _ in range(reps):
        for name, fn in (("every_1", S.graph_search_stepped),
                         ("every_4", S.graph_search),
                         ("every_4", S.graph_search),
                         ("every_1", S.graph_search_stepped)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(corpus, q, cfg)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    return {k: _median(v) for k, v in times.items()}


def rerank_density(torch, idx) -> dict:
    """The share of rows the exact-distance masks ask for, from one
    256-query ``graph_search`` with ``ops.l2_rerank_masked`` wrapped to
    record each mask (the timed serving run is never instrumented): the
    mean over the rounds' calls, the share of rounds asking for no row, and
    the beta-margin rerank's share (the batch's last call)."""
    from repro_torch.core.search import graph_search
    from repro_torch.kernels import ops

    shares = []
    real = ops.l2_rerank_masked

    def spy(queries, ids, base, acc, mask, metric="l2"):
        shares.append(float(mask.float().mean()))
        return real(queries, ids, base, acc, mask, metric)

    ops.l2_rerank_masked = spy
    try:
        graph_search(idx.corpus(), idx.dataset.queries[-256:],
                     idx.config.search)
        torch.cuda.synchronize()
    finally:
        ops.l2_rerank_masked = real
    rounds = shares[:-1]
    return {"round_mean": sum(rounds) / len(rounds),
            "round_max": max(rounds),
            "rounds_asking_none": sum(x == 0 for x in rounds) / len(rounds),
            "rounds": len(rounds), "margin": shares[-1]}


# each kernel's device function on the main path, by the TPU kernel it ports
IN_SEARCH_SYMBOLS = {"pq_adt": "pq_adt_kernel",
                     "pq_lookup": "pq_lookup_gather_kernel",
                     "bitonic_sort_pairs": "warp_merge_kernel",
                     "l2_rerank": "l2_rerank_kernel"}


def profile_batch(torch, idx, out_dir) -> dict:
    """One 256-query ``graph_search`` under ``torch.profiler``: the device's
    busy share (kernel time over wall time, both under the profiler), the
    rounds the batch ran, the ops by host and device time (full tables in
    ``<out-dir>/profile.txt``), and each hand kernel's own device duration
    inside the search (CUPTI, L2 warm: median and launches)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.search import graph_search

    from repro_torch.kernels import loader

    corpus = idx.corpus()
    q = idx.dataset.queries[256:512]
    cfg = idx.config.search
    graph_search(corpus, q, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = graph_search(corpus, q, cfg)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    merges = loader.LAUNCHES["bitonic_sort_pairs"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        graph_search(corpus, q, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = loader.LAUNCHES["bitonic_sort_pairs"] - merges   # one a round
    ev = prof.key_averages()
    # device time = the kernels' own events (the aten ops that launched
    # them report the same time again), as the profiler's table sums it
    cuda = torch.autograd.DeviceType.CUDA
    dev_us = sum(e.self_device_time_total for e in ev
                 if e.device_type == cuda and not e.is_user_annotation)
    (out_dir / "profile.txt").write_text(
        ev.table(sort_by="self_cpu_time_total", row_limit=40) + "\n"
        + ev.table(sort_by="self_device_time_total", row_limit=25))
    top = sorted((e for e in ev if e.device_type != cuda),
                 key=lambda e: -e.self_device_time_total)[:6]
    kernels = [e for e in prof.events() if e.device_type == cuda]
    in_search = {}
    for kernel, symbol in IN_SEARCH_SYMBOLS.items():
        ms = [e.time_range.elapsed_us() / 1e3 for e in kernels
              if symbol in e.name]
        in_search[kernel] = {"launches": len(ms),
                             "median_ms": _median(ms) if ms else None}
    rounds = res.rounds.cpu()
    launches = sum(e.count for e in ev if e.key == "cudaLaunchKernel")
    return {
        "batch_wall_s": plain_wall, "profiled_wall_s": wall,
        "device_s": dev_us / 1e6,
        "device_busy_share": dev_us / (wall * 1e6),
        "device_busy_share_unprofiled": dev_us / (plain_wall * 1e6),
        "launches": launches, "rounds_stepped": steps,
        "launches_per_round": launches / steps,
        "rounds_max": int(rounds.max()), "rounds_mean": float(
            rounds.double().mean()),
        "top_device_ops_us": {e.key: e.self_device_time_total for e in top},
        "in_search_cupti": in_search,
    }


def profile_ticks(torch, idx, out_dir, ticks: int = 60) -> dict:
    """Continuous-engine ticks with the pool of 256 kept full (1,024 queries
    queued, 10 ticks of warm-up): first ``ticks`` ticks with the host
    seconds of each part timed (admission, the round, the read of the
    active flags, gather + finalize, complete), then as many under
    ``torch.profiler`` (launches and host syncs per tick, device busy
    share; tables in ``<out-dir>/profile_ticks.txt``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.plan.rounds import RoundSession
    from repro_torch.serve import ServingEngine
    from repro_torch.serve import engine as engine_mod

    engine = ServingEngine(idx, batch_size=256, continuous=True, slots=256)
    for v in idx.dataset.queries[:1024]:
        engine.submit(v)
    for _ in range(10):
        engine.step(force=True)
    parts = {"admit": 0.0, "step": 0.0, "active": 0.0,
             "gather_finalize": 0.0, "complete": 0.0}
    patched = [(engine_mod.ServingEngine, "_admit", "admit"),
               (RoundSession, "step", "step"),
               (RoundSession, "active", "active"),
               (RoundSession, "finalize", "gather_finalize"),
               (engine_mod, "_gather_rows", "gather_finalize"),
               (RoundSession, "complete", "complete")]
    real = [getattr(owner, name) for owner, name, _ in patched]

    def timed(fn, part):
        def wrapper(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            parts[part] += time.perf_counter() - t
            return out
        return wrapper

    torch.cuda.synchronize()
    for (owner, name, part), fn in zip(patched, real):
        setattr(owner, name, timed(fn, part))
    try:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step(force=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for (owner, name, _), fn in zip(patched, real):
            setattr(owner, name, fn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(ticks):
            engine.step(force=True)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    ev = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    dev_us = sum(e.self_device_time_total for e in ev
                 if e.device_type == cuda and not e.is_user_annotation)
    (out_dir / "profile_ticks.txt").write_text(
        ev.table(sort_by="self_cpu_time_total", row_limit=40))

    def count(key):
        return sum(e.count for e in ev if e.key == key) / ticks

    return {
        "ticks": ticks, "tick_ms": wall / ticks * 1e3,
        "part_ms_per_tick": {k: v / ticks * 1e3 for k, v in parts.items()},
        "profiled_tick_ms": prof_wall / ticks * 1e3,
        "launches_per_tick": count("cudaLaunchKernel"),
        "stream_syncs_per_tick": count("cudaStreamSynchronize"),
        "memcpys_per_tick": count("cudaMemcpyAsync"),
        "device_busy_share": dev_us / (prof_wall * 1e6),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-base", type=int, default=1_000_000)
    ap.add_argument("--num-queries", type=int, default=10_000)
    # more, smaller clusters than DatasetConfig's 64 x 0.15: each cluster
    # must hold fewer points than the build list (128), or every kNN list
    # stays inside its cluster and recall collapses (PERF.md)
    ap.add_argument("--num-clusters", type=int, default=16384)
    ap.add_argument("--cluster-std", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default="results/chip_smoke",
                    help="where the details go, relative to the repo root")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on a "
              "GPU", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo / "src"))
    out_dir = repo / args.out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    detail = {}

    def log(msg):
        print(msg, flush=True)

    dev = torch.device("cuda")
    card = _card_line()
    log(card)
    from repro_torch.kernels import loader

    t0 = time.perf_counter()
    reports = loader.build_all()
    detail["kernel_build_s"] = time.perf_counter() - t0
    (out_dir / "ptxas.txt").write_text("\n".join(
        f"== {k}\n{v}" for k, v in reports.items()))
    log(f"kernels built in {detail['kernel_build_s']:.1f} s "
        f"({', '.join(reports) or 'cached'})")

    phase_s = {}
    t_mark = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now

    res, ds, idx, gpu_ids, gpu_dists = main_path(torch, dev, args, log)
    log(f"launches on the main path: {json.dumps(res['launches'])}")
    log(f"served {args.num_queries} queries in {res['wall_s']:.3f} s: "
        f"QPS={res['qps']:.1f} p50_ms={res['p50_ms']:.2f} "
        f"p99_ms={res['p99_ms']:.2f} batch_ms_median={res['batch_ms_median']}"
        f" mean_rounds={res['mean_rounds']:.2f} "
        f"mean_batch_max_rounds={res['mean_batch_max_rounds']:.2f} "
        f"mean_hops={res['mean_hops']:.2f} "
        f"recall@10={res['recall_at_10']:.4f}")
    log(f"engine ids equal Searcher.search: {res['engine_equals_searcher']}")
    log(f"mean hot hops per query {res['mean_hot_hops']:.2f}, mean PQ "
        f"fetches covered by hot-node pages {res['mean_free_pq']:.2f}")
    res["rerank_density"] = rerank_density(torch, idx)
    log(f"exact-distance mask density: {json.dumps(res['rerank_density'])}")
    mark("main")

    cont = continuous_phase(torch, idx, gpu_ids, gpu_dists, log)
    mark("continuous")
    distributed, dist_inputs = distributed_phase(torch, dev, idx, out_dir,
                                                 repo, log)
    mark("distributed")
    filt, store = filtered_phase(torch, idx, log)
    filt["masked_density"] = masked_density(torch, idx, store)
    log(f"exact-distance mask density, masked search: "
        f"{json.dumps(filt['masked_density'])}")
    mark("filtered")

    tiled, tiles = tiled_phase(torch, idx, gpu_ids, log)
    mark("tiled")
    ivf, ivf_inputs = ivf_phase(torch, idx, gpu_ids, log)
    mark("ivf")
    segmented, seg = segmented_phase(torch, idx.config, ds, dev, log)
    del ds
    mark("segmented")
    observed = obs_phase(torch, idx, tiles, seg, log)
    del tiles, seg
    mark("observability")
    streamed = stream_phase(torch, idx, {"batch": res["qps"],
                                         "continuous": cont["qps"]},
                            res["build_peak_bytes"], args.seed, out_dir, log)
    mark("streaming")
    from repro_torch.configs import get_config

    models, retr_inputs = model_phase(torch, dev, get_config(SERVE_ARCH),
                                      args.seed, out_dir, repo, log)
    mark("models")
    ssm = ssm_phase(torch, dev, args.seed, log)
    mark("ssm_serve")
    trained = train_phase(torch, dev, repo, out_dir, args.seed, log)
    mark("train")

    scan_pass = int(store.mask(_specs()["range_price_0_9"]).sum())
    kernels = kernel_phase(torch, dev, args.num_base, res["rerank_density"],
                           filt["masked_density"], scan_pass, ivf_inputs,
                           dist_inputs, retr_inputs, args.seed)
    del ivf_inputs, dist_inputs, retr_inputs
    mark("kernels")
    tiled_launches = {k: sum(v["launches"][k]
                             for v in tiled["variants"].values())
                      for k in res["launches"]}
    paths = {"batch": res["launches"], "continuous": cont["launches"],
             "filtered_continuous": filt["continuous"]["launches"],
             "filtered_batch": filt["batch"]["launches"],
             "tiled": tiled_launches, "segmented": segmented["launches"],
             "obs": observed["batch"]["launches"],
             "stream": streamed["before"]["batch"]["launches"],
             "distributed_nsp": distributed["world_1"]["nsp_E1"]["launches"],
             "distributed_fetch":
                 distributed["world_1"]["fetch_E1"]["launches"],
             "retrieval": models["retrieval"]["launches"]}
    for k in kernels:
        k["launches"] = res["launches"][k["name"]]
        k["launches_by_path"] = {p: n[k["name"]] for p, n in paths.items()}
        k["launches_by_path"]["ivf"] = sum(
            r["launches"][k["name"]] for r in ivf["sweep"].values())
        k["launches_build"] = res["build_launches"][k["name"]]
        for e in k["entries"]:
            log(f"kernel {k['name']} [{e['entry']}]: "
                f"max_abs_err={e['max_abs_err']:.3g} ms={e['ms']:.4f} "
                f"cupti_ms={e['cupti_ms']:.4f} "
                f"plain_ms={e['plain_ms']:.4f} library_ms={e['library']} "
                f"bound_ms={e['bound_ms']:.5f} ({e['bound_by']})")

    # what the same timing reads for a kernel that does (almost) nothing
    floor_ms, floor_cupti = _time_ms(
        torch, lambda: torch.cuda._sleep(1), _Flush(torch, dev), SPIN_SYMBOL)
    detail["timing_floor_ms"] = floor_ms
    detail["timing_floor_cupti_ms"] = floor_cupti
    log(f"timing floor (one near-empty kernel, timed as above): "
        f"ms={floor_ms:.4f} cupti_ms={floor_cupti:.4f}")

    share = cross_device(torch, idx, gpu_ids)
    res["cross_device_identical_rows"] = share
    log(f"cross-device: {share:.4f} of 64 top-10 rows identical CPU vs GPU")
    res["loop_control_s"] = loop_control(torch, idx)
    log(f"loop control, seconds per 256-query batch: "
        f"{json.dumps(res['loop_control_s'])}")
    res["profile"] = profile_batch(torch, idx, out_dir)
    log(f"profiled batch: {json.dumps(res['profile'])}")
    cont["profile"] = profile_ticks(torch, idx, out_dir)
    log(f"continuous ticks, timed and profiled: "
        f"{json.dumps(cont['profile'])}")
    mark("cross_device_and_profiles")
    ssm.update(scan_phase(torch, dev, args.seed, ssm["serve"], log))
    # the scan's launches by path: serving (ssm_serve's timed rounds), the
    # zoo's train steps (train_zoo), zamba2-1.2B's training (train_ssm)
    for rec in ssm["scan_kernels"]:
        name = rec["name"]
        by_path = {
            "ssm_serve": sum(r["launches"][part].get(name, 0)
                             for r in ssm["serve"].values()
                             for part in ("prefill", "decode")),
            "train_zoo": sum(v["scan_launches"].get(name, 0)
                             for v in trained["zoo"].values()),
            "train_ssm": trained["ssm"]["launches"][name]}
        rec.update(launches=sum(by_path.values()), launches_by_path=by_path)
        kernels.append(rec)
    mark("ssm_kernel")
    detail["phase_s"] = phase_s
    log(f"seconds by phase (the kernel build apart): {json.dumps(phase_s)}")

    detail.update(card=card, kernels=kernels, main=res, continuous=cont,
                  filtered=filt, tiled=tiled, ivf=ivf, segmented=segmented,
                  observability=observed, streaming=streamed,
                  distributed=distributed, models=models, ssm=ssm,
                  train=trained)
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))

    failures = []
    if min(res["launches"].values()) <= 0:
        failures.append(f"a kernel never launched: {res['launches']}")
    # the exact distances: once a round (one merge a round) and once a
    # batch (the beta-margin rerank)
    rounds_and_batches = (res["launches"]["bitonic_sort_pairs"]
                          + res["batches"])
    if res["launches"]["l2_rerank"] != rounds_and_batches:
        failures.append(f"l2_rerank launched {res['launches']['l2_rerank']} "
                        f"times, not once a round and a batch "
                        f"({rounds_and_batches})")
    if res["recall_at_10"] < 0.5:
        failures.append(f"recall@10 {res['recall_at_10']:.4f} < 0.5")
    if not res["engine_equals_searcher"]:
        failures.append("engine ids differ from Searcher.search")
    if share < 0.95:
        failures.append(f"cross-device identical rows {share:.4f} < 0.95")
    for path, counts in paths.items():
        if min(counts.values()) <= 0:
            failures.append(f"a kernel never launched on the {path} path: "
                            f"{counts}")
    if not cont["equals_batch_engine"]:
        failures.append("continuous engine ids/distances differ from the "
                        "batch-flush engine's")
    if cont["fallback_batches"]:
        failures.append("the unfiltered continuous run fell back to batches")
    for (name, strategy), want_l in zip(FILTER_SPECS, (512, 1024, None, None)):
        rec = filt["specs"][name]
        if rec["strategy"] != strategy:
            failures.append(f"filter {name}: strategy {rec['strategy']}, "
                            f"expected {strategy}")
        if want_l and rec["effective_list_size"] != want_l:
            failures.append(f"filter {name}: L={rec['effective_list_size']}, "
                            f"expected {want_l}")
        if not (rec["engines_equal"] and rec["all_ids_pass"]):
            failures.append(f"filter {name}: engines differ or an id fails "
                            f"the filter")
        if strategy == "empty":
            if not rec["all_padding"]:
                failures.append(f"filter {name}: empty plan returned ids")
        elif rec["recall_at_10"] < 0.5:
            failures.append(f"filter {name}: recall@10 "
                            f"{rec['recall_at_10']:.4f} < 0.5")
    if res["hot_count"] != math.ceil(0.03 * args.num_base) or not res["gap"]:
        failures.append(f"the default index has {res['hot_count']} hot nodes "
                        f"and gap {res['gap']}")
    for key in ("pq_adt", "pq_lookup", "l2_rerank"):
        if res["build_launches"][key] <= 0:
            failures.append(f"{key} never launched in the build's trace "
                            "and calibrate_beta")
    shard_runs = dict(tiled["variants"], segments=segmented["tiled"])
    for name, rec in shard_runs.items():
        if rec["recall_at_10"] < 0.5:
            failures.append(f"tiled {name}: recall@10 "
                            f"{rec['recall_at_10']:.4f} < 0.5")
        if rec["cross_tile_merges"] != rec["batches"]:
            failures.append(f"tiled {name}: {rec['cross_tile_merges']} "
                            f"cross-tile merges for {rec['batches']} batches")
        if not rec["engine_equals_searcher"]:
            failures.append(f"tiled {name}: engine ids differ from "
                            "Searcher.search")
        if rec["cross_device_identical_rows"] < 0.95:
            failures.append(f"tiled {name}: cross-device identical rows "
                            f"{rec['cross_device_identical_rows']:.4f} < 0.95")
    if not tiled["ab"]["unrolled_vs_batched"]["bit_equal"]:
        failures.append("the batched tile fan-out differs from the unrolled "
                        "one (ids, distances, probed or per-tile counters)")
    failures.extend(ivf_failures(ivf))
    if segmented["flat"]["recall_at_10"] < 0.5:
        failures.append(f"segmented flat: recall@10 "
                        f"{segmented['flat']['recall_at_10']:.4f} < 0.5")
    failures.extend(obs_failures(observed))
    failures.extend(stream_failures(streamed))
    failures.extend(distributed_failures(distributed))
    failures.extend(model_failures(models))
    failures.extend(ssm_failures(ssm))
    for rec in ssm["scan_kernels"]:
        if rec["launches"] <= 0:
            failures.append(f"{rec['name']} never launched on the SSM "
                            f"paths: {rec['launches_by_path']}")
    failures.extend(train_failures(trained))
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
