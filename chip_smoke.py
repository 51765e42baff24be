#!/usr/bin/env python3
"""End-to-end smoke of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (the exit code is not 0 and the last line is
not printed):

1. The card's name and power limit, then the build of the four kernels from
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
   Filtered phase: ``random_attributes(N, {"category": 8, "price": 1000},
   seed=5)`` and four specs — ``isin(category, [0, 1, 2])`` (~37.5%,
   masked, L=512), ``eq(category, 3)`` (~12.5%, masked, L=1024), ``range(price, 0,
   9)`` (~1%, scan) and one no node passes (empty) — 2048 queries each,
   interleaved, through the continuous engine and the batch-flush engine; then each spec alone through ``Searcher.search``
   (strategy, effective L, rounds per lane, launches).  Fails unless the
   two engines agree bit for bit, every returned id passes its filter, the
   strategies and L are as listed, the empty spec returns only padding, and
   filtered recall@10 against an exact filtered kNN on the card is >= 0.5.
   Tiled phase: the same index in 4 channel tiles through
   ``ServingEngine(num_tiles=4, shard_policy=, probe_tiles=)`` — cluster
   tiles at full fan-out and routed to 2 tiles, hash tiles at full fan-out —
   2,048 queries each: tile-build seconds (per-tile graphs rebuilt on the
   card), QPS, recall@10, launches, cross-tile merges (one sort launch a
   batch).  Fails unless recall@10 >= 0.5, the engine's ids equal
   ``Searcher.search``'s, 64 queries on the CPU over the same tiles equal the
   card's in >= 95% of rows, and the merges equal the batches.
   Segmented phase: ``build_segmented`` of the corpus in 4 segments of
   250,000 on the card, 16,384 stitch anchors a joining segment (stage and
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
   (L=1024, n=64, the block network), the masked entry at K=1024 at the
   masked search's density, the lookup over the scan's (Q=256, S=16384)
   rows.  The new call sites of this index: ``pq_adt`` at Q=1 and the
   lookup at (1, 64) (the reorder trace), the lookup at (256, 512)
   (``calibrate_beta``), ``l2_rerank_masked`` at (1, 16) (the trace's exact
   distances), and the sort entry at the cross-tile merge's (256, 64), with
   ties, duplicate ids keyed +inf and -1 padding.  Each entry is timed over
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
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
REORDER_SAMPLES = 128            # build_index's default trace sample
SHARD_QUERIES = 2048             # of the 10,000, for the smoke's time
NUM_TILES = 4
TILED_VARIANTS = (("cluster", 0), ("cluster", 2), ("hash", 0))
SEGMENT_SIZE = 250_000
# boundary anchors a joining segment stitches (BuildConfig's default is 32:
# the stitched 1M graph then stays inside segment 0, recall@10 0.2339 on an
# H100, PERF.md)
STITCH_SAMPLE = 16384
FP32_FLOP_PER_S = 67e12          # H100 SXM float32 outside the tensor cores


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
    out the launch gap that the events also count."""
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
    return _median(times), _median(kern)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _bound(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, dev, n_base: int, rerank_density: dict,
                 filter_density: dict, scan_pass: int, seed: int = 0) -> list:
    """Each kernel vs its plain version at the main path's shapes; raises
    on a disagreement.  Returns one record per kernel (launches filled in
    from the main path): the top-level numbers are those of the entry the
    search's round runs, and ``entries`` holds every entry timed.  The
    rerank's masked entry runs at the shares of rows that the round's and
    the margin's masks ask for on the main path (``rerank_density``), and
    at K=1024 at the masked search's share (``filter_density``); the
    filtered paths' merges at L=512 and 1024 and the scan's lookup over
    the ``scan_pass`` passing rows, padded to a power of two as the scan
    pads them, are entries too."""
    from repro_torch.core.search import next_pow2
    from repro_torch.kernels import ops

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
    qs = queries.reshape(q, m, d // m).transpose(0, 1).contiguous()

    def adt_entry(label, nq):
        qq, qsub = queries[:nq], qs[:, :nq]
        return entry(
            label, "pq_adt_kernel", ops.pq_adt(qq, cents, "l2"),
            ops.pq_adt_plain(qq, cents, "l2"), 1e-4, 1e-4,
            lambda: ops.pq_adt(qq, cents, "l2"),
            lambda: ops.pq_adt_plain(qq, cents, "l2"),
            {"cdist": lambda: torch.cdist(qsub, cents)},  # sqrt of the table
            4 * (nq * d + m * c * (d // m) + nq * m * c),
            3 * nq * m * c * (d // m))

    record("pq_adt", "src/repro_torch/kernels/csrc/pq_adt.cu",
           "src/repro/kernels/pq_adt.py:38", adt_entry("pq_adt", q),
           adt_entry("pq_adt_Q1_trace", 1))

    # ---- pq_lookup (the search's gather entry, masked and not) -----------
    adts = ops.pq_adt(queries, cents, "l2")
    offs = torch.arange(m, device=dev) * c
    flat_idx = codes[nbr.long()].long() + offs                # (Q, R, M)
    adt_flat = adts.reshape(q, 1, m * c).expand(q, r, m * c)
    lane_idx = flat_idx + torch.arange(q, device=dev)[:, None, None] * (m * c)

    def lookup_bytes(rows):
        """ids + mask + per scored row M code bytes + the ADT entries the
        scored rows touch + the output, each once."""
        touched = int(torch.unique(lane_idx[rows]).numel())
        return 4 * q * r + q * r + int(rows.sum()) * m + 4 * touched + 4 * q * r

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
        lookup_bytes(fresh), int(fresh.sum()) * m)
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
    touched1 = int(torch.unique(lane_idx[:1]).numel())
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
               libraries, lookup_bytes(everything) - q * r, q * r * m), scan,
           trace, calib)

    # ---- bitonic_sort_pairs: the merge entry the round runs, the sort ----
    def merge_inputs(n, l):
        """A lane's list (sorted prefix, +inf tail with -1 ids) and n fresh
        candidates (30% stale: +inf, -1), with ties and signed zeros."""
        dl = signed(ints(0, 64, (q, l)).float()).sort(dim=1).values
        tail = torch.arange(l, device=dev) >= ints(l // 2, l + 1, (q, 1))
        dl[tail] = inf
        ids = torch.where(tail, -1, ints(0, n_base, (q, l), torch.int32))
        acc = torch.where(rand(q, l) < 0.3, rand(q, l), inf)
        ev = rand(q, l) < 0.5
        nd = signed(ints(0, 64, (q, n)).float())
        stale = rand(q, n) < 0.3
        nd[stale] = inf
        n_ids = torch.where(stale, -1, ints(0, n_base, (q, n), torch.int32))
        return ids, dl, acc, ev, n_ids, nd

    def network_ops(width):
        lg = (width - 1).bit_length()
        return q * (1 << lg) // 2 * lg * (lg + 1) // 2

    def merge_entry(n, l=l):
        cols = merge_inputs(n, l)
        cat = [torch.cat([cols[0], cols[4]], 1), torch.cat([cols[1], cols[5]], 1),
               torch.cat([cols[2], torch.full_like(cols[5], inf)], 1),
               torch.cat([cols[3], torch.zeros_like(cols[3][:, :1]).expand(
                   q, n)], 1)]

        def sort_and_gathers():
            order = torch.sort(cat[1], dim=1, stable=True).indices[:, :l]
            return [t.gather(1, order) for t in cat]

        return entry(
            f"merge_L{l}_n{n}",
            "warp_merge_kernel" if l + n <= 1024 else "block_sort_kernel",
            ops.bitonic_merge_topl(*cols),
            ops.bitonic_merge_topl_plain(*cols), 0.0, 0.0,
            lambda: ops.bitonic_merge_topl(*cols),
            lambda: ops.bitonic_merge_topl_plain(*cols),
            {"sort_and_4_gathers": sort_and_gathers},
            26 * q * l + 8 * q * n, network_ops(l + n))

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
    record("bitonic_sort_pairs", "src/repro_torch/kernels/csrc/bitonic_topk.cu",
           "src/repro/kernels/bitonic_topk.py:57", merge_entry(r),
           merge_entry(4 * r), merge_entry(r, 4 * l), merge_entry(r, 8 * l),
           cross, entry(
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
            label, "l2_rerank_kernel",
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

    def at_density(label, share, k=l):
        if k == l:
            cols = dict()
        else:
            kc = ints(0, n_base, (q, k), torch.int32)
            cols = dict(cand=kc,
                        acc=torch.where(rand(q, k) < 0.5, rand(q, k), inf),
                        gathered=base[kc.long()])
        mask = rand(q, k) < share
        e = masked_entry(label, mask, **cols)
        e["mask_share"] = float(mask.float().mean())
        return e

    record("l2_rerank", "src/repro_torch/kernels/csrc/l2_rerank.cu",
           "src/repro/kernels/l2_rerank.py:39",
           at_density("masked", rerank_density["round_mean"]),
           at_density("masked_margin", rerank_density["margin"]),
           at_density(f"masked_K{filter_density['K']}",
                      filter_density["round_mean"], filter_density["K"]),
           masked_entry("masked_all", torch.ones((q, l), dtype=torch.bool,
                                                 device=dev)),
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
    idx = build_index(cfg, dataset=ds, device=dev, stage_times=stages,
                      reorder_samples=REORDER_SAMPLES, calibrate=True)
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
    ~37.5% and ~12.5%, scan at ~1%, empty), 2,048 queries each,
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

    n_per_spec = 2048          # of the 10,000 queries, for the smoke's time
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
        "engine_equals_searcher": bool(
            (_searcher_ids(searcher, queries) == ids).all()),
        "cross_device_identical_rows": float(
            (cpu_ids == ids[:64]).all(1).mean()),
    }
    log(f"tiled {name}: {len(queries)} queries in {wall:.3f} s: "
        f"QPS={rec['qps']:.1f} recall@10={rec['recall_at_10']:.4f} "
        f"batches={batches} cross_tile_merges={rec['cross_tile_merges']} "
        f"engine_equals_searcher={rec['engine_equals_searcher']} "
        f"cross_device={rec['cross_device_identical_rows']:.4f} "
        f"launches={json.dumps(launches)}")
    return rec


def tiled_phase(torch, idx, flat_ids, log) -> tuple:
    """The main path's index served in NUM_TILES channel tiles through
    ``ServingEngine(num_tiles=, shard_policy=, probe_tiles=)``: cluster
    tiles at full fan-out and routed to 2 tiles, hash tiles at full
    fan-out, SHARD_QUERIES queries each.  Each policy's tiles are built
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
    finally:
        index_mod.ProximaIndex.sharded_corpus = real
    return out, built


def segmented_phase(torch, cfg, ds, dev, log) -> tuple:
    """``build_segmented`` of the main path's corpus in SEGMENT_SIZE
    segments on the card (stage seconds summed over the segments, the
    stitch's seconds and patched rows), then SHARD_QUERIES queries served
    tiled through its segments and flat through ``to_flat()`` (the
    stitched graph).  Returns (the record, the segmented index)."""
    from repro_torch.core.dataset import recall_at_k
    from repro_torch.core.segmented import build_segmented
    from repro_torch.plan import Searcher
    from repro_torch.serve import ServingEngine

    import dataclasses

    cfg = dataclasses.replace(cfg, build=dataclasses.replace(
        cfg.build, stitch_sample=STITCH_SAMPLE))
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

    cont = continuous_phase(torch, idx, gpu_ids, gpu_dists, log)
    filt, store = filtered_phase(torch, idx, log)
    filt["masked_density"] = masked_density(torch, idx, store)
    log(f"exact-distance mask density, masked search: "
        f"{json.dumps(filt['masked_density'])}")

    tiled, tiles = tiled_phase(torch, idx, gpu_ids, log)
    segmented, seg = segmented_phase(torch, idx.config, ds, dev, log)
    del ds
    observed = obs_phase(torch, idx, tiles, seg, log)
    del tiles, seg

    scan_pass = int(store.mask(_specs()["range_price_0_9"]).sum())
    kernels = kernel_phase(torch, dev, args.num_base, res["rerank_density"],
                           filt["masked_density"], scan_pass, args.seed)
    tiled_launches = {k: sum(v["launches"][k]
                             for v in tiled["variants"].values())
                      for k in res["launches"]}
    paths = {"batch": res["launches"], "continuous": cont["launches"],
             "filtered_continuous": filt["continuous"]["launches"],
             "filtered_batch": filt["batch"]["launches"],
             "tiled": tiled_launches, "segmented": segmented["launches"],
             "obs": observed["batch"]["launches"]}
    for k in kernels:
        k["launches"] = res["launches"][k["name"]]
        k["launches_by_path"] = {p: n[k["name"]] for p, n in paths.items()}
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

    detail.update(card=card, kernels=kernels, main=res, continuous=cont,
                  filtered=filt, tiled=tiled, segmented=segmented,
                  observability=observed)
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
    if segmented["flat"]["recall_at_10"] < 0.5:
        failures.append(f"segmented flat: recall@10 "
                        f"{segmented['flat']['recall_at_10']:.4f} < 0.5")
    failures.extend(obs_failures(observed))
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
