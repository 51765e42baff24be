#!/usr/bin/env python3
"""Time the tile choices of the redesigned ``pq_adt`` and ``l2_rerank``
kernels on one NVIDIA GPU, at the search's shapes (Q=256, M=32, C=256,
dsub=4; K=128, D=128, a 1M-row base), of ``pq_adt``'s wide kernel at
the image retriever's (Q=256, D=2048) x (32, 256, 64) and at dsub 8 and 16,
and of ``pq_lookup``'s lists entry at an IVF-PQ chunk's shape (124 queries
x nprobe 16 over 64 lists of up to 16,864 rows, M=32, C=256), of the
search's merge at a round's Q=256 lanes and n=64 fresh candidates for L =
128, 256, 512, 1,024 and 2,048 (and n=256 at L=128 and 1,024; the
retriever's (256; 64, 32), the tiled fan-out's (1,024; 128, 64), the
trace's (1; 128, 64)) on the warp merge and the rank merge, of the
step scan's forward at falcon-mamba-7b's and zamba2-1.2B's layer shapes,
of the masked rerank's wide path at the image retriever's round shape
(Q=256, K=64, D=2,048, N=8,192, angular) and at D=1,024, evenly spread
masks, and on the retriever's own calls (``--round``), and of Mamba-1's
backward at falcon-mamba-7b's (B, S) = (2, 2,048) (zero and carried
state) and (8, 2,048):

    python3 scripts/kernel_variants.py [--out-dir results/kernel_variants]
                                       [--groups pq_adt l2_rerank ...]
                                       [--baseline DIR] [--round FILE]

Each variant is the kernel source compiled with other values of its tile
macros (``PQ_ADT_QB``: queries per tile; ``PQ_ADT_WIDE_TQ`` and
``PQ_ADT_WIDE_D``: the wide kernel's queries a thread and dsub values
staged at a time; ``PQ_LOOKUP_LISTS_ROWS``: list rows a block scores for
one staged ADT; ``L2_RERANK_WINDOW`` and ``L2_RERANK_ROWS``: candidates
per warp and rows in flight; ``BITONIC_RANK_FROM``: the shortest list the
rank merge takes, 0 sending every merge to it and 4096 none a warp holds;
``SCAN_THREADS``, ``SCAN_UNROLL`` and ``SCAN_TILE``: the step scan's
threads a block, steps unrolled and steps staged at a time;
``L2_RERANK_WIDE_THREADS``, ``L2_RERANK_WIDE_WINDOW`` and
``L2_RERANK_WIDE_ROWS``: the wide rerank's threads a block, candidates a
block and rows in flight; ``SCAN_BWD_TILE`` and ``SCAN_BWD_CHUNK``: the
backward's steps a register tile and steps staged a chunk), or with a
text of it replaced (``SUBS``: the backward's decay as ``expf`` or as plain
``ex2.approx`` of dt a log2 e, in place of ex2.approx of the argument moved
up by one), checked against the plain version, then timed the way ``chip_smoke.py`` times a
kernel (median of 30 launches, L2 flushed before each, CUDA events and the
kernel's own CUPTI duration).  The rerank runs at mask densities from none
to every row, and with ``--round FILE`` (``scripts/retriever_round.py
--save FILE``) the wide rerank also runs the image retriever's own calls:
the one ``chip_smoke.py``'s ``masked_retriever_*`` entry times, and every
call of that search batch in order (``retriever_batch``: the L2 flushed
before the batch, not before each call; its CUPTI time is the sum of the
batch's kernels).  The backward's errors are each gradient's largest over its
largest magnitude, against the plain backward (run once a case).  With
``--read-flush`` each timing is repeated after a flush that reads 64 MiB
instead of writing it, which leaves the L2 clean rather than full of dirty
lines.  The merge group also times the library yardstick beside each
shape: ``torch.sort(stable=True)`` of the keys and four gathers (CUDA
events).  ``--baseline DIR`` adds, to every group, the
kernel source of the same name in DIR (another commit's
``src/repro_torch/kernels/csrc``, unpacked with ``git archive``) as the
variant "baseline", so an earlier kernel and this one are timed in turns on
one card.  Variants run in turns, twice.  Prints one line per (variant,
case) (the scan's with its y and h_last errors over their largest
magnitudes) and writes ``variants.json`` to the output directory.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# group -> (kernel source, variants)
GROUPS = {
    "pq_adt": ("pq_adt", [{"PQ_ADT_QB": qb} for qb in (4, 8, 16)]),
    "l2_rerank": ("l2_rerank", [{"L2_RERANK_WINDOW": w, "L2_RERANK_ROWS": r}
                                for w, r in ((32, 8), (16, 8), (8, 8),
                                             (8, 4))]),
    "pq_adt_wide": ("pq_adt", [{"PQ_ADT_WIDE_TQ": tq, "PQ_ADT_WIDE_D": d}
                               for tq in (4, 8) for d in (32, 64)]),
    "pq_lookup_lists": ("pq_lookup", [{"PQ_LOOKUP_LISTS_ROWS": r}
                                      for r in (2048, 4096, 8192)]),
    "merge": ("bitonic_topk", [{}, {"BITONIC_RANK_FROM": 0},
                               {"BITONIC_RANK_FROM": 4096}]),
    "scan": ("selective_scan", [{}, {"SCAN_THREADS": 128},
                                {"SCAN_UNROLL": 4}, {"SCAN_TILE": 32}]),
    "rerank_wide": ("l2_rerank", [
        {}, {"L2_RERANK_WIDE_ROWS": 4}, {"L2_RERANK_WIDE_ROWS": 2},
        {"L2_RERANK_WIDE_WINDOW": 16},
        {"L2_RERANK_WIDE_THREADS": 256, "L2_RERANK_WIDE_ROWS": 2},
        {"L2_RERANK_WIDE_THREADS": 1024},
        {"L2_RERANK_WIDE_THREADS": 1024, "L2_RERANK_WIDE_ROWS": 4},
        {"L2_RERANK_WIDE_THREADS": 1024, "L2_RERANK_WIDE_ROWS": 16}]),
    "scan_bwd": ("selective_scan_bwd", [
        {}, {"_sub": "expf"}, {"_sub": "ex2_plain"}, {"SCAN_BWD_TILE": 4},
        {"SCAN_BWD_CHUNK": 64}]),
}
# source substitutions a variant names with "_sub": (old text, new text),
# every occurrence replaced
SUBS = {"expf": [("decay(dtv, rate2[j])", "expf(dtv * rate[j])")],
        "ex2_plain": [("  return 0.5f * ex2(fmaf(dtv, r2, 1.f));",
                       "  return ex2(dtv * r2);")]}
# the merge's (Q, L, n) and the step scan's (B, S, di, ds, heads or None)
MERGES = ((256, 128, 64), (256, 128, 256), (256, 256, 64), (256, 512, 64),
          (256, 1024, 64), (256, 1024, 256), (256, 2048, 64),
          (256, 64, 32), (1024, 128, 64), (1, 128, 64))
# the step scan's (B, S, di, ds, heads or None, carried state), drawn as
# ``chip_smoke.py`` draws the models' scan inputs
SCANS = {"falcon_prefill_2x2048": (2, 2048, 8192, 16, None, False),
         "falcon_prefill_2x2048_carried": (2, 2048, 8192, 16, None, True),
         "falcon_8x2048": (8, 2048, 8192, 16, None, False),
         "falcon_8x300_carried": (8, 300, 8192, 16, None, True),
         "falcon_decode_2": (2, 1, 8192, 16, None, True),
         "zamba2_decode_8": (8, 1, 4096, 64, 64, True)}
DENSITIES = (0.0, 0.005, 0.09, 0.34, 1.0)
# the wide rerank's (Q, K, D, N) and densities, spread evenly (the
# retriever's own calls: --round)
WIDE = ((256, 64, 2048, 8192), (256, 64, 1024, 8192))
WIDE_DENSITIES = (0.0, 0.0007, 0.005, 0.09, 1.0)
# Mamba-1's backward: (B, S, carried state, checked) at falcon-mamba-7b's
# widths; (8, 2,048) is timed only (its plain backward's autograd graph
# would hold tens of GB)
SCAN_BWDS = {"falcon_bwd_2x2048": (2, 2048, False, True),
             "falcon_bwd_2x2048_carried": (2, 2048, True, True),
             "falcon_bwd_8x2048": (8, 2048, False, False)}


def build(loader, out: Path, groups, baseline=None) -> dict:
    """Compile every variant of ``groups`` (and, from ``baseline``, the
    source of the same name as the variant "baseline"), in parallel;
    {(group, tag): CDLL}."""
    procs = {}
    for group in groups:
        name, variants = GROUPS[group]
        todo = [("_".join(f"{k.strip('_')}{v}" for k, v in m.items())
                 or "default", m, loader._CSRC / f"{name}.cu")
                for m in variants]
        if baseline is not None:
            todo.append(("baseline", {}, Path(baseline) / f"{name}.cu"))
        for tag, macros, src in todo:
            so = out / f"lib{name}_{group}_{tag}.so"
            if "_sub" in macros:
                text = src.read_text()
                for old, new in SUBS[macros["_sub"]]:
                    if old not in text:
                        raise SystemExit(f"{name}.cu no longer holds {old!r}")
                    text = text.replace(old, new)
                src = out / f"{name}_{group}_{tag}.cu"
                src.write_text(text)
            cmd = [loader._nvcc(), *loader.NVCC_FLAGS,
                   *(f"-D{k}={v}" for k, v in macros.items()
                     if not k.startswith("_")), "-o", str(so), str(src)]
            procs[(group, tag)] = (so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[key] = lib
    return libs


class _ReadFlush:
    """Reads 64 MiB between timed launches: the L2 ends up holding clean
    lines, so the next kernel's misses write nothing back."""

    def __init__(self, torch, dev):
        self.buf = torch.ones(1 << 24, dtype=torch.float32, device=dev)

    def __call__(self):
        self.buf.sum()


def _batch_ms(torch, cs, fn, flush, symbol, launches, reps=10):
    """(events ms, summed CUPTI ms) of ``fn``, a call that launches
    ``launches`` kernels named with ``symbol``: the median over ``reps``
    calls, each after a flush and a ~1 ms spin; the CUPTI time is each
    call's kernels summed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    times = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            torch.cuda._sleep(cs.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == cuda and symbol in e.name]
    if len(kern) != reps * launches:
        print(f"profiler kept {len(kern)} of {reps * launches} launches of "
              f"{symbol!r}", file=sys.stderr)
    return cs._median(times), sum(kern) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default="results/kernel_variants")
    ap.add_argument("--read-flush", action="store_true")
    ap.add_argument("--groups", nargs="+", choices=sorted(GROUPS),
                    default=list(GROUPS))
    ap.add_argument("--baseline", default=None,
                    help="a directory of kernel sources to time as the "
                         "variant 'baseline'")
    ap.add_argument("--round", default=None,
                    help="the image retriever's rerank calls "
                         "(scripts/retriever_round.py --save)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import loader, ops
    from repro_torch.kernels import selective_scan as ss

    out = REPO / args.out_dir
    out.mkdir(parents=True, exist_ok=True)
    print(cs._card_line(), flush=True)
    libs = build(loader, out, args.groups, args.baseline)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q, d, m, c, k, n = 256, 128, 32, 256, 128, 1_000_000
    queries = torch.randn(q, d, generator=g, device=dev)
    cents = torch.randn(m, c, d // m, generator=g, device=dev)
    base = torch.randn(n, d, generator=g, device=dev)
    ids = torch.randint(0, n, (q, k), generator=g, device=dev,
                        dtype=torch.int32)
    acc = torch.full((q, k), float("inf"), device=dev)
    gathered = base[ids.long()]
    masks = {x: torch.rand(q, k, generator=g, device=dev) < x
             for x in DENSITIES}
    flushes = {"write": cs._Flush(torch, dev)}
    if args.read_flush:
        flushes["read"] = _ReadFlush(torch, dev)

    wide = {}        # the wide kernel's cases: (queries, codebook, metric)
    for w, metric in ((64, "ip"), (64, "l2"), (8, "l2"), (16, "l2")):
        qw = torch.randn(q, m * w, generator=g, device=dev)
        wide[f"dsub{w}_{metric}"] = (
            torch.nn.functional.normalize(qw, dim=1),
            torch.randn(m, c, w, generator=g, device=dev), metric)

    # an IVF chunk: random codes, and two layouts of the same rows whose
    # ADT reads meet no shared-memory bank conflict — code (r % 32) + 32 *
    # (m % 8) puts the 32 rows of a warp in 32 banks; all-zero codes read
    # one address a subspace (a broadcast) — which bound what the random
    # codes' conflicts cost
    nlist, max_len, np_, nq_ivf = 64, 16864, 16, 124
    lengths = torch.randint(14000, max_len + 1, (nlist,), generator=g,
                            device=dev, dtype=torch.int32)
    probes = torch.randint(0, nlist, (nq_ivf, np_), generator=g, device=dev,
                           dtype=torch.int32)
    ivf_adts = torch.rand(nq_ivf * np_, m, c, generator=g, device=dev)
    slot = torch.arange(max_len, device=dev)[:, None]
    sub = torch.arange(m, device=dev)[None, :]
    list_codes = {
        "random": torch.randint(0, c, (nlist, max_len, m), generator=g,
                                device=dev, dtype=torch.uint8),
        "conflict_free": ((slot % 32 + 32 * (sub % 8)).to(torch.uint8)
                          .expand(nlist, max_len, m).contiguous()),
        "broadcast": torch.zeros((nlist, max_len, m), dtype=torch.uint8,
                                 device=dev),
    }

    def merge_cols(q_, l, n):
        """A lane's list (ascending, +inf tail with -1 ids) and n fresh
        candidates (30% stale: +inf, -1), with ties."""
        dl = torch.randint(0, 64, (q_, l), generator=g, device=dev).float()
        dl = dl.sort(dim=1).values
        tail = torch.arange(l, device=dev) >= torch.randint(
            l // 2, l + 1, (q_, 1), generator=g, device=dev)
        dl[tail] = float("inf")
        ids_ = torch.randint(0, 1 << 20, (q_, l), generator=g, device=dev,
                             dtype=torch.int32).masked_fill(tail, -1)
        acc_ = torch.rand(q_, l, generator=g, device=dev)
        ev = torch.rand(q_, l, generator=g, device=dev) < 0.5
        nd = torch.randint(0, 64, (q_, n), generator=g, device=dev).float()
        stale = torch.rand(q_, n, generator=g, device=dev) < 0.3
        nd[stale] = float("inf")
        n_ids = torch.randint(0, 1 << 20, (q_, n), generator=g, device=dev,
                              dtype=torch.int32).masked_fill(stale, -1)
        return ids_, dl, acc_, ev, n_ids, nd

    merge_args = {(q_, l, n): merge_cols(q_, l, n) for q_, l, n in MERGES}
    scan_args = {case: cs._scan_inputs(torch, dev, g, bsz, s, di, ds, nh,
                                       carried)
                 for case, (bsz, s, di, ds, nh, carried) in SCANS.items()}
    bwd_args = {}
    if "scan_bwd" in args.groups:
        for case, (bsz, s, carried, _) in SCAN_BWDS.items():
            a = cs._scan_inputs(torch, dev, g, bsz, s, 8192, 16, None,
                                carried)
            bwd_args[case] = a + [torch.randn(a[2].shape, generator=g,
                                              device=dev),
                                  torch.randn(a[5].shape, generator=g,
                                              device=dev)]
    wide_args = {}
    if "rerank_wide" in args.groups:
        for q_, k_, d_, n_ in WIDE:
            table = torch.nn.functional.normalize(
                torch.randn(n_, d_, generator=g, device=dev), dim=1)
            qw = torch.nn.functional.normalize(
                torch.randn(q_, d_, generator=g, device=dev), dim=1)
            idw = torch.randint(0, n_, (q_, k_), generator=g, device=dev,
                                dtype=torch.int32)
            accw = torch.rand(q_, k_, generator=g, device=dev)
            for x in WIDE_DENSITIES:
                mk = torch.rand(q_, k_, generator=g, device=dev) < x
                wide_args[f"D{d_}_masked_{x}"] = (
                    qw, torch.where(mk, idw, -1), table, accw, mk, "ip")
    round_calls = []
    if args.round and "rerank_wide" in args.groups:
        rd = torch.load(args.round, map_location=dev)
        round_calls = [(rd["queries"][qi], ids_, rd["base"], acc_, mk,
                        rd["metric"]) for qi, ids_, acc_, mk in rd["calls"]]
        wide_args["retriever_round"] = round_calls[rd["captured"]]

    def merge_symbol(tag, l, n):
        from repro_torch.kernels.bitonic_topk import WARP_ROW, merge_kernel

        fits = l + (1 << max(n - 1, 31).bit_length()) <= WARP_ROW
        if tag == "BITONIC_RANK_FROM0":
            return "rank_merge_kernel"
        if tag in ("BITONIC_RANK_FROM4096", "baseline"):
            # the warp merge wherever a warp holds the row; beyond, the
            # rank merge, or before it the block network
            return ("warp_merge_kernel" if fits else "rank_merge_kernel"
                    if tag != "baseline" else "block_sort_kernel")
        return merge_kernel(l, n)

    def cases(group, tag):
        """(case, kernel call, plain call, tolerances, kernel symbol)"""
        if group == "merge":
            for (q_, l, n), a in merge_args.items():
                yield (f"Q{q_}_L{l}_n{n}",
                       lambda a=a: ops.bitonic_merge_topl(*a),
                       lambda a=a: ops.bitonic_merge_topl_plain(*a), 0.0,
                       0.0, merge_symbol(tag, l, n))
            return
        if group == "rerank_wide":
            # "l2_rerank" names the warp kernel and the wide one alike
            for case, a in wide_args.items():
                yield (case, lambda a=a: ops.l2_rerank_masked(*a),
                       lambda a=a: ops.l2_rerank_masked_plain(*a), 1e-4,
                       1e-3, "l2_rerank")
            if round_calls:
                yield ("retriever_batch",
                       lambda: [ops.l2_rerank_masked(*a)
                                for a in round_calls],
                       lambda: [ops.l2_rerank_masked_plain(*a)
                                for a in round_calls], 1e-4, 1e-3,
                       ("l2_rerank", len(round_calls)))
            return
        if group == "scan_bwd":
            for case, a in bwd_args.items():
                yield (case, lambda a=a: ss.selective_scan_bwd_cuda(*a),
                       (lambda a=a: ss.selective_scan_bwd_plain(*a, 256))
                       if SCAN_BWDS[case][3] else None,
                       None, None,
                       ("selective_scan_bwd_kernel" if tag == "baseline"
                        else "scan_bwd_tiles", "selective_scan_bwd_reduce"))
            return
        if group == "scan":
            for case, a in scan_args.items():
                op = (ops.selective_scan_heads if a[1].dim() == 1
                      else ops.selective_scan)
                plain = (ss.selective_scan_heads_plain if a[1].dim() == 1
                         else ss.selective_scan_plain)
                yield (case, lambda a=a, op=op: op(*a, 256),
                       lambda a=a, plain=plain: plain(*a, 256), None, None,
                       "selective_scan_kernel" if tag == "baseline"
                       else "scan_lanes")
            return
        if group == "pq_adt":
            yield ("adt", lambda: ops.pq_adt(queries, cents),
                   lambda: ops.pq_adt_plain(queries, cents), 1e-4, 1e-4,
                   "pq_adt_kernel")
            return
        if group == "pq_lookup_lists":
            for case, lc in list_codes.items():
                a = (probes, lengths, lc, ivf_adts)
                yield (f"ivf_{case}", lambda a=a: ops.pq_lookup_lists(*a),
                       lambda a=a: ops.pq_lookup_lists_plain(*a), 1e-4, 1e-4,
                       "pq_lookup_lists_kernel")
            return
        if group == "pq_adt_wide":
            for case, a in wide.items():
                yield (case, lambda a=a: ops.pq_adt(*a),
                       lambda a=a: ops.pq_adt_plain(*a), 1e-4, 1e-4,
                       "pq_adt_wide_kernel")
            return
        for x, mk in masks.items():
            yield (f"masked_{x}",
                   lambda mk=mk: ops.l2_rerank_masked(queries, ids, base,
                                                      acc, mk),
                   lambda mk=mk: ops.l2_rerank_masked_plain(queries, ids,
                                                            base, acc, mk),
                   1e-4, 1e-3, "l2_rerank_kernel")
        yield ("pregathered", lambda: ops.l2_rerank(queries, gathered),
               lambda: ops.l2_rerank_plain(queries, gathered), 1e-4, 1e-3,
               "l2_rerank_kernel")

    plains = {}

    def plain_of(group, case, plain):
        """The plain version's result, computed once (the scan's loop takes
        seconds at these shapes)."""
        if (group, case) not in plains:
            plains[(group, case)] = plain()
        return plains[(group, case)]

    rows = []
    for rep in range(2):
        for (group, tag), lib in libs.items():
            name = GROUPS[group][0]
            loader._libs[name] = lib
            for case, kernel, plain, rtol, atol, symbol in cases(group, tag):
                got = kernel()
                torch.cuda.synchronize()
                errs = None
                if group not in ("scan", "scan_bwd"):
                    torch.testing.assert_close(got, plain(), rtol=rtol,
                                               atol=atol)
                    if group == "rerank_wide":      # two runs, the same bits
                        again = kernel()
                        if not all(map(torch.equal, got if isinstance(
                                got, list) else [got], again if isinstance(
                                again, list) else [again])):
                            raise AssertionError(f"{tag} {case}: reruns "
                                                 "differ")
                elif plain is not None:     # the bar: 1e-5 of each max
                    errs = [float((gt - w).abs().max()) / float(w.abs().max())
                            for gt, w in zip(got,
                                             plain_of(group, case, plain))]
                    if max(errs) > 1e-5:
                        print(f"{group} {tag} {case}: error over the bar "
                              f"{errs}", flush=True)
                for fname, flush in flushes.items():
                    ms, cupti = (_batch_ms(torch, cs, kernel, flush, *symbol)
                                 if isinstance(symbol, tuple)
                                 and isinstance(symbol[1], int) else
                                 cs._time_ms(torch, kernel, flush, symbol))
                    rows.append({"rep": rep, "kernel": group, "variant": tag,
                                 "case": case, "flush": fname, "ms": ms,
                                 "cupti_ms": cupti, "rel_errs": errs})
                    print(f"{group} {tag} {case} flush={fname}: ms={ms:.4f} "
                          f"cupti_ms={cupti:.4f}"
                          + (" err/max=" + ",".join(f"{e:.2e}" for e in errs)
                             if errs else ""), flush=True)
            loader._libs.pop(name)
    if "merge" in args.groups:
        # the library yardstick beside the merges: one stable sort of the
        # list and the fresh candidates' keys, and the four gathers of the
        # kept columns (chip_smoke.py's), CUDA events only
        for (q_, l, n), (ids_, dl, acc_, ev, n_ids, nd) in merge_args.items():
            cat = [torch.cat([ids_, n_ids], 1), torch.cat([dl, nd], 1),
                   torch.cat([acc_, torch.full_like(nd, float("inf"))], 1),
                   torch.cat([ev, torch.zeros_like(ev[:, :1]).expand(q_, n)],
                             1)]

            def sort_and_gathers(cat=cat, l=l):
                order = torch.sort(cat[1], dim=1, stable=True).indices[:, :l]
                return [t.gather(1, order) for t in cat]

            ms = cs._time_ms(torch, sort_and_gathers, flushes["write"])
            rows.append({"kernel": "merge", "variant": "library",
                         "case": f"Q{q_}_L{l}_n{n}", "flush": "write",
                         "ms": ms})
            print(f"merge library Q{q_}_L{l}_n{n} flush=write: ms={ms:.4f} "
                  "(torch.sort(stable=True) + 4 gathers)", flush=True)
    floor = {f: cs._time_ms(torch, lambda: torch.cuda._sleep(1), fl,
                            cs.SPIN_SYMBOL) for f, fl in flushes.items()}
    print(f"timing floor: {json.dumps(floor)}")
    (out / "variants.json").write_text(json.dumps(
        {"card": cs._card_line(), "rows": rows, "floor": floor}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
