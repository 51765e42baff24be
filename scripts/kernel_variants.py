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
trace's (1; 128, 64)) on the warp merge and the rank merge, and of the
step scan's forward at falcon-mamba-7b's and zamba2-1.2B's layer shapes:

    python3 scripts/kernel_variants.py [--out-dir results/kernel_variants]
                                       [--groups pq_adt l2_rerank ...]
                                       [--baseline DIR]

Each variant is the kernel source compiled with other values of its tile
macros (``PQ_ADT_QB``: queries per tile; ``PQ_ADT_WIDE_TQ`` and
``PQ_ADT_WIDE_D``: the wide kernel's queries a thread and dsub values
staged at a time; ``PQ_LOOKUP_LISTS_ROWS``: list rows a block scores for
one staged ADT; ``L2_RERANK_WINDOW`` and ``L2_RERANK_ROWS``: candidates
per warp and rows in flight; ``BITONIC_RANK_FROM``: the shortest list the
rank merge takes, 0 sending every merge to it and 4096 none a warp holds;
``SCAN_THREADS``, ``SCAN_UNROLL`` and ``SCAN_TILE``: the step scan's
threads a block, steps unrolled and steps staged at a time), checked
against the plain version, then timed the way ``chip_smoke.py`` times a
kernel (median of 30 launches, L2 flushed before each, CUDA events and the
kernel's own CUPTI duration).  The rerank runs at mask densities from none
to every row.  With ``--read-flush`` each timing is repeated after a flush
that reads 64 MiB instead of writing it, which leaves the L2 clean rather
than full of dirty lines.  ``--baseline DIR`` adds, to every group, the
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
}
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


def build(loader, out: Path, groups, baseline=None) -> dict:
    """Compile every variant of ``groups`` (and, from ``baseline``, the
    source of the same name as the variant "baseline"), in parallel;
    {(group, tag): CDLL}."""
    procs = {}
    for group in groups:
        name, variants = GROUPS[group]
        todo = [("_".join(f"{k}{v}" for k, v in m.items()) or "default", m,
                 loader._CSRC / f"{name}.cu") for m in variants]
        if baseline is not None:
            todo.append(("baseline", {}, Path(baseline) / f"{name}.cu"))
        for tag, macros, src in todo:
            so = out / f"lib{name}_{group}_{tag}.so"
            cmd = [loader._nvcc(), *loader.NVCC_FLAGS,
                   *(f"-D{k}={v}" for k, v in macros.items()), "-o", str(so),
                   str(src)]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default="results/kernel_variants")
    ap.add_argument("--read-flush", action="store_true")
    ap.add_argument("--groups", nargs="+", choices=sorted(GROUPS),
                    default=list(GROUPS))
    ap.add_argument("--baseline", default=None,
                    help="a directory of kernel sources to time as the "
                         "variant 'baseline'")
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
                if group == "scan":     # the bar: 1e-5 of each max
                    errs = []
                    for gt, w in zip(got, plain_of(group, case, plain)):
                        errs.append(float((gt - w).abs().max())
                                    / float(w.abs().max()))
                    if max(errs) > 1e-5:
                        print(f"{group} {tag} {case}: error over the bar "
                              f"{errs}", flush=True)
                else:
                    torch.testing.assert_close(got, plain(), rtol=rtol,
                                               atol=atol)
                for fname, flush in flushes.items():
                    ms, cupti = cs._time_ms(torch, kernel, flush, symbol)
                    rows.append({"rep": rep, "kernel": group, "variant": tag,
                                 "case": case, "flush": fname, "ms": ms,
                                 "cupti_ms": cupti, "rel_errs": errs})
                    print(f"{group} {tag} {case} flush={fname}: ms={ms:.4f} "
                          f"cupti_ms={cupti:.4f}"
                          + (f" y_h_err/max={errs[0]:.2e},{errs[1]:.2e}"
                             if errs else ""), flush=True)
            loader._libs.pop(name)
    floor = {f: cs._time_ms(torch, lambda: torch.cuda._sleep(1), fl,
                            cs.SPIN_SYMBOL) for f, fl in flushes.items()}
    print(f"timing floor: {json.dumps(floor)}")
    (out / "variants.json").write_text(json.dumps(
        {"card": cs._card_line(), "rows": rows, "floor": floor}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
