#!/usr/bin/env python3
"""Time the tile choices of the redesigned ``pq_adt`` and ``l2_rerank``
kernels on one NVIDIA GPU, at the search's shapes (Q=256, M=32, C=256,
dsub=4; K=128, D=128, a 1M-row base), of ``pq_adt``'s wide kernel at
the image retriever's (Q=256, D=2048) x (32, 256, 64) and at dsub 8 and 16,
and of ``pq_lookup``'s lists entry at an IVF-PQ chunk's shape (124 queries
x nprobe 16 over 64 lists of up to 16,864 rows, M=32, C=256):

    python3 scripts/kernel_variants.py [--out-dir results/kernel_variants]
                                       [--groups pq_adt l2_rerank ...]

Each variant is the kernel source compiled with other values of its tile
macros (``PQ_ADT_QB``: queries per tile; ``PQ_ADT_WIDE_TQ`` and
``PQ_ADT_WIDE_D``: the wide kernel's queries a thread and dsub values
staged at a time; ``PQ_LOOKUP_LISTS_ROWS``: list rows a block scores for
one staged ADT; ``L2_RERANK_WINDOW`` and ``L2_RERANK_ROWS``: candidates
per warp and rows in flight), checked
against the plain version, then timed the way ``chip_smoke.py`` times a
kernel (median of 30 launches, L2 flushed before each, CUDA events and the
kernel's own CUPTI duration).  The rerank runs at mask densities from none
to every row.  With ``--read-flush`` each timing is repeated after a flush
that reads 64 MiB instead of writing it, which leaves the L2 clean rather
than full of dirty lines.  Variants run in turns, twice.  Prints one line
per (variant, case) and writes ``variants.json`` to the output directory.
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
}
DENSITIES = (0.0, 0.005, 0.09, 0.34, 1.0)


def build(loader, out: Path, groups) -> dict:
    """Compile every variant of ``groups``, in parallel; {(group, macros):
    CDLL}."""
    procs = {}
    for group in groups:
        name, variants = GROUPS[group]
        for macros in variants:
            tag = "_".join(f"{k}{v}" for k, v in macros.items())
            so = out / f"lib{name}_{tag}.so"
            cmd = [loader._nvcc(), *loader.NVCC_FLAGS,
                   *(f"-D{k}={v}" for k, v in macros.items()), "-o", str(so),
                   str(loader._CSRC / f"{name}.cu")]
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
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import loader, ops

    out = REPO / args.out_dir
    out.mkdir(parents=True, exist_ok=True)
    print(cs._card_line(), flush=True)
    libs = build(loader, out, args.groups)

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

    def cases(group):
        """(case, kernel call, plain call, tolerances, kernel symbol)"""
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

    rows = []
    for rep in range(2):
        for (group, tag), lib in libs.items():
            name = GROUPS[group][0]
            loader._libs[name] = lib
            for case, kernel, plain, rtol, atol, symbol in cases(group):
                got = kernel()
                torch.cuda.synchronize()
                torch.testing.assert_close(got, plain(), rtol=rtol,
                                           atol=atol)
                for fname, flush in flushes.items():
                    ms, cupti = cs._time_ms(torch, kernel, flush, symbol)
                    rows.append({"rep": rep, "kernel": group, "variant": tag,
                                 "case": case, "flush": fname, "ms": ms,
                                 "cupti_ms": cupti})
                    print(f"{group} {tag} {case} flush={fname}: ms={ms:.4f} "
                          f"cupti_ms={cupti:.4f}", flush=True)
            loader._libs.pop(name)
    floor = {f: cs._time_ms(torch, lambda: torch.cuda._sleep(1), fl,
                            cs.SPIN_SYMBOL) for f, fl in flushes.items()}
    print(f"timing floor: {json.dumps(floor)}")
    (out / "variants.json").write_text(json.dumps(
        {"card": cs._card_line(), "rows": rows, "floor": floor}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
