#!/usr/bin/env python3
"""Where the step scan's forward (``csrc/selective_scan.cu``) spends its
time, on one NVIDIA GPU: copies of the kernel with one part removed each,
timed beside the kernel itself at falcon-mamba-7b's layer shapes (B, S) =
(2, 2,048) (the served prefill) and (8, 2,048), d_inner 8,192, state 16.
Run from the repository root:

    python3 scripts/scan_knockouts.py [--out results/scan_knockouts.json]

The copies compute wrong results; they only say what each part costs:

* ``no_exp``: the decay is dt * rate, a multiply, not ex2.approx;
* ``no_step_loads``: every step of a tile reads the tile's first (dt x,
  dt), so the decays are the same each step and the compiler hoists them:
  no per-step shared load of the channel's operands and no exps;
* ``no_fetch``: every tile loads the first tile's rows (L2 hits, not DRAM);
* ``no_steps``: the tile's steps are skipped; what is left is the loads,
  the staging, the barriers and the stores of y: the memory skeleton;
* ``trivial_steps``: each step reads its operands and stores one add, so
  the skeleton plus the shared-memory traffic of the steps.

Each copy is the kernel source with one exact substitution (the script
fails if the source no longer holds the text it replaces), built by
``nvcc`` as the loader builds the kernel, loaded in the loader's place and
timed as ``chip_smoke.py`` times a kernel (``_time_ms``: median of 30
launches, the L2 flushed before each, CUDA events and CUPTI), all in
turns, twice.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHAPES = ((2, 2048), (8, 2048))
DI, DS = 8192, 16
STEP_CALL = ("      sp[tt][tid] = step<kHeads>(h, rate, cur.ud.x, cur.ud.y, "
             "cur.dec,\n                                 cur.bv, cur.cv);")
STEP_LOOP = """    if (nt == kTile) {
#pragma unroll kUnroll
      for (int tt = 0; tt < kTile; ++tt) one(tt);
    } else {
      for (int tt = 0; tt < nt; ++tt) one(tt);
    }"""
KNOCKOUTS = {
    "no_exp": ("const float decay = kHeads ? dec : ex2(dtv * rate[j]);",
               "const float decay = kHeads ? dec : dtv * rate[j];"),
    "no_step_loads": ("      Ops o{sud[tt][c], 0.f, sb[tt][g], sc[tt][g]};",
                      "      Ops o{sud[0][c], 0.f, sb[tt][g], sc[tt][g]};"),
    "no_fetch": ("    if (t0 + kTile < S) fetch(t0 + kTile);",
                 "    if (t0 + kTile < S) fetch(0);"),
    "no_steps": (STEP_LOOP, "    sp[0][tid] = cur.ud.x;"),
    "trivial_steps": (STEP_CALL,
                      "      sp[tt][tid] = cur.ud.x + cur.bv.x * cur.cv.y;"),
}


def build(loader, out: Path) -> dict:
    """The kernel and each knock-out, built in parallel; {name: CDLL}."""
    src = (loader._CSRC / "selective_scan.cu").read_text()
    sources = {"kernel": src}
    for name, (old, new) in KNOCKOUTS.items():
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the kernel source no longer holds "
                             f"{old!r} once")
        sources[name] = src.replace(old, new)
    procs = {}
    for name, text in sources.items():
        cu, so = out / f"scan_{name}.cu", out / f"libscan_{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [loader._nvcc(), *loader.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="results/scan_knockouts.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("scan_knockouts: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import loader, ops

    print(cs._card_line(), flush=True)
    work = REPO / "results" / "scan_knockouts"
    work.mkdir(parents=True, exist_ok=True)
    libs = build(loader, work)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = cs._Flush(torch, dev)
    rows = []
    for bsz, s in SHAPES:
        scan = (torch.nn.functional.softplus(
            torch.randn(bsz, s, DI, generator=g, device=dev) - 1.0),
            -torch.exp(torch.randn(DI, DS, generator=g, device=dev)),
            *(torch.randn(sh, generator=g, device=dev)
              for sh in ((bsz, s, DI), (bsz, s, DS), (bsz, s, DS),
                         (bsz, DI, DS))))
        for rep in range(2):
            for name, lib in libs.items():
                loader._libs["selective_scan"] = lib
                ms, cupti = cs._time_ms(
                    torch, lambda: ops.selective_scan(*scan, 256), flush,
                    "scan_lanes")
                rows.append({"shape": [bsz, s], "rep": rep, "copy": name,
                             "ms": ms, "cupti_ms": cupti})
                print(f"({bsz}, {s}) {name}: ms={ms:.4f} "
                      f"cupti_ms={cupti:.4f}", flush=True)
    loader._libs.pop("selective_scan", None)
    out = REPO / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": cs._card_line(), "rows": rows},
                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
