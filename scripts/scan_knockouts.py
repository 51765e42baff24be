#!/usr/bin/env python3
"""Where the step scan's kernels spend their time, on one NVIDIA GPU: copies
of a kernel with one part removed each, timed beside the kernel itself at
falcon-mamba-7b's layer shapes (B, S) = (2, 2,048) (the served prefill, and
a train microbatch's backward) and (8, 2,048), d_inner 8,192, state 16.
Run from the repository root:

    python3 scripts/scan_knockouts.py [--mode fwd|bwd] [--source DIR]
                                      [--out results/scan_knockouts.json]

``--mode fwd`` (the default) cuts the forward (``csrc/selective_scan.cu``),
``--mode bwd`` Mamba-1's backward (``csrc/selective_scan_bwd.cu``).
``--source DIR`` takes the kernel source from DIR (another commit's
``src/repro_torch/kernels/csrc``, unpacked with ``git archive``): the
backward's cuts are written for two designs, the first (tiles of 4 steps)
and the tiled one, and the script picks the table whose every text the
source holds.  The copies compute wrong results; they only say what each
part costs.  The forward's:

* ``no_exp``: the decay is dt * rate, a multiply, not ex2.approx;
* ``no_step_loads``: every step of a tile reads the tile's first (dt x,
  dt), so the decays are the same each step and the compiler hoists them:
  no per-step shared load of the channel's operands and no exps;
* ``no_fetch``: every tile loads the first tile's rows (L2 hits, not DRAM);
* ``no_steps``: the tile's steps are skipped; what is left is the loads,
  the staging, the barriers and the stores of y: the memory skeleton;
* ``trivial_steps``: each step reads its operands and stores one add, so
  the skeleton plus the shared-memory traffic of the steps.

The backward's (each design's own text, the same parts):

* ``no_exp``: every decay a multiply, not an exponential;
* ``no_reduce``: the sums of dB's and dC's terms over the block's channels
  take one channel's term (first design: the 64 serial shared-memory adds of
  ``reduce``; tiled: the warps' rows summed in shared memory);
* ``no_fetch``: every tile reads the first tile's dt, x, gy, B and C (L2
  hits, not DRAM);
* ``no_barriers``: no ``__syncthreads`` (the tiled design keeps the one
  that hands a staged tile over, so the copy cannot hang);
* ``no_channel_loads`` (tiled): every step of a tile reads its first
  step's dt, x and gy (dt + 1e-3 a step, so the decays still differ): no
  per-step shared loads of the channel's operands;
* ``no_lane_sums`` (tiled): no shuffles summing du and the decay's
  gradient over a channel's lanes.

Each copy is the kernel source with exact substitutions (the script fails
if the source no longer holds a text it replaces), built by ``nvcc`` as the
loader builds the kernel, loaded in the loader's place and timed as
``chip_smoke.py`` times a kernel (``_time_ms``: median of 30 launches, the
L2 flushed before each, CUDA events and CUPTI over the call's kernels), all
in turns, twice.  Prints the card's name and power limit first.
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
# mode -> [(the CUPTI names of a call's kernels, {knock-out: [(text,
# replacement), ...]}), ...]: one table for each design the script knows
KNOCKOUTS = {"fwd": [(("scan_lanes",), {
    "no_exp": [("const float decay = kHeads ? dec : ex2(dtv * rate[j]);",
                "const float decay = kHeads ? dec : dtv * rate[j];")],
    "no_step_loads": [("      Ops o{sud[tt][c], 0.f, sb[tt][g], sc[tt][g]};",
                       "      Ops o{sud[0][c], 0.f, sb[tt][g], sc[tt][g]};")],
    "no_fetch": [("    if (t0 + kTile < S) fetch(t0 + kTile);",
                  "    if (t0 + kTile < S) fetch(0);")],
    "no_steps": [(STEP_LOOP, "    sp[0][tid] = cur.ud.x;")],
    "trivial_steps": [(STEP_CALL, "      sp[tt][tid] = cur.ud.x + cur.bv.x "
                                  "* cur.cv.y;")],
})], "bwd": [(
    # the first design: register tiles of 4 steps
    ("selective_scan_bwd_kernel", "selective_scan_bwd_reduce"), {
    "no_exp": [
        ("kHeads ? head_decay : expf(dtv * rate[kHeads ? 0 : j]);",
         "kHeads ? head_decay : dtv * rate[kHeads ? 0 : j];"),
        ("kHeads ? head_decay : expf(dl[tt] * rate[kHeads ? 0 : j]);",
         "kHeads ? head_decay : dl[tt] * rate[kHeads ? 0 : j];")],
    "no_reduce": [
        ("for (int ch = 0; ch < kCPB; ++ch) acc += src[ch * kG * kRed];",
         "acc = src[0];")],
    "no_fetch": [
        ("      const bool in = live && tt < nt;\n"
         "      const size_t r = ((size_t)b * S + t0 + tt) * DI + d;",
         "      const bool in = live && tt < nt;\n"
         "      const size_t r = ((size_t)b * S + tt) * DI + d;"),
        ("const size_t r = ((size_t)b * S + t0 + tt) * DS + s;",
         "const size_t r = ((size_t)b * S + tt) * DS + s;")],
    "no_barriers": [
        ("    __syncthreads();                       // the last tile is "
         "consumed", ""),
        ("    __syncthreads();\n  };\n  // the block's sums", "  };\n  // the "
         "block's sums"),
        ("  auto reduce = [&](float* out, int t0, int nt) {\n"
         "    __syncthreads();",
         "  auto reduce = [&](float* out, int t0, int nt) {"),
        ("      __syncthreads();                     // red is read", "")],
}), (
    # the tiled design (scan_bwd_tiles_kernel)
    ("scan_bwd_tiles", "selective_scan_bwd_reduce"), {
    "no_exp": [
        ("  return 0.5f * ex2(fmaf(dtv, r2, 1.f));",
         "  return 0.5f * fmaf(dtv, r2, 1.f);")],
    "no_reduce": [
        ("// dC's term\n        }\n        channel_sum<kG>(v, lane);",
         "// dC's term\n        }"),
        ("ddt[r] = fmaf(du, xv, gdec);\n        }\n        "
         "channel_sum<kG>(v, lane);", "ddt[r] = fmaf(du, xv, gdec);\n        }"),
        ("for (int q = 0; q < kWarps; ++q) acc += src[q * kR * kDS];",
         "acc = src[0];")],
    "no_fetch": [("    const int t0 = c * kC;\n    const int v = vec",
                  "    const int t0 = 0;\n    const int v = vec")],
    "no_barriers": [
        ("      __syncthreads();                      // the tile's warp rows "
         "are in", "")],
    "no_channel_loads": [
        ("    const float dtv = sm.dt[tt * kCPB + ch];\n"
         "    const float u = dtv * sm.x[tt * kCPB + ch];",
         "    const float dtv = sm.dt[ch] + 1e-3f * tt;\n"
         "    const float u = dtv * sm.x[ch];"),
        ("        const float dtv = sm.dt[k * kCPB + ch];\n"
         "        const float u = dtv * sm.x[k * kCPB + ch];\n"
         "        const float gyv = sm.gy[k * kCPB + ch];",
         "        const float dtv = sm.dt[sub * kR * kCPB + ch] + 1e-3f * tt;\n"
         "        const float u = dtv * sm.x[sub * kR * kCPB + ch];\n"
         "        const float gyv = sm.gy[sub * kR * kCPB + ch];"),
        ("        const float dtv = sm.dt[k * kCPB + ch];\n"
         "        const float xv = sm.x[k * kCPB + ch];\n"
         "        const float gyv = sm.gy[k * kCPB + ch];",
         "        const float dtv = sm.dt[sub * kR * kCPB + ch] + 1e-3f * tt;\n"
         "        const float xv = sm.x[sub * kR * kCPB + ch];\n"
         "        const float gyv = sm.gy[sub * kR * kCPB + ch];")],
    "no_lane_sums": [
        ("        for (int off = kG / 2; off > 0; off /= 2) {\n"
         "          du += __shfl_xor_sync(kFull, du, off);\n"
         "          gdec += __shfl_xor_sync(kFull, gdec, off);\n"
         "        }", "")],
})]}


def knockouts(mode: str, src: str) -> tuple:
    """(symbols, cuts): the table of ``mode`` whose every text ``src``
    holds once."""
    for symbols, table in KNOCKOUTS[mode]:
        if all(src.count(old) == 1 for subs in table.values()
               for old, _ in subs):
            return symbols, table
    raise SystemExit(f"no knock-out table of mode {mode!r} fits the source: "
                     "a text it replaces is missing or not unique")


def build(loader, out: Path, mode: str, src_dir: Path) -> tuple:
    """The kernel and each knock-out, built in parallel: ({name: CDLL},
    the CUPTI names of a call's kernels)."""
    lib_name = "selective_scan" if mode == "fwd" else "selective_scan_bwd"
    src = (src_dir / f"{lib_name}.cu").read_text()
    sources = {"kernel": src}
    symbols, table = knockouts(mode, src)
    for name, subs in table.items():
        text = src
        for old, new in subs:
            text = text.replace(old, new)
        sources[name] = text
    procs = {}
    for name, text in sources.items():
        cu, so = out / f"{mode}_{name}.cu", out / f"lib{mode}_{name}.so"
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
    return libs, symbols


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("fwd", "bwd"), default="fwd")
    ap.add_argument("--source", default=None,
                    help="a directory of kernel sources to cut instead of "
                         "the repository's")
    ap.add_argument("--out", default="results/scan_knockouts.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("scan_knockouts: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import loader, ops
    from repro_torch.kernels import selective_scan as ss

    print(cs._card_line(), flush=True)
    work = REPO / "results" / "scan_knockouts"
    work.mkdir(parents=True, exist_ok=True)
    src_dir = Path(args.source) if args.source else loader._CSRC
    libs, symbols = build(loader, work, args.mode, src_dir)
    lib_name = ("selective_scan" if args.mode == "fwd"
                else "selective_scan_bwd")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = cs._Flush(torch, dev)
    rows = []
    for bsz, s in SHAPES:
        scan = [torch.nn.functional.softplus(
            torch.randn(bsz, s, DI, generator=g, device=dev) - 1.0),
            -torch.exp(torch.randn(DI, DS, generator=g, device=dev)),
            *(torch.randn(sh, generator=g, device=dev)
              for sh in ((bsz, s, DI), (bsz, s, DS), (bsz, s, DS),
                         (bsz, DI, DS)))]
        if args.mode == "fwd":
            def call():
                return ops.selective_scan(*scan, 256)
        else:
            scan += [torch.randn(sh, generator=g, device=dev)
                     for sh in ((bsz, s, DI), (bsz, DI, DS))]

            def call():
                return ss.selective_scan_bwd_cuda(*scan)
        for rep in range(2):
            for name, lib in libs.items():
                loader._libs[lib_name] = lib
                ms, cupti = cs._time_ms(torch, call, flush, symbols)
                rows.append({"shape": [bsz, s], "rep": rep, "copy": name,
                             "ms": ms, "cupti_ms": cupti})
                print(f"{args.mode} ({bsz}, {s}) {name}: ms={ms:.4f} "
                      f"cupti_ms={cupti:.4f}", flush=True)
    loader._libs.pop(lib_name, None)
    out = REPO / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": cs._card_line(), "mode": args.mode,
                               "source": str(src_dir), "rows": rows},
                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
