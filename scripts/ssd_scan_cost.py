#!/usr/bin/env python3
"""The Mamba-2 selective scan on its two kernel routes, at zamba2-1.2B's
layer shapes, on one NVIDIA GPU: the step kernels (``csrc/selective_scan.cu``
and ``csrc/selective_scan_bwd.cu``, a position at a time) against the SSD
kernels (``csrc/selective_scan_ssd.cu``, the chunked matrix form on the
tensor cores) on the same inputs.  Run from the repository root:

    python3 scripts/ssd_scan_cost.py [--reps 30]

For the forward at (B, S) = (8, 2,048) (the prefill) and (2, 4,096) (the
train microbatch), the backward at (2, 4,096), and both at B = 8 and the
short S of SHORT (short prompts, a chunked prefill's last segment: where
``ssd_route``'s boundaries are set, the forward's S > 1 and the backward's
SSD_BWD_MIN_STEPS), d_inner 4,096, 64 heads of 64, state 64, inputs drawn
as ``chip_smoke.py`` draws them: each route's launcher
(``_heads_step_cuda`` / ``_heads_ssd_cuda``, ``_bwd_step_cuda`` /
``_ssd_bwd_cuda``, whatever ``ssd_route`` would pick) timed in turns (step,
SSD, SSD, step) as ``chip_smoke.py`` times a kernel (``_time_ms``: the L2
flushed and the launch queued behind a spin; CUDA events and CUPTI device
time) and the SSD route's time over the step route's (the best of each),
the SSD backward's three kernels apart (CUPTI), the two routes' largest
difference over the larger output's (gradient's) largest magnitude, and the
SSD kernels' registers and spills from ptxas.  Prints the card's name and
power limit first and writes the record to
``chiprun_out/ssd_scan_cost.json``.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ZAMBA2 = dict(di=4096, ds=64, nh=64)
SHORT = (2, 8, 16, 20, 32, 64, 128)
CASES = (("forward, zamba2 prefill (8, 2048)", False, 8, 2048),
         ("forward, zamba2 train microbatch (2, 4096)", False, 2, 4096),
         ("backward, zamba2 train microbatch (2, 4096)", True, 2, 4096),
         *((f"forward, short (8, {s})", False, 8, s) for s in SHORT),
         *((f"backward, short (8, {s})", True, 8, s) for s in SHORT))
SYMBOLS = {(False, "step"): "scan_lanes",
           (False, "ssd"): ("ssd_gram", "ssd_chunk_scan")}


def _kernel_names(torch, fn) -> list:
    """The device kernels one call of ``fn`` launches, by profiler name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sorted({e.name for e in prof.events() if e.device_type == cuda})


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=30)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ssd_scan_cost: needs a CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo / "src"))
    sys.path.insert(0, str(repo))
    import chip_smoke as cs
    from repro_torch.kernels import loader
    from repro_torch.kernels import selective_scan as ss

    card = cs._card_line()
    print(card, flush=True)
    reports = loader.build_all()
    ptxas = [line.strip() for line in
             reports.get("selective_scan_ssd", "").splitlines()
             if re.search(r"Compiling entry|Used \d+ registers|spill", line)]
    print(f"ptxas (selective_scan_ssd): {json.dumps(ptxas)}", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = cs._Flush(torch, dev)
    out = {"card": card, "reps": args.reps, "ptxas": ptxas, "cases": []}
    for label, bwd, bsz, s in CASES:
        inputs = cs._scan_inputs(torch, dev, g, bsz, s, **ZAMBA2)
        if bwd:
            gy = torch.randn(inputs[2].shape, generator=g, device=dev)
            gh = torch.randn(inputs[5].shape, generator=g, device=dev)

            def call(route, inputs=inputs, gy=gy, gh=gh):
                operands = ss._bwd_operands("selective_scan_heads_bwd",
                                            *inputs, gy, gh, heads=True)
                if route == "ssd":
                    return ss._ssd_bwd_cuda(*operands)
                return ss._bwd_step_cuda(*operands, heads=True)
        else:
            def call(route, inputs=inputs):
                launch = (ss._heads_ssd_cuda if route == "ssd"
                          else ss._heads_step_cuda)
                return launch(*ss._operands("selective_scan_heads", *inputs,
                                            heads=True))

        got = {r: call(r) for r in ("step", "ssd")}
        torch.cuda.synchronize()
        diff = max(float((p - q).abs().max())
                   / max(float(p.abs().max()), float(q.abs().max()), 1e-30)
                   for p, q in zip(got["step"], got["ssd"]))
        del got
        rec = {"case": label, "B": bsz, "S": s, **ZAMBA2,
               "routes_diff_of_scale": diff, "step": [], "ssd": [],
               "kernel_names": {r: _kernel_names(torch, lambda: call(r))
                                for r in ("step", "ssd")}}
        print(f"{label}: routes differ by {diff:.3g} of the largest "
              f"magnitude; kernels {json.dumps(rec['kernel_names'])}",
              flush=True)
        for route in ("step", "ssd", "ssd", "step"):
            symbol = (cs.SCAN_BWD_SYMBOLS[route] if bwd
                      else SYMBOLS[(False, route)])
            ms, cupti = cs._time_ms(torch, lambda: call(route), flush,
                                    symbol, reps=args.reps)
            rec[route].append({"ms": ms, "cupti_ms": cupti})
        rec["ssd_over_step"] = {
            k: (min(r[k] for r in rec["ssd"])
                / min(r[k] for r in rec["step"])) for k in ("ms", "cupti_ms")}
        if bwd:                       # the SSD backward's kernels apart
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.reps):
                    call("ssd")
                torch.cuda.synchronize()
            rec["ssd_kernels_cupti_ms"] = {
                sym: cs._cupti_ms(torch, prof, sym, args.reps)
                for sym in cs.SCAN_BWD_SYMBOLS["ssd"]}
        out["cases"].append(rec)
        print(json.dumps(rec), flush=True)
        del inputs
        torch.cuda.empty_cache()
    path = repo / "chiprun_out" / "ssd_scan_cost.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
