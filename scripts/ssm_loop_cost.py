#!/usr/bin/env python3
"""What the position-at-a-time scan cost the SSM models on one NVIDIA GPU,
beside the scan kernel, for the record.  Run from the repository root:

    python3 scripts/ssm_loop_cost.py

Builds zamba2-1.2B and falcon-mamba-7b at published width and depth (bf16
weights from seed 0, as ``chip_smoke.py``'s SSM phase) and prefills their
smoke requests (8 and 2 prompts of 2,048 tokens, ``prefill_chunked`` in
one segment) with the scan on the kernel and with it on the plain version
(``kernels.selective_scan``'s loop over positions, what the models ran
before the kernel), in turns: kernel, loop, loop, kernel, after one
untimed prefill of each.  Prints the card's name and power limit, then
each prefill's ms (host clock ending in a synchronise) and peak device
memory, and the loop's ms over the kernel's.  The loop is never on a
path of the port: the script swaps it in for its own calls.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

CELLS = (("zamba2-1.2b", 8), ("falcon-mamba-7b", 2))
PROMPT = 2048


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssm_loop_cost: needs a CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as scan
    from repro_torch.models.model import build_model

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernel_ops = (ops.scan_op, ops.scan_heads_op)
    loop_ops = (scan.selective_scan_plain, scan.selective_scan_heads_plain)

    def use(pair):
        ops.scan_op, ops.scan_heads_op = pair

    out = {}
    try:
        for arch, requests in CELLS:
            model = build_model(get_config(arch), device="cuda",
                                generator=torch.Generator(
                                    device="cuda").manual_seed(0))
            toks = torch.randint(0, model.config.vocab_size,
                                 (requests, PROMPT), device="cuda",
                                 generator=torch.Generator(
                                     device="cuda").manual_seed(1))

            def prefill():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                model.prefill_chunked({"tokens": toks}, seg_len=PROMPT)
                torch.cuda.synchronize()
                return ((time.perf_counter() - t) * 1e3,
                        torch.cuda.max_memory_allocated())

            runs = {"kernel": [], "loop": []}
            for name, pair in (("kernel", kernel_ops), ("loop", loop_ops)):
                use(pair)
                prefill()                               # untimed
            for name in ("kernel", "loop", "loop", "kernel"):
                use(kernel_ops if name == "kernel" else loop_ops)
                runs[name].append(prefill())
            use(kernel_ops)
            rec = {k: {"prefill_ms": [r[0] for r in v],
                       "peak_bytes": [r[1] for r in v]}
                   for k, v in runs.items()}
            rec["loop_over_kernel"] = (min(rec["loop"]["prefill_ms"])
                                       / min(rec["kernel"]["prefill_ms"]))
            out[arch] = rec
            print(f"{arch}: {requests} x {PROMPT} tokens, prefill_chunked: "
                  f"{json.dumps(rec)}", flush=True)
            del model
            torch.cuda.empty_cache()
    finally:
        use(kernel_ops)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
