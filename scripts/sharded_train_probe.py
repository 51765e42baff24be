#!/usr/bin/env python3
"""The smoke's sharded-training parts alone, on one NVIDIA GPU (~4 min).
Run from the repository root:

    python3 scripts/sharded_train_probe.py

Starts ``chip_smoke.py``'s dry-run processes (StableLM-1.6B train_4k on
the (16, 16) and (2, 16, 16) production meshes, and the train phase's own
cell on a (1, 1) mesh; fake tensors on the host), runs the train phase's
``train_full`` (20 unsharded steps of StableLM-1.6B) and ``train_sharded``
(3 sharded steps on a (1, 1) NCCL mesh), reads the dry-run's records and
applies the smoke's checks on them.  Prints what those functions print,
the failures (an empty list when all hold) and the seconds; the records go
to ``results/sharded_train_probe/``.  Exits 1 on a failure.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def main() -> int:
    repo = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo))
    sys.path.insert(0, str(repo / "src"))
    import torch

    import chip_smoke as C

    if not torch.cuda.is_available():
        print("sharded_train_probe: no CUDA device", file=sys.stderr)
        return 2
    out_dir = repo / "results" / "sharded_train_probe"
    out_dir.mkdir(parents=True, exist_ok=True)

    def log(msg):
        print(msg, flush=True)

    log(C._card_line())
    t0 = time.perf_counter()
    procs = C.start_dryrun(repo, out_dir)
    dev = torch.device("cuda")
    full = C.train_full(torch, dev, log)
    sharded = C.train_sharded(torch, dev, out_dir, full, log)
    dryrun = C.finish_dryrun(procs, out_dir, sharded, full, log)
    # the smoke's train checks on these parts (the others did not run)
    fails = [f for f in C.train_failures({
        "zoo": {}, "full": full, "sharded": sharded, "dryrun": dryrun,
        "fault": {"restarts": 1, "final_step": C.FAULT_STEPS,
                  "restore_bit_equal": True, "restore_step": C.FAULT_STEPS,
                  "replay_max_rel_err": 0.0,
                  "elastic": {"all_dtensor": True,
                              "placements_follow_specs": True,
                              "full_equal": True, "step": C.FAULT_STEPS}}})]
    (out_dir / "probe.json").write_text(json.dumps(
        {"full": {k: full[k] for k in ("losses", "step_ms_median",
                                       "peak_bytes",
                                       "model_flops_per_step")},
         "sharded": sharded, "dryrun": dryrun, "failures": fails},
        indent=1))
    log(f"failures: {fails}")
    log(f"seconds: {time.perf_counter() - t0:.1f}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
