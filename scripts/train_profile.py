#!/usr/bin/env python3
"""Where a StableLM-1.6B train step's device time goes, on one NVIDIA GPU.
Run from the repository root:

    python3 scripts/train_profile.py

Builds StableLM-1.6B at full width (bf16 weights from seed 0, remat per
block, TF32 off as in ``chip_smoke.py``'s train phase) and takes the smoke's
step: ``make_train_step`` with 2 microbatches over ``batch_for_step`` of
``DataConfig(seq_len=4097, global_batch=4, copy_period=16)``.  Two steps
warm up, one is timed by the host clock (ending in a synchronise), one runs
under ``torch.profiler``.  Prints the card's name and power limit, the
step's wall seconds, the device's busy share (kernel time over the
profiled wall time), and the aten ops by their kernels' device time (share
of the device total, calls); the tables go to
``results/train_profile.txt``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_profile: needs a CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.train.data import DataConfig, batch_for_step
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamW

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("stablelm-1.6b")
    model = build_model(cfg, device="cuda", q_chunk=4096)
    opt = AdamW(lr=1e-3, warmup_steps=5, total_steps=20)
    state, _ = init_train_state(model, opt)
    ts, _ = make_train_step(model, opt, microbatches=2)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=4097,
                      global_batch=4, copy_period=16)
    for step in range(2):
        state, m = ts(state, batch_for_step(dcfg, step))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = ts(state, batch_for_step(dcfg, 2))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = ts(state, batch_for_step(dcfg, 3))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    dev_us = sum(e.self_device_time_total for e in ev
                 if e.device_type == cuda and not e.is_user_annotation)
    ops = sorted((e for e in ev if e.device_type != cuda
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    rec = {"step_s": step_s, "profiled_wall_s": wall,
           "device_s": dev_us / 1e6,
           "device_busy_share": dev_us / (wall * 1e6),
           "ops": [{"op": e.key, "device_ms": e.self_device_time_total / 1e3,
                    "share": e.self_device_time_total / dev_us,
                    "calls": e.count} for e in ops[:20]]}
    print(f"step_s={step_s:.3f} profiled_wall_s={wall:.3f} "
          f"device_s={rec['device_s']:.3f} "
          f"device_busy_share={rec['device_busy_share']:.4f}")
    for o in rec["ops"]:
        print(f"  {o['op']:<40s} {o['device_ms']:10.1f} ms "
              f"{o['share']:.4f} of the device time, {o['calls']} calls")
    out = repo / "results"
    out.mkdir(exist_ok=True)
    (out / "train_profile.txt").write_text(
        json.dumps(rec, indent=1) + "\n"
        + ev.table(sort_by="self_device_time_total", row_limit=40))
    return 0


if __name__ == "__main__":
    sys.exit(main())
