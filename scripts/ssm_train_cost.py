#!/usr/bin/env python3
"""What the position-at-a-time backward of the selective scan cost a
zamba2-1.2B train step on one NVIDIA GPU, beside the backward kernel, for
the record (the twin of ``scripts/ssm_loop_cost.py``).  Run from the
repository root:

    python3 scripts/ssm_train_cost.py

Builds zamba2-1.2B at published width and depth (bf16 weights from seed
0) with the launcher's model, optimizer and step (``launch.train``:
AdamW, 2 microbatches, remat per block) and one step-seeded batch of
``chip_smoke.py``'s train shape (4 x 4,096 tokens), then takes train
steps with the scan's gradient on the backward kernel and on the plain
backward (``kernels.selective_scan``'s loop over positions rerun under
autograd, what the port ran before the kernel), in turns: kernel, loop,
kernel, after one untimed kernel step.  The forward is the kernel in both.
Prints the card's name and power limit, then each step's ms (host clock
ending in a synchronise) and peak device memory, and the loop's ms over
the kernel's.  A loop step that runs out of device memory is recorded with
the backward calls it finished, the peak, and the error (the step never
reached the optimizer, so the state is unchanged).  The loop is
never on a path of the port: the script swaps it in for its own calls.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ARCH = "zamba2-1.2b"
SEQ = 4097                       # train_4k's 4,096 tokens + 1 for labels
BATCH = 4                        # chip_smoke.py's TRAIN_BATCH
MICROBATCHES = 2


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssm_train_cost: needs a CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import loader, ops
    from repro_torch.kernels import selective_scan as scan
    from repro_torch.models.model import build_model
    from repro_torch.train.data import (
        DataConfig, batch_for_step, device_put_batch)
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamW

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    done = [0]

    def loop_grad(op, plain_bwd):
        """``op``'s kernel forward with ``plain_bwd`` as its gradient."""

        class Scan(torch.autograd.Function):
            @staticmethod
            def forward(ctx, dt, a, x, b, c, h0, chunk):
                ctx.save_for_backward(dt, a, x, b, c, h0)
                ctx.chunk = chunk
                with torch.no_grad():
                    return op(dt, a, x, b, c, h0, chunk)

            @staticmethod
            def backward(ctx, gy, gh):
                dt, a, x, b, c, h0 = ctx.saved_tensors
                gy = torch.zeros_like(x) if gy is None else gy
                gh = torch.zeros_like(h0) if gh is None else gh
                grads = plain_bwd(dt, a, x, b, c, h0, gy, gh, ctx.chunk)
                done[0] += 1
                return (*grads, None)

        return Scan.apply

    kernel_ops = (ops.scan_op, ops.scan_heads_op)
    loop_ops = (loop_grad(ops.scan_op, scan.selective_scan_bwd_plain),
                loop_grad(ops.scan_heads_op,
                          scan.selective_scan_heads_bwd_plain))

    def use(pair):
        ops.scan_op, ops.scan_heads_op = pair

    cfg = get_config(ARCH)
    model = build_model(cfg, device="cuda", q_chunk=max(SEQ - 1, 64))
    opt = AdamW(lr=1e-3, warmup_steps=5, total_steps=20)
    state, _ = init_train_state(model, opt)
    step, _ = make_train_step(model, opt, microbatches=MICROBATCHES)
    batch = device_put_batch(batch_for_step(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
        copy_period=16, family=cfg.family), 0), model.device)
    n_ssm = sum(k in ("mamba1", "mamba2") for k in cfg.block_pattern())
    state_box = [state]

    def one_step():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        loader.reset_launch_counts()
        done[0] = 0
        t = time.perf_counter()
        state_box[0], m = step(state_box[0], batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        return {"ms": (time.perf_counter() - t) * 1e3,
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "loss": loss,
                "kernel_backward_launches":     # either route's
                    loader.MODEL_LAUNCHES["selective_scan_bwd"]
                    + loader.MODEL_LAUNCHES["selective_scan_ssd_bwd"],
                "loop_backward_calls": done[0]}

    runs = {"kernel": [], "loop": []}
    try:
        use(kernel_ops)
        one_step()                                   # untimed
        for name in ("kernel", "loop", "kernel"):
            use(kernel_ops if name == "kernel" else loop_ops)
            try:
                rec = one_step()
            except torch.cuda.OutOfMemoryError as e:
                rec = {"oom": True, "loop_backward_calls": done[0],
                       "of_backward_calls": n_ssm * MICROBATCHES,
                       "peak_bytes": torch.cuda.max_memory_allocated(),
                       "error": str(e)[:400]}
                print(f"{name} step ran out of memory: {json.dumps(rec)}",
                      flush=True)
                runs[name].append(rec)
                continue
            runs[name].append(rec)
            print(f"{name} step: {json.dumps(rec)}", flush=True)
    finally:
        use(kernel_ops)
    out = {"arch": cfg.name, "tokens_a_step": BATCH * (SEQ - 1),
           "microbatches": MICROBATCHES, "ssm_layers": n_ssm, **runs}
    ok_loop = [r["ms"] for r in runs["loop"] if "ms" in r]
    if ok_loop and runs["kernel"]:
        out["loop_over_kernel"] = min(ok_loop) / min(
            r["ms"] for r in runs["kernel"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
