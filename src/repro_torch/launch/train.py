"""Training launcher: fault-tolerant LM training on synthetic data — port
of ``src/repro/launch/train.py`` (lines 1-115), with the same flags and
printed lines, plus ``--device`` (default ``cuda``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch stablelm-1.6b --smoke --steps 100 --batch 8 --seq 129 \\
        --ckpt-dir /tmp/ckpt [--device cpu]

``--smoke`` uses the reduced config (CPU-feasible); omit it on a card to
train the full architecture.  ``--params-millions`` builds a custom-width
dense model instead (e.g. 100 for the ~100M example).  ``train`` is the
launcher's path as a function (``chip_smoke.py`` drives it).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.fault import FaultConfig, FaultTolerantLoop
from repro_torch.models.model import build_model
from repro_torch.train.data import DataConfig, batch_for_step, device_put_batch
from repro_torch.train.loop import init_train_state, make_train_step
from repro_torch.train.optimizer import AdamW


def custom_dense_config(params_millions: float, vocab: int = 32768) -> ModelConfig:
    """A dense config sized to roughly the requested parameter count."""
    # params ~ 12 L d^2 + 2 V d ; fix L = max(8, d/64), solve d numerically
    target = params_millions * 1e6
    d = 256
    while True:
        L = max(8, d // 64)
        n = 12 * L * d * d + 2 * vocab * d
        if n >= target or d >= 8192:
            break
        d += 64
    return ModelConfig(
        name=f"dense-{params_millions:.0f}m", family="dense",
        num_layers=max(8, d // 64), d_model=d, num_heads=max(d // 64, 2),
        num_kv_heads=max(d // 64, 2), d_ff=4 * d, vocab_size=vocab,
        max_position=4096,
    )


def train(cfg: ModelConfig, steps: int, batch: int, seq: int,
          microbatches: int = 1, lr: float = 1e-3, ckpt_dir: str = "",
          ckpt_every: int = 50, device="cuda",
          on_metrics: Optional[Callable] = None):
    """The launcher's path: ``cfg``'s model on ``device`` (weights from seed
    0), AdamW, the step-seeded data and ``steps`` train steps, through
    ``FaultTolerantLoop`` when ``ckpt_dir`` is set.  ``on_metrics(step,
    metrics)`` sees each step's host floats.  Returns (the model, the final
    state, the loop or None)."""
    model = build_model(cfg, device=device, q_chunk=max(seq - 1, 64))
    opt = AdamW(lr=lr, warmup_steps=max(steps // 20, 5), total_steps=steps)
    state, _ = init_train_state(model, opt)
    ts, _ = make_train_step(model, opt, microbatches=microbatches)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, copy_period=16, family=cfg.family,
                      frontend_tokens=cfg.frontend_tokens,
                      frontend_dim=cfg.frontend_dim)

    def step_fn(st, step):
        st, m = ts(st, device_put_batch(batch_for_step(dcfg, step),
                                        model.device))
        return st, {k: float(v) for k, v in m.items()}

    on_metrics = on_metrics or (lambda step, m: None)
    if ckpt_dir:
        loop = FaultTolerantLoop(
            step_fn, state,
            FaultConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every),
        )
        loop.try_resume()
        state = loop.run(steps - loop.step, on_metrics=on_metrics)
        return model, state, loop
    for step in range(steps):
        state, m = step_fn(state, step)
        on_metrics(step + 1, m)
    return model, state, None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--params-millions", type=float, default=0.0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=129)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains")
    args = ap.parse_args(argv)

    if args.params_millions > 0:
        cfg = custom_dense_config(args.params_millions)
    elif args.smoke:
        cfg = get_smoke_config(args.arch)
    else:
        cfg = get_config(args.arch)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M")

    t0 = time.time()

    def on_metrics(step, m):
        if step % args.log_every == 0:
            dt = time.time() - t0
            tok = step * args.batch * (args.seq - 1)
            print(f"step {step:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} "
                  f"({tok/dt:.0f} tok/s)", flush=True)

    train(cfg, args.steps, args.batch, args.seq,
          microbatches=args.microbatches, lr=args.lr,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          device=args.device, on_metrics=on_metrics)


if __name__ == "__main__":
    main()
