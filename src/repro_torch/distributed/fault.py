"""Fault tolerance and elastic restore — port of
``src/repro/distributed/fault.py`` (lines 1-152).

1. **Hard faults** — checkpoint/restart.  ``FaultTolerantLoop`` wraps the
   train loop: a step-0 anchor, periodic (optionally async) checkpoints,
   and on a device error (``torch.AcceleratorError``, where the reference
   catches ``jax.errors.JaxRuntimeError``) it restores the latest checkpoint
   and replays.  The data pipeline is step-seeded (train/data.py), so replay
   needs no data state.  A rollback first waits for a checkpoint still
   being written, so it restores the newest one (the reference restores
   whichever ``latest`` names at that moment).  Any other exception
   propagates: a bug in the program is not a fault to retry.

2. **Numerics** — per-step loss / grad-norm guards: a non-finite loss or a
   grad-norm spike beyond ``gnorm_sigma`` standard deviations of the running
   statistics triggers a rollback-and-skip (restore the latest checkpoint,
   skip the offending step's data by advancing one step).

3. **Elasticity** — checkpoints are topology-independent (the reference's
   layout, ckpt/checkpoint.py): ``elastic_restore`` re-derives placements
   from the logical specs over the new mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt


@dataclasses.dataclass
class FaultConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    async_ckpt: bool = True
    gnorm_sigma: float = 6.0     # spike threshold (running stats)
    max_restarts: int = 8


class FaultTolerantLoop:
    """Wraps (state, step) -> (state, metrics) with checkpoint/restart.
    ``metrics`` hold host floats (``loss``, ``grad_norm``)."""

    def __init__(
        self,
        step_fn: Callable[[Any, int], tuple],
        state: Any,
        cfg: FaultConfig,
        shardings: Any = None,
        start_step: int = 0,
    ):
        self.step_fn = step_fn
        self.state = state
        self.cfg = cfg
        self.shardings = shardings
        self.step = start_step
        self.restarts = 0
        self._gn_mean = 0.0
        self._gn_var = 1.0
        self._gn_count = 0
        self._pending: Optional[Any] = None

    # ------------------------------------------------------------- recovery
    def try_resume(self) -> bool:
        latest = ckpt.latest_step(self.cfg.ckpt_dir)
        if latest is None:
            return False
        self.state, self.step, _ = ckpt.restore_checkpoint(
            self.cfg.ckpt_dir, self.state, shardings=self.shardings
        )
        return True

    def _rollback(self, skip_bad_step: bool) -> None:
        self.restarts += 1
        if self.restarts > self.cfg.max_restarts:
            raise RuntimeError("exceeded max_restarts; giving up")
        bad = self.step
        if self._pending is not None:     # the latest checkpoint, complete
            self._pending.join()
        self.state, self.step, _ = ckpt.restore_checkpoint(
            self.cfg.ckpt_dir, self.state, shardings=self.shardings
        )
        if skip_bad_step:
            # deterministic pipeline: skipping = advancing past the bad batch
            self.step = max(self.step, bad) + 1

    def _checkpoint(self) -> None:
        if self._pending is not None:
            self._pending.join()
        self._pending = ckpt.save_checkpoint(
            self.cfg.ckpt_dir, self.step, self.state,
            async_mode=self.cfg.async_ckpt, keep=self.cfg.keep,
        )

    def _gnorm_spike(self, gnorm: float) -> bool:
        if not math.isfinite(gnorm):
            return True
        if self._gn_count >= 20:
            sd = math.sqrt(max(self._gn_var, 1e-12))
            if gnorm > self._gn_mean + self.cfg.gnorm_sigma * sd:
                return True
        self._gn_count += 1
        d = gnorm - self._gn_mean
        self._gn_mean += d / self._gn_count
        self._gn_var += (d * (gnorm - self._gn_mean) - self._gn_var) / self._gn_count
        return False

    # ----------------------------------------------------------------- run
    def run(self, num_steps: int, on_metrics=None) -> Any:
        if self.step == 0:
            self._checkpoint()  # step-0 anchor so rollback always has a base
        end = self.step + num_steps
        while self.step < end:
            try:
                state2, metrics = self.step_fn(self.state, self.step)
                loss = float(metrics.get("loss", np.nan))
                gnorm = float(metrics.get("grad_norm", 0.0))
                if not math.isfinite(loss) or self._gnorm_spike(gnorm):
                    raise FloatingPointError(
                        f"numerics fault at step {self.step}: loss={loss} gnorm={gnorm}"
                    )
                self.state = state2
                self.step += 1
                if on_metrics:
                    on_metrics(self.step, metrics)
                if self.step % self.cfg.ckpt_every == 0:
                    self._checkpoint()
            except FloatingPointError:
                self._rollback(skip_bad_step=True)
            except torch.AcceleratorError:
                self._rollback(skip_bad_step=False)
        if self._pending is not None:
            self._pending.join()
        return self.state


def elastic_restore(ckpt_dir: str, target: Any, new_mesh, specs) -> Any:
    """Restore a checkpoint of parameters onto a DIFFERENT mesh (elastic
    scale up/down): placements are re-derived from the logical specs
    against ``new_mesh``; the leaves come back as DTensors."""
    from repro_torch.distributed import sharding as shard_lib

    sh = shard_lib.param_shardings(specs, target, new_mesh)
    state, step, extra = ckpt.restore_checkpoint(ckpt_dir, target,
                                                 shardings=sh)
    return state, step, extra
