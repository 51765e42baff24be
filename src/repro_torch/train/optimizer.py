"""AdamW and its learning-rate schedule — port of
``src/repro/train/optimizer.py`` (lines 17-91), written by hand on tensors
(not ``torch.optim.AdamW``, whose decoupled decay and rounding are not the
reference's).

Parameters, gradients and moments are dicts keyed by the model's state-dict
names; the moments are f32.  ``apply`` keeps the reference's arithmetic in
its order: the global norm is the square root of the sum over leaves of
each leaf's f32 square-sum; ``scale = min(1, clip / max(gnorm, 1e-9))``;
the bias corrections are ``1 - b ** f32(step)``; the update
``p32 - lr * (delta + decay * p32)`` is cast back to the parameter's dtype
once.  The weight decay applies to leaves of rank >= 2 *in the reference's
pytree*, where a layer's tensors are stacked on a leading axis: the port's
``blocks.0.ln1`` has shape (d,), the reference's ``blocks/ln1`` (L, d), and
both are decayed.  Updates are in place; everything stays on the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.model import reference_path

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32, on the parameters' device
    mu: Tensors
    nu: Tensors


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """The rank of ``p``'s leaf in the reference's pytree: one more for a
    layer of ``blocks``, ``enc_blocks`` or ``cross_blocks``."""
    return p.ndim + (reference_path(name)[1] is not None)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1

    def schedule(self, step) -> torch.Tensor:
        """The learning rate at ``step`` (an int or an integer tensor), as an
        f32 tensor: linear warmup, then a cosine to ``min_lr_ratio``."""
        s = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(s / max(self.warmup_steps, 1), max=1.0)
        prog = torch.clamp(
            (s - self.warmup_steps)
            / max(self.total_steps - self.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        ratio = self.min_lr_ratio + (1 - self.min_lr_ratio) * cos
        return self.lr * warm * ratio

    def init(self, params: Tensors) -> AdamWState:
        dev = next(iter(params.values())).device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()},
            nu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()})

    @torch.no_grad()
    def apply(self, grads: Tensors, state: AdamWState, params: Tensors,
              sq_norm: Optional[torch.Tensor] = None
              ) -> Tuple[Tensors, AdamWState, Dict]:
        """One update of ``params`` and the moments, in place, from
        ``grads`` (any float dtype).  Returns (params, the new state,
        {"grad_norm", "lr"} as device scalars).

        ``sq_norm``: the whole gradient's squared norm, where ``grads`` are
        not all of it (``train.loop``'s sharded step passes the sum over
        its mesh); None takes it from ``grads``."""
        g32 = {k: g.float() for k, g in grads.items()}
        if sq_norm is None:
            sq_norm = sum(torch.sum(torch.square(g)) for g in g32.values())
        gnorm = torch.sqrt(sq_norm)
        clip = torch.tensor(self.clip_norm, dtype=torch.float32,
                            device=gnorm.device)
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        step = state.step + 1
        lr = self.schedule(step)
        s32 = step.to(torch.float32)
        b1c = 1.0 - torch.pow(self.b1, s32)
        b2c = 1.0 - torch.pow(self.b2, s32)
        for k, p in params.items():
            g = g32[k] * scale
            m, n = state.mu[k], state.nu[k]
            m.mul_(self.b1).add_((1 - self.b1) * g)
            n.mul_(self.b2).add_((1 - self.b2) * g * g)
            delta = (m / b1c) / (torch.sqrt(n / b2c) + self.eps)
            decay = (self.weight_decay if reference_ndim(k, p) >= 2
                     else 0.0)
            p32 = p.float()
            p.copy_(p32 - lr * (delta + decay * p32))
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {
            "grad_norm": gnorm, "lr": lr}
