"""Synthetic data pipeline — port of ``src/repro/train/data.py`` (lines
24-82).  ``DataConfig``, ``_tokens_for_step`` and ``batch_for_step`` are the
reference's numpy, copied: tokens, labels and ``frontend`` are the
reference's bit for bit.

Stateless and step-seeded: ``batch_for_step(step)`` is a pure function of
(seed, step), so checkpoint/restart and elastic re-meshing resume the exact
token stream with NO pipeline state in the checkpoint.

The synthetic LM task mixes three learnable structures so a ~100M model shows
a real loss curve in a few hundred steps:
  * Zipf-distributed unigrams (learnable bias toward frequent tokens)
  * first-order Markov chains with banded transitions (learnable bigrams)
  * periodic copy patterns (induction-head-style repetition)
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    copy_period: int = 64
    frontend_tokens: int = 0
    frontend_dim: int = 0
    family: str = "dense"


def _tokens_for_step(cfg: DataConfig, step: int) -> np.ndarray:
    rng = np.random.default_rng(np.uint64(cfg.seed * 1_000_003 + step))
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    veff = min(v, 50000)
    # zipf unigrams
    ranks = np.arange(1, veff + 1, dtype=np.float64)
    probs = ranks ** -cfg.zipf_a
    probs /= probs.sum()
    toks = rng.choice(veff, size=(b, s), p=probs)
    # markov band: with p=0.5 next token = prev + small delta (mod veff)
    deltas = rng.integers(-4, 5, size=(b, s))
    markov = (np.roll(toks, 1, axis=1) + deltas) % veff
    use_markov = rng.random((b, s)) < 0.5
    toks = np.where(use_markov, markov, toks)
    # periodic copy: second half of each period repeats the first half
    p = cfg.copy_period
    if s >= 2 * p:
        idx = np.arange(s)
        phase = idx % (2 * p)
        src = idx - p
        copy_mask = (phase >= p) & (src >= 0)
        toks[:, copy_mask] = toks[:, src[copy_mask]]
    return toks.astype(np.int32)


def batch_for_step(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    toks = _tokens_for_step(cfg, step)
    batch: Dict[str, np.ndarray] = {
        "tokens": toks[:, :-1].copy(),
        "labels": toks[:, 1:].copy(),
    }
    if cfg.family == "vlm":
        rng = np.random.default_rng(np.uint64(cfg.seed * 7 + step))
        batch["frontend"] = rng.standard_normal(
            (cfg.global_batch, cfg.frontend_tokens, cfg.frontend_dim)
        ).astype(np.float32)
    elif cfg.family == "encdec":
        rng = np.random.default_rng(np.uint64(cfg.seed * 7 + step))
        batch["frontend"] = rng.standard_normal(
            (cfg.global_batch, cfg.seq_len - 1, cfg.frontend_dim)
        ).astype(np.float32)
    return batch


def device_put_batch(batch: Dict[str, np.ndarray],
                     device="cuda") -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device`` (the reference's
    ``device_put`` with a batch sharding; on a mesh the train step takes
    each rank's rows itself)."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
