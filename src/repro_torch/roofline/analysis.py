"""Roofline terms of a traced step — twin of
``src/repro/roofline/analysis.py`` (lines 72-185):

    compute term    = dot FLOPs per device / peak FLOP/s
    memory term     = HBM bytes per device / HBM bandwidth
    collective term = collective bytes per device / link bandwidth

The reference reads FLOPs and collective bytes out of XLA's compiled HLO;
the port has no HLO, so ``analyze`` takes the counts a ``trace_count``
dispatch trace recorded (per device, as ``hlo_parse``'s are).  There is no
twin of ``collective_bytes(hlo_text)``.

Hardware constants: the NVIDIA H100 SXM5's published figures (the TPU v5e's
197e12 / 819e9 / 50e9 of the reference do not carry over):
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.distributed import sharding as shard_lib

# H100 SXM5 datasheet (NVIDIA, "H100 Tensor Core GPU", 2023): dense BF16
# Tensor Core throughput without sparsity
PEAK_FLOPS = 989e12          # FLOP/s per card
# same datasheet: HBM3 memory bandwidth of the 80 GB SXM5 part
HBM_BW = 3.35e12             # bytes/s per card
# same datasheet: NVLink 4 at 900 GB/s bidirectional, so 450e9 each way
LINK_BW = 450e9              # bytes/s per card, one direction


@dataclasses.dataclass
class Roofline:
    flops: float                  # dot FLOPs per device
    hbm_bytes: float              # bytes accessed per device
    coll_bytes: float             # collective bytes per device
    coll_breakdown: Dict[str, int]
    chips: int
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0
    useful_ratio: float = 0.0

    def finalize(self, model_flops: float = 0.0) -> "Roofline":
        """The terms of whole-program totals spread over ``chips``."""
        self.compute_s = self.flops / (self.chips * PEAK_FLOPS)
        self.memory_s = self.hbm_bytes / (self.chips * HBM_BW)
        self.collective_s = self.coll_bytes / (self.chips * LINK_BW)
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        self.bottleneck = max(terms, key=terms.get)
        self.model_flops = model_flops
        self.useful_ratio = model_flops / self.flops if self.flops else 0.0
        return self

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def analyze(counts, chips: int, model_flops: float = 0.0,
            hbm_bytes_per_device: float = 0.0) -> Roofline:
    """The roofline of one device's program from ``counts`` (a
    ``trace_count.TraceCount``: per-device dot FLOPs and collective bytes
    by kind); the memory term is the analytic per-device HBM traffic
    (``analytic_hbm_bytes``).  ``useful_ratio`` is the model FLOPs over
    every device's dot FLOPs."""
    rl = Roofline(
        flops=counts.flops, hbm_bytes=hbm_bytes_per_device,
        coll_bytes=counts.coll_bytes,
        coll_breakdown={k: int(v) for k, v in counts.coll_by_kind.items()},
        chips=chips,
    )
    # per-device program: terms are per-chip seconds directly
    rl.compute_s = counts.flops / PEAK_FLOPS
    rl.memory_s = hbm_bytes_per_device / HBM_BW
    rl.collective_s = counts.coll_bytes / LINK_BW
    terms = {"compute": rl.compute_s, "memory": rl.memory_s,
             "collective": rl.collective_s}
    rl.bottleneck = max(terms, key=terms.get)
    rl.model_flops = model_flops
    rl.useful_ratio = (model_flops / (counts.flops * chips)
                       if counts.flops else 0.0)
    return rl


def train_model_flops(param_count: int, tokens: int) -> float:
    """6*N*D rule (fwd 2ND + bwd 4ND)."""
    return 6.0 * param_count * tokens


def decode_model_flops(active_params: int, tokens: int) -> float:
    """2*N per generated token (fwd only)."""
    return 2.0 * active_params * tokens


def analytic_hbm_bytes(cfg, shape, mesh, microbatches: int = 1,
                       kv_cache_bytes: float = 0.0) -> float:
    """Per-device HBM traffic estimate (the reference's memory model;
    ``mesh`` a ``DeviceMesh`` or ``{name: size}``).

    train (per step):
      params: fwd read + bwd read (2 x 4B fp32), grad accumulate r/w per
      microbatch (8B x mb), AdamW update (read p,m,v + write p,m,v = 24B)
      activations: saved block boundaries written+read once each:
      mb x layers x (tokens_local/mb) x d_model x 2B x 2
    prefill: params read (4B) + activations written once + KV written
    decode: params read (4B) + full KV cache read + O(1) writes
    """
    sizes = shard_lib.axis_sizes(mesh)
    n_devices = int(np.prod(list(sizes.values())))
    dsize = int(np.prod([s for a, s in sizes.items() if a != "model"]))
    params_local = cfg.param_count() / n_devices
    active_local = cfg.active_param_count() / n_devices
    tokens_local = shape.global_batch * shape.seq_len / max(dsize, 1)
    d = cfg.d_model
    if shape.kind == "train":
        param_traffic = params_local * (2 * 4 + 8 * microbatches + 24)
        act_traffic = (
            microbatches * cfg.num_layers
            * (tokens_local / max(microbatches, 1)) * d * 2 * 2
        )
        return param_traffic + act_traffic
    if shape.kind == "prefill":
        act = cfg.num_layers * tokens_local * d * 2
        return active_local * 4 + act + kv_cache_bytes
    # decode: read all active params + the whole KV cache once per token
    return active_local * 2 + kv_cache_bytes
