"""Search-engine (CMOS wafer) timing/energy model — paper §IV-D, Table II;
copy of ``src/repro/nand/engine.py`` (pure Python).

Clock 1 GHz (22 nm-scaled). Components and their Table II power numbers:
search queues x256, candidate list 2 kB, Bloom filter 12 kB SRAM + 8
SeaHashes, ADT memory 16 kB, PQ module (codebook 64 kB + 32 FP16 MACs),
one shared 256-point bitonic sorter.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    clock_ghz: float = 1.0
    n_queues: int = 256               # N_q
    # -- latency models (cycles), §IV-D
    adt_cycles_per_dim_l2: int = 24   # Euclidean ADT build: 24*D cycles
    adt_cycles_per_dim_ip: int = 8    # Angular/IP: 8*D
    pq_dist_cycles_per_code: int = 32 # M cycles per candidate (M=32)
    acc_dist_cycles_per_dim: int = 1  # D cycles per accurate distance
    sorter_points: int = 256
    # -- power (mW), Table II
    p_static_mw: float = 2141.752
    p_dynamic_mw: float = 2423.802
    # -- per-op dynamic energy split (derived from Table II power @1GHz,
    #    attributed per active unit)
    e_pq_dist_pj: float = 7.0         # M LUT+adds
    e_acc_dist_pj: float = 20.0       # D MACs
    e_sort_pj: float = 486.0          # one 256-pt bitonic pass
    e_bloom_pj: float = 4.6
    e_adt_pj: float = 120.0

    def cycles_to_ns(self, cycles: float) -> float:
        return cycles / self.clock_ghz

    def adt_latency_ns(self, dim: int, metric: str) -> float:
        c = (self.adt_cycles_per_dim_l2 if metric == "l2"
             else self.adt_cycles_per_dim_ip)
        return self.cycles_to_ns(c * dim)

    def sorter_latency_ns(self) -> float:
        n = self.sorter_points
        stages = (math.log2(n) * (math.log2(n) + 1)) / 2
        return self.cycles_to_ns(2 * math.log2(n))  # stage-pipelined (§IV-D)

    def pq_batch_latency_ns(self, n_candidates: int, m: int = 32) -> float:
        """PQ distances for one neighbour fetch (pipelined MACs)."""
        return self.cycles_to_ns(m + n_candidates)

    def acc_latency_ns(self, dim: int) -> float:
        return self.cycles_to_ns(dim)
