"""Serving launcher: batched Proxima ANN query serving (the paper's
workload) — port of ``src/repro/launch/serve.py``.  Builds a sift-like
index with ``core.build_index`` on ``--device`` and serves its queries
through ``serve.ServingEngine``, one submit and one step a query, then
prints the same lines as the reference (build, QPS, latency and recall).

    PYTHONPATH=src python -m repro_torch.launch.serve --num-base 4000 \\
        --queries 256 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.base import (
    DatasetConfig, GraphConfig, PQConfig, ProximaConfig, SearchConfig,
)
from repro_torch.core import build_index, recall_at_k
from repro_torch.serve.engine import ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-base", type=int, default=4000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--arrival-qps", type=float, default=0.0,
                    help="simulated request arrival rate (0 = closed loop)")
    ap.add_argument("--device", default="cuda",
                    help="where the index is built and searched")
    args = ap.parse_args(argv)

    cfg = ProximaConfig(
        dataset=DatasetConfig(name="sift-like", num_base=args.num_base,
                              num_queries=args.queries, dim=args.dim,
                              num_clusters=32, cluster_std=0.35, seed=0),
        pq=PQConfig(num_subvectors=32 if args.dim % 32 == 0 else 16,
                    num_centroids=128),
        graph=GraphConfig(max_degree=24, build_list_size=48),
        search=SearchConfig(k=args.k, list_size=64, t_init=16, t_step=8,
                            repetition_rate=2, beta=1.06),
        hot_node_fraction=0.03,
    )
    print("building index ...", flush=True)
    t0 = time.perf_counter()
    idx = build_index(cfg, reorder_samples=64, device=args.device)
    print(f"index built in {time.perf_counter()-t0:.1f}s "
          f"(gap {idx.gap.bit_width}b, {idx.gap.compression_ratio:.0%} saved; "
          f"hot {idx.hot_count} nodes)")

    eng = ServingEngine(idx, batch_size=args.batch_size)
    queries = idx.dataset.queries
    t0 = time.perf_counter()
    for i in range(queries.shape[0]):
        eng.submit(queries[i])
        if args.arrival_qps > 0:
            time.sleep(1.0 / args.arrival_qps)
        eng.step()
    eng.drain()
    dt = time.perf_counter() - t0
    done = sorted(eng.done.values(), key=lambda r: r.rid)
    lats = np.asarray([r.latency_ms for r in done])
    ids = np.stack([r.ids for r in done])
    rec = recall_at_k(ids, idx.dataset.gt, args.k)
    print(f"served {len(done)} queries in {dt:.2f}s -> {len(done)/dt:.0f} QPS")
    print(f"latency p50 {np.percentile(lats,50):.1f}ms "
          f"p99 {np.percentile(lats,99):.1f}ms | recall@{args.k} {rec:.3f} | "
          f"batches {eng.stats['batches']}")


if __name__ == "__main__":
    main()
