#!/usr/bin/env python3
"""Recall of one channel tile's graph against its build-list length, on one
NVIDIA GPU.  Run from the repository root:

    python3 scripts/tile_graph_recall.py [--lists 128,512,2048,0]

Generates the smoke's sift-like corpus (1M x 128, 16384 clusters at std
0.5, seed 0), takes the hash policy's first tile (every 4th vector, 250,000
rows, no hot replicas), and builds its graph with each build-list length
(0 = the tile partitioner's floor, a quarter of the tile) through
``build_index`` (PQ 32 x 256, R=64, no hot nodes, no gap encoding); then
searches 2,048 of the corpus's queries in the tile with the default
``SearchConfig`` and prints, per length, the build seconds, mean degree,
mean hops and recall@10 against the tile's exact top-10.  The card's name
and power limit come first; the records go to
``results/tile_graph_recall.json`` as well.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lists", default="128,512,2048,0")
    ap.add_argument("--queries", type=int, default=2048)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("tile_graph_recall: needs a CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo / "src"))
    import numpy as np

    from repro_torch.configs.base import (
        DatasetConfig, GraphConfig, PQConfig, ProximaConfig,
    )
    from repro_torch.core.dataset import (
        Dataset, exact_knn, generate, recall_at_k,
    )
    from repro_torch.core.index import build_index
    from repro_torch.plan import Searcher, SearchRequest

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dcfg = DatasetConfig(name="sift-like", num_base=1_000_000,
                         num_queries=args.queries, dim=128, metric="l2",
                         num_clusters=16384, cluster_std=0.5, seed=0)
    base, queries, _ = generate(dcfg)
    tile = np.ascontiguousarray(base[::4])
    gt = exact_knn(queries, tile, 10, "l2", device="cuda")
    ds = Dataset(base=tile, queries=queries, gt=gt, metric="l2", config=dcfg)
    out = []
    for k in (int(x) for x in args.lists.split(",")):
        k = k or tile.shape[0] // 4
        cfg = ProximaConfig(
            dataset=dcfg, pq=PQConfig(num_subvectors=32, num_centroids=256),
            graph=GraphConfig(max_degree=64, build_list_size=k),
            hot_node_fraction=0.0, gap_encode=False)
        t0 = time.perf_counter()
        idx = build_index(cfg, dataset=ds, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        res = Searcher.open(idx).search(SearchRequest(queries=queries))
        rec = {"build_list_size": k, "build_s": build_s,
               "mean_degree": float(idx.graph.degrees.mean()),
               "mean_hops": res.stats.hops,
               "recall_at_10": recall_at_k(res.ids, gt, 10)}
        out.append(rec)
        print(json.dumps(rec), flush=True)
    path = repo / "results" / "tile_graph_recall.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
