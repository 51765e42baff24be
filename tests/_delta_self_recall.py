"""How often an inserted vector, served as a query, finds itself through the
REFERENCE's delta segment (``repro.stream.delta.DeltaSegment``) — the
yardstick for the streaming phase of ``chip_smoke.py``, which can only run
the port.  A self-query finds itself exactly when the segment's search
(``search_batch(q, k + base_overfetch)``, as the merged search calls it)
returns the vector's own id: its distance is 0, so it then tops the merged
list.  A miss is the greedy graph search's, which the port copies line for
line.

Two modes, both on the CPU with numpy (a minute per 1,024 inserts, a few
per 4,096):

  PYTHONPATH=src python tests/_delta_self_recall.py --inserts FILE.npz
      replays the inserts ``chip_smoke.py`` wrote (``stream_inserts.npz`` in
      its ``--out-dir``) through the reference, in the same order, and holds
      its search ids for the served self-queries against the port's, which
      the smoke recorded on the card's host.

  PYTHONPATH=src python tests/_delta_self_recall.py --seed 1
      makes the inserts as the smoke does (a random sift-like base vector
      plus N(0, 0.1^2) noise; the smoke's dataset parameters, ``--num-base``
      rows) from another seed and reports the reference's self-found share.

Prints one JSON object.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro.configs.base import (  # noqa: E402
    DatasetConfig, GraphConfig, StreamConfig,
)
from repro.core.dataset import make_dataset  # noqa: E402
from repro.stream.delta import DeltaSegment  # noqa: E402

# chip_smoke.py's main-path graph and dataset, and its serving k
GRAPH = GraphConfig(max_degree=64, build_list_size=128)
K = 10
SELF_QUERIES = 256
# the smoke's STREAM_DELTA_CAPACITY: its inserts.  Seeds 1-5 found 0.9961,
# 0.9922, 1.0, 0.9961, 0.9922 of 256 (0.949-0.980 at StreamConfig's 4,096)
CAPACITY = 1024


def smoke_inserts(seed: int, num_base: int, cap: int):
    """(inserts, self_rows) drawn as the smoke's streaming phase draws them
    (over a ``num_base``-row base of the same clusters)."""
    cfg = DatasetConfig(name="sift-like", num_base=num_base, num_queries=1,
                        dim=128, metric="l2", num_clusters=16384,
                        cluster_std=0.5, seed=seed)
    base = make_dataset(cfg, k_gt=1).base.astype(np.float32)
    rng = np.random.default_rng(seed + 17)
    rng.choice(num_base, 10_000, replace=False)      # the deletes' draw
    picks = base[rng.choice(num_base, cap + 1)]
    inserts = (picks + 0.1 * rng.standard_normal(picks.shape)).astype(
        np.float32)
    return inserts[:cap], rng.choice(cap, SELF_QUERIES, replace=False)


def replay(inserts, centroids, self_rows) -> tuple:
    stream = StreamConfig()
    seg = DeltaSegment(dim=inserts.shape[1], metric="l2",
                       centroids=centroids, graph_cfg=GRAPH,
                       stream_cfg=stream)
    t0 = time.perf_counter()
    for v in inserts:
        seg.insert(v)
    insert_s = time.perf_counter() - t0
    ids, _ = seg.search_batch(inserts[self_rows], K + stream.base_overfetch)
    found = np.array([r in row for r, row in zip(self_rows, ids)])
    return ids, found, insert_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inserts", help="stream_inserts.npz from chip_smoke.py")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-base", type=int, default=100_000)
    args = ap.parse_args(argv)
    cap = CAPACITY
    out = {}
    if args.inserts:
        f = np.load(args.inserts)
        inserts, self_rows = f["inserts"][:cap], f["self_rows"]
        centroids = f["centroids"]
        out["source"] = args.inserts
    else:
        inserts, self_rows = smoke_inserts(args.seed, args.num_base, cap)
        # the codes play no part in the segment's search
        centroids = np.random.default_rng(args.seed).standard_normal(
            (32, 256, 4)).astype(np.float32)
        out.update(seed=args.seed, num_base=args.num_base)
    ids, found, insert_s = replay(inserts, centroids, self_rows)
    out.update(inserts=len(inserts), insert_s=insert_s,
               self_queries=len(self_rows), self_found=float(found.mean()),
               missed=self_rows[~found].tolist())
    if args.inserts:
        out["ids_equal_port"] = bool(np.array_equal(ids, f["port_ids"]))
        out["missed_equal_port"] = bool(np.array_equal(
            self_rows[~found], f["port_missed"]))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
