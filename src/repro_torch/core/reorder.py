"""Graph index reordering + hot-node selection (paper §IV-E, Fig. 10-a) —
port of ``src/repro/core/reorder.py``.

Vertices are renumbered by descending visit frequency, measured by tracing
searches over randomly sampled base vectors (the paper's procedure: "the
calculation of vertices' visiting frequency is based on the graph search
trace from the randomly sampled base data").  After reordering, the entry
point has index 0 and the hottest ``hot_fraction`` of nodes occupy the lowest
ids — the search layer treats ``id < hot_count`` as a hot-node-repetition
hit (NN indices + neighbours' PQ codes co-located).

The trace runs ``core.search.search_reference`` on ``device``: on CUDA each
sampled query's ADT is one ``pq_adt`` launch (Q=1), every round's PQ
distances one ``pq_lookup`` launch and every exact distance one
``l2_rerank`` launch.  The renumbering is the reference's numpy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import SearchConfig
from repro_torch.core.graph import Graph


@dataclass
class Reordering:
    perm: np.ndarray        # old id -> new id
    inv: np.ndarray         # new id -> old id
    hot_count: int


def trace_visit_frequency(
    graph: Graph,
    base: np.ndarray,
    codes: np.ndarray,
    centroids: np.ndarray,
    cfg: SearchConfig,
    metric: str,
    num_samples: int = 128,
    seed: int = 0,
    device="cuda",
) -> np.ndarray:
    """Expansion-frequency histogram from sampled-base-vector searches: the
    reference's sample (numpy draw), each sample searched on ``device``."""
    from repro_torch.core.search import search_reference

    rng = np.random.default_rng(seed)
    n = graph.num_vertices
    freq = np.zeros(n, dtype=np.int64)
    sample = rng.choice(n, size=min(num_samples, n), replace=False)
    base_t = torch.as_tensor(np.ascontiguousarray(base, np.float32),
                             device=device)
    codes_t = torch.as_tensor(codes, device=device)
    cents_t = torch.as_tensor(centroids, device=device)
    for qi in sample:
        search_reference(
            graph.adjacency, graph.degrees, codes_t, base_t, cents_t,
            graph.entry_point, base_t[int(qi)], cfg, metric, trace=freq,
        )
    return freq


def reorder_graph(
    graph: Graph, freq: np.ndarray, hot_fraction: float
) -> tuple[Graph, Reordering]:
    """Renumber vertices by descending visit frequency; entry point -> 0."""
    n = graph.num_vertices
    # entry point must stay hottest (it is visited by every query); the
    # reference keys it +inf in float64, the largest int64 orders the same
    key = freq.astype(np.int64).copy()
    key[graph.entry_point] = np.iinfo(np.int64).max
    order = np.argsort(-key, kind="stable")       # new id -> old id
    inv = order.astype(np.int32)
    perm = np.empty(n, dtype=np.int32)            # old id -> new id
    perm[order] = np.arange(n, dtype=np.int32)
    new_adj = perm[graph.adjacency[inv]]          # remap rows + contents
    new_deg = graph.degrees[inv]
    hot_count = int(np.ceil(hot_fraction * n)) if hot_fraction > 0 else 0
    g2 = Graph(
        adjacency=new_adj.astype(np.int32),
        degrees=new_deg.astype(np.int32),
        entry_point=int(perm[graph.entry_point]),
        metric=graph.metric,
    )
    return g2, Reordering(perm=perm, inv=inv, hot_count=hot_count)


def reorder_segment(
    graph: Graph,
    base: np.ndarray,
    enc_in: np.ndarray,
    codes: np.ndarray,
    centroids: np.ndarray,
    cfg: SearchConfig,
    metric: str,
    hot_fraction: float,
    num_samples: int = 128,
    seed: int = 0,
    device="cuda",
    stage_times: dict | None = None,
) -> tuple:
    """Trace -> renumber -> permute every row-aligned array of one built
    segment (base, the encoder input and the PQ codes together).  Returns
    ``(graph, base, enc_in, codes, Reordering)``.  ``stage_times``, if
    given, accumulates the seconds of the trace and of the renumbering."""
    from repro_torch.core.graph import StageTimer

    timer = StageTimer(stage_times, device)
    freq = trace_visit_frequency(
        graph, enc_in, codes, centroids, cfg, metric,
        num_samples=num_samples, seed=seed, device=device,
    )
    timer.mark("trace")
    graph, reord = reorder_graph(graph, freq, hot_fraction)
    base, enc_in, codes = apply_reordering(reord, base, enc_in, codes)
    timer.mark("reorder")
    return graph, base, enc_in, codes, reord


def apply_reordering(reord: Reordering, *arrays: np.ndarray) -> tuple:
    """Permute data arrays (base, codes, ...) into the new id space."""
    return tuple(a[reord.inv] for a in arrays)


def remap_ground_truth(reord: Reordering, gt: np.ndarray) -> np.ndarray:
    return reord.perm[gt]
