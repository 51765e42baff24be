"""Append-only delta segment with an incrementally maintained Vamana graph —
port of ``src/repro/stream/delta.py``, copied: numpy on the host, as in the
reference (the delta is the DRAM write buffer in front of the NAND
channels, so nothing of it lives on the device).

Freshly inserted vectors live here (DRAM-resident, unlike the NAND-resident
base corpus) until ``MutableIndex.consolidate()`` folds them into a rebuilt
base index. Each insert runs the faithful Vamana update from
``core.graph.build_incremental``: greedy-search the current delta graph from
its entry point, robust-prune the visited set into the new vertex's
neighbour list, then patch reverse edges (re-pruning rows that overflow
``max_degree``). Vectors are also PQ-encoded against the *frozen* base
codebook so consolidation and the NAND write model know the exact bytes the
segment will eventually program.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import GraphConfig, StreamConfig
from repro_torch.core.dataset import pairwise_dist
from repro_torch.core.graph import _greedy_search_np, robust_prune


def encode_np(vecs: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Host-side PQ encode (numpy, called once per insert).
    vecs (B, D), centroids (M, C, dsub) -> (B, M) uint8."""
    m, _, dsub = centroids.shape
    subs = vecs.reshape(vecs.shape[0], m, dsub)
    d = ((subs[:, :, None, :] - centroids[None]) ** 2).sum(-1)  # (B, M, C)
    return np.argmin(d, axis=-1).astype(np.uint8)


class DeltaSegment:
    """In-memory mutable segment. Ids are *local* (0..count-1); the owning
    MutableIndex maps them to stable external ids."""

    def __init__(
        self,
        dim: int,
        metric: str,
        centroids: np.ndarray,          # frozen base PQ codebook (M, C, dsub)
        graph_cfg: GraphConfig,
        stream_cfg: StreamConfig,
    ):
        self.metric = metric
        self.graph_cfg = graph_cfg
        self.stream_cfg = stream_cfg
        self.centroids = centroids
        cap = stream_cfg.delta_capacity
        r = graph_cfg.max_degree
        self.vecs = np.zeros((cap, dim), np.float32)
        self.codes = np.zeros((cap, centroids.shape[0]), np.uint8)
        self.adjacency = np.zeros((cap, r), np.int32)
        self.degrees = np.zeros((cap,), np.int32)
        self.count = 0
        self.entry_point = 0

    def __len__(self) -> int:
        return self.count

    @property
    def full(self) -> bool:
        return self.count >= self.vecs.shape[0]

    # ------------------------------------------------------------- mutation
    def insert(self, vec: np.ndarray) -> int:
        """Vamana-style incremental insert; returns the local id."""
        if self.full:
            raise RuntimeError("delta segment full — consolidate first")
        v = np.asarray(vec, np.float32).reshape(-1)
        if self.metric == "angular":
            v = v / max(float(np.linalg.norm(v)), 1e-12)
        i = self.count
        self.vecs[i] = v
        self.codes[i] = encode_np(v[None], self.centroids)[0]
        r, alpha = self.graph_cfg.max_degree, self.graph_cfg.alpha
        if i > 0:
            scored, _ = _greedy_search_np(
                self.vecs, self.adjacency, self.degrees, self.entry_point,
                v, self.metric, self.stream_cfg.delta_list_size,
            )
            cand = np.asarray([u for u, _ in scored], dtype=np.int64)
            cd = np.asarray([d for _, d in scored], dtype=np.float32)
            kept = robust_prune(cand, cd, self.vecs, self.metric, r, alpha)
            self.adjacency[i, : len(kept)] = kept
            self.degrees[i] = len(kept)
            for j in kept:
                self._patch_reverse_edge(j, i)
        self.count = i + 1
        return i

    def _patch_reverse_edge(self, j: int, i: int) -> None:
        """Add edge j -> i, re-pruning row j if it overflows max_degree."""
        dj = int(self.degrees[j])
        row = self.adjacency[j, :dj]
        if i in row:
            return
        r, alpha = self.graph_cfg.max_degree, self.graph_cfg.alpha
        if dj < r:
            self.adjacency[j, dj] = i
            self.degrees[j] = dj + 1
            return
        merged = np.append(row, i).astype(np.int64)
        cd = pairwise_dist(self.vecs[j : j + 1], self.vecs[merged],
                           self.metric)[0]
        kept = robust_prune(merged, cd, self.vecs, self.metric, r, alpha)
        self.adjacency[j, : len(kept)] = kept
        self.degrees[j] = len(kept)

    # --------------------------------------------------------------- search
    def _brute_force(self) -> bool:
        """Exact scan while the segment is tiny (one shared regime switch for
        the single-query and batched paths — they must never diverge)."""
        return self.count <= self.stream_cfg.brute_force_below

    def search(self, query: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Top-k over the segment by accurate distance. Brute force while the
        segment is tiny; greedy graph search once it pays off. Returns
        (local_ids, dists), both length <= k."""
        if self.count == 0:
            return (np.empty((0,), np.int32), np.empty((0,), np.float32))
        q = np.asarray(query, np.float32).reshape(-1)
        if self._brute_force() or self.count <= k:
            ids, d = self.search_batch(q[None], k)   # the one brute-force path
            got = int((ids[0] >= 0).sum())
            return ids[0, :got], d[0, :got]
        if self.metric == "angular":
            q = q / max(float(np.linalg.norm(q)), 1e-12)
        scored, _ = _greedy_search_np(
            self.vecs, self.adjacency, self.degrees, self.entry_point,
            q, self.metric, max(self.stream_cfg.delta_list_size, k),
        )
        top = scored[:k]
        return (
            np.asarray([u for u, _ in top], np.int32),
            np.asarray([d for _, d in top], np.float32),
        )

    def search_batch(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Batched top-k over the segment: (Q, k) local ids (-1 padded) and
        distances (+inf padded). The brute-force regime — the common case,
        the segment is tiny between consolidations — is one vectorized
        distance matrix over ALL queries; only the graph regime walks per
        query (a host-side greedy search has no batch form)."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        nq = q.shape[0]
        out_ids = np.full((nq, k), -1, np.int32)
        out_d = np.full((nq, k), np.inf, np.float32)
        if self.count == 0:
            return out_ids, out_d
        if self._brute_force() or self.count <= k:
            d = pairwise_dist(q, self.vecs[: self.count], self.metric)
            got = min(k, self.count)
            order = np.argsort(d, axis=1, kind="stable")[:, :got]
            out_ids[:, :got] = order.astype(np.int32)
            out_d[:, :got] = np.take_along_axis(d, order, 1).astype(np.float32)
            return out_ids, out_d
        for i in range(nq):
            ids_i, d_i = self.search(q[i], k)
            out_ids[i, : len(ids_i)] = ids_i
            out_d[i, : len(d_i)] = d_i
        return out_ids, out_d

    # ---------------------------------------------------------- accounting
    def logical_bytes_per_insert(self) -> float:
        """Bytes one insert eventually programs into NAND (same formula the
        analytic NAND update model uses)."""
        from repro_torch.nand.simulator import logical_insert_bytes

        return logical_insert_bytes(
            dim=self.vecs.shape[1], pq_bits=8 * self.codes.shape[1],
            r_degree=self.graph_cfg.max_degree, index_bits=32,
        )
