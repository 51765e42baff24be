"""Corpus partitioner: split a built ``ProximaIndex`` into P search tiles —
port of ``src/repro/shard/partition.py``.

The paper's optimized data allocation scheme as a serving abstraction.
Each tile models one NAND channel group and holds:

  * a **partition** of the cold vertices (contiguous / hash / cluster-aware
    assignment — the allocation trade-off of §IV-E),
  * a **replica** of the hot nodes (ids ``< hot_count`` after visit-frequency
    reordering) and of the PQ centroids,
  * its **own proximity graph** over the tile's vertex set with a per-tile
    entry point, rebuilt with the port's device build (``core.graph.
    build_graph``) under the reference's density-compensated config.

Tiles are padded to a common vertex count; padding rows are unreachable and
carry ``tile_ids == -1``.  The assignment (``assign_cold``, ``_kmeans_labels``)
is the reference's numpy, so ``tile_of_cold`` is the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import GraphConfig
from repro_torch.core.graph import build_graph, compensated_build_cfg

POLICIES = ("contiguous", "hash", "cluster")


class TiledCorpus(NamedTuple):
    """Device-side stacked per-tile search structures (leading axis = tile).
    ``adjacency``/``codes``/``base`` are tile-local; ``tile_ids`` maps local
    row -> global id in the built index's (reordered) space, -1 for
    padding; ``centroids`` is the replicated PQ codebook;
    ``hot_counts[p]`` vertices at the head of every tile are the replicated
    hot nodes."""
    adjacency: torch.Tensor      # (P, Nt, R) int32, tile-local ids
    codes: torch.Tensor          # (P, Nt, M) uint8
    base: torch.Tensor           # (P, Nt, D) f32 (normalized for angular)
    centroids: torch.Tensor      # (M, C, dsub) f32 — replicated
    entry_points: torch.Tensor   # (P,) int32 tile-local entry vertex
    hot_counts: torch.Tensor     # (P,) int32 replicated-hot prefix length
    tile_ids: torch.Tensor       # (P, Nt) int32 local -> global, -1 padding
    tile_centroids: torch.Tensor  # (P, D) f32 mean of each tile's own
                                  # vectors — the query router's index

    @property
    def num_tiles(self) -> int:
        return self.adjacency.shape[0]


@dataclass
class TilePartition:
    """Host-side partition metadata (benchmark / accounting view)."""
    policy: str
    num_tiles: int
    hot_count: int                    # replicated prefix (global ids < this)
    tile_of_cold: np.ndarray          # (N - hot_count,) tile of each cold id
    tile_sizes: np.ndarray            # (P,) vertices per tile incl. replicas

    @property
    def imbalance(self) -> float:
        """max/mean tile size — 1.0 is perfectly balanced."""
        return float(self.tile_sizes.max() / max(self.tile_sizes.mean(), 1))

    def replicated_fraction(self, num_vertices: int) -> float:
        """Extra storage from hot-node replication, relative to the corpus."""
        extra = (self.num_tiles - 1) * self.hot_count
        return extra / max(num_vertices, 1)


def _kmeans_labels(x: np.ndarray, k: int, seed: int, iters: int = 8) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    cent = x[rng.choice(n, size=min(k, n), replace=False)].astype(np.float64)
    labels = np.zeros(n, np.int64)
    for _ in range(iters):
        d = (
            (x * x).sum(-1)[:, None] - 2.0 * x @ cent.T
            + (cent * cent).sum(-1)[None, :]
        )
        labels = d.argmin(1)
        for c in range(len(cent)):
            m = labels == c
            if m.any():
                cent[c] = x[m].mean(0)
    return labels


def assign_cold(base_cold: np.ndarray, num_tiles: int, policy: str,
                seed: int = 0) -> np.ndarray:
    """(Nc,) tile index for every cold vertex, by allocation policy:
    ``contiguous`` blocks of consecutive ids, ``hash`` round-robin
    ``i % P``, or ``cluster`` (k-means clusters greedily bin-packed onto
    tiles, big clusters first)."""
    nc = base_cold.shape[0]
    if policy == "contiguous":
        return np.minimum(
            np.arange(nc) * num_tiles // max(nc, 1), num_tiles - 1
        ).astype(np.int32)
    if policy == "hash":
        return (np.arange(nc) % num_tiles).astype(np.int32)
    if policy == "cluster":
        k = min(max(4 * num_tiles, num_tiles), max(nc, 1))
        labels = _kmeans_labels(base_cold.astype(np.float64), k, seed)
        sizes = np.bincount(labels, minlength=k)
        tile_of_cluster = np.zeros(k, np.int32)
        load = np.zeros(num_tiles, np.int64)
        for c in np.argsort(-sizes):          # big clusters first
            t = int(load.argmin())
            tile_of_cluster[c] = t
            load[t] += sizes[c]
        return tile_of_cluster[labels]
    raise ValueError(f"unknown shard policy {policy!r}; choose from {POLICIES}")


def _is_segment_built(index) -> bool:
    """Duck-type a ``core.segmented.SegmentedIndex``."""
    return hasattr(index, "segments") and hasattr(index, "codebook") \
        and not hasattr(index, "graph")


def _tiled(device, **arrays) -> TiledCorpus:
    return TiledCorpus(**{k: torch.as_tensor(v, device=device)
                          for k, v in arrays.items()})


def tiles_from_segments(seg_index) -> tuple[TiledCorpus, TilePartition]:
    """Direct-to-tile emission: every built segment IS a channel tile (its
    local-id graph, reordered codes/base, entry point and centroid), with
    no repartition and no graph rebuild.  Per-segment hot prefixes become
    ``hot_counts`` but are not replicas (every id lives on one tile), so
    ``TilePartition.hot_count`` is 0."""
    segs = seg_index.segments
    p_tiles = len(segs)
    metric = seg_index.metric
    nt = max(s.num_vertices for s in segs)
    r = segs[0].graph.max_degree
    m = segs[0].codes.shape[1]
    d = segs[0].base.shape[1]

    adjacency = np.zeros((p_tiles, nt, r), np.int32)
    codes = np.zeros((p_tiles, nt, m), np.uint8)
    base = np.zeros((p_tiles, nt, d), np.float32)
    tile_ids = np.full((p_tiles, nt), -1, np.int32)
    entries = np.zeros((p_tiles,), np.int32)
    hot_counts = np.zeros((p_tiles,), np.int32)
    tile_cents = np.zeros((p_tiles, d), np.float32)
    tile_of = np.empty((seg_index.num_base,), np.int32)

    for p, seg in enumerate(segs):
        k = seg.num_vertices
        sb = seg.base
        if metric == "angular":
            sb = sb / np.maximum(np.linalg.norm(sb, axis=-1, keepdims=True),
                                 1e-12)
        adjacency[p, :k] = seg.graph.adjacency
        codes[p, :k] = seg.codes
        base[p, :k] = sb
        tile_ids[p, :k] = seg.start + np.arange(k, dtype=np.int32)
        entries[p] = seg.graph.entry_point
        hot_counts[p] = seg.hot_count
        tile_cents[p] = seg.centroid
        tile_of[seg.start : seg.start + k] = p

    part = TilePartition(
        policy="segments", num_tiles=p_tiles, hot_count=0,
        tile_of_cold=tile_of,
        tile_sizes=np.asarray([s.num_vertices for s in segs], np.int64),
    )
    tiled = _tiled(
        seg_index.device, adjacency=adjacency, codes=codes, base=base,
        centroids=seg_index.codebook.centroids, entry_points=entries,
        hot_counts=hot_counts, tile_ids=tile_ids, tile_centroids=tile_cents)
    return tiled, part


def partition_index(index, num_tiles: Optional[int] = None,
                    policy: str = "contiguous", replicate_hot: bool = True,
                    from_segments: bool = False,
                    stage_times: Optional[dict] = None,
                    ) -> tuple[TiledCorpus, TilePartition]:
    """Split a built ``ProximaIndex`` into ``num_tiles`` search tiles on
    the index's device.  Per-tile graphs are rebuilt over each tile's
    vertex set (hot replicas + cold partition) with the reference's
    density-compensated config; ``num_tiles == 1`` reuses the index's own
    graph.  A segment-built index (or ``from_segments=True``) takes the
    direct-emission path (:func:`tiles_from_segments`).
    ``stage_times``, if given, receives the seconds of the assignment and
    of each tile's graph build."""
    if from_segments or _is_segment_built(index):
        return tiles_from_segments(index)
    if num_tiles is None:
        raise ValueError("num_tiles is required for a flat ProximaIndex")
    if num_tiles < 1:
        raise ValueError("num_tiles must be >= 1")
    from repro_torch.core.graph import StageTimer

    dev = index.device
    timer = StageTimer(stage_times, dev)
    n = index.dataset.num_base
    hot = int(index.hot_count) if replicate_hot else 0
    search_base = index._search_base()        # normalized for angular
    metric = index.dataset.metric

    if num_tiles == 1:
        part = TilePartition(
            policy=policy, num_tiles=1, hot_count=hot,
            tile_of_cold=np.zeros(n - hot, np.int32),
            tile_sizes=np.asarray([n], np.int64),
        )
        tiled = _tiled(
            dev, adjacency=index.graph.adjacency[None],
            codes=index.codes[None], base=search_base[None],
            centroids=index.codebook.centroids,
            entry_points=np.asarray([index.graph.entry_point], np.int32),
            hot_counts=np.asarray([hot], np.int32),
            tile_ids=np.arange(n, dtype=np.int32)[None],
            tile_centroids=search_base.mean(0, keepdims=True).astype(
                np.float32))
        return tiled, part

    cold_ids = np.arange(hot, n)
    # cluster on the search geometry (normalized for angular) so the tiles,
    # the router centroids and the per-tile searches agree on distances
    tile_of_cold = assign_cold(search_base[hot:], num_tiles, policy,
                               seed=index.config.dataset.seed)
    timer.mark("assign")
    tiles_global: List[np.ndarray] = []
    for p in range(num_tiles):
        tiles_global.append(np.concatenate([
            np.arange(hot, dtype=np.int64),          # replicated hot prefix
            cold_ids[tile_of_cold == p],
        ]))
    sizes = np.asarray([len(t) for t in tiles_global], np.int64)
    if sizes.min() < 2:
        raise ValueError(
            f"num_tiles={num_tiles} with policy={policy!r} leaves a tile "
            f"with {int(sizes.min())} vertices (sizes {sizes.tolist()}); "
            "reduce num_tiles or pick a different policy")
    nt = int(sizes.max())

    r = index.graph.max_degree
    m = index.codes.shape[1]
    d = search_base.shape[1]
    adjacency = np.zeros((num_tiles, nt, r), np.int32)
    codes = np.zeros((num_tiles, nt, m), np.uint8)
    base = np.zeros((num_tiles, nt, d), np.float32)
    tile_ids = np.full((num_tiles, nt), -1, np.int32)
    entries = np.zeros((num_tiles,), np.int32)
    tile_cents = np.zeros((num_tiles, d), np.float32)

    graph_cfg: GraphConfig = index.config.graph
    for p, ids in enumerate(tiles_global):
        k = len(ids)
        # the k//4 floor: cluster tiles keep whole clusters at full density,
        # so the neighbourhood is tied to the tile size for inter-cluster
        # reach (the reference's rule)
        tile_cfg = compensated_build_cfg(graph_cfg, num_tiles, k, floor=k // 4)
        g = build_graph(index.dataset.base[ids], tile_cfg, metric,
                        device=dev)
        adjacency[p, :k] = g.adjacency
        entries[p] = g.entry_point
        codes[p, :k] = index.codes[ids]
        base[p, :k] = search_base[ids]
        tile_ids[p, :k] = ids
        # router centroid over the tile's own (cold) vertices
        own = ids[hot:] if k > hot else ids
        tile_cents[p] = search_base[own].mean(0)
        timer.mark("tile_graphs")

    part = TilePartition(
        policy=policy, num_tiles=num_tiles, hot_count=hot,
        tile_of_cold=tile_of_cold.astype(np.int32), tile_sizes=sizes,
    )
    tiled = _tiled(
        dev, adjacency=adjacency, codes=codes, base=base,
        centroids=index.codebook.centroids, entry_points=entries,
        hot_counts=np.full((num_tiles,), hot, np.int32), tile_ids=tile_ids,
        tile_centroids=tile_cents)
    return tiled, part


def tiled_from_arrays(*, adjacency, codes, base, centroids, entry_points,
                      hot_counts, tile_ids, tile_centroids,
                      partition: Optional[dict] = None,
                      device="cuda") -> tuple:
    """The port's ``TiledCorpus`` over copies of a tiled corpus built
    elsewhere (the reference's ``TiledCorpus`` fields as numpy arrays), and
    its ``TilePartition`` from plain field values (``dataclasses.asdict``
    of the reference's) or None."""
    arrays = dict(adjacency=adjacency, codes=codes, base=base,
                  centroids=centroids, entry_points=entry_points,
                  hot_counts=hot_counts, tile_ids=tile_ids,
                  tile_centroids=tile_centroids)
    tiled = TiledCorpus(**{k: torch.tensor(np.array(v, copy=True),
                                            device=device)
                           for k, v in arrays.items()})
    part = None if partition is None else TilePartition(**{
        k: np.array(v, copy=True) if isinstance(v, np.ndarray) else v
        for k, v in partition.items()})
    return tiled, part
