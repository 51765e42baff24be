"""Segmented out-of-core index build — port of ``src/repro/core/segmented.py``
(``IndexSegment``, ``SegmentedIndex``, ``reservoir_sample``,
``_build_segment``, ``build_segmented``).

The corpus is consumed as a stream of fixed-size segments:

    pass 1   reservoir-sample the stream -> ONE shared PQ codebook (bounded
             by ``BuildConfig.codebook_sample`` rows; a single segment is
             used whole, as in the reference)
    pass 2   per segment, on ``device``: PQ-encode -> proximity graph
             (density-compensated ``build_list_size``) -> visit-frequency
             reordering (the trace on the search kernels) -> gap encoding
    stitch   cross-segment boundary patching (``stream.stitch``) -> one
             navigable global graph for flat serving
    emit     segments ARE channel tiles (``shard.tiles_from_segments``)
             with segment centroids as routing metadata

A single-segment build is the monolithic pipeline (``core.index.
build_index_monolithic``) step for step; ``build_index`` is
``build_segmented(...).to_flat()``.  ``SegmentedIndex.build_trace`` feeds the
NAND build model, which waits for ROADMAP Queue 1 item 13, and raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.configs.base import ProximaConfig, upgrade_config
from repro_torch.core import pq as pq_mod
from repro_torch.core.dataset import Dataset, make_dataset
from repro_torch.core.gap_encoding import GapEncodedGraph, gap_encode
from repro_torch.core.graph import (
    Graph, StageTimer, add_stage_times, build_graph, compensated_build_cfg,
)
from repro_torch.core.index import ProximaIndex, encode_rows, encoder_input
from repro_torch.core.reorder import (
    Reordering, remap_ground_truth, reorder_segment,
)


@dataclass
class IndexSegment:
    """One built segment: a self-contained mini-index over the contiguous
    global-id block ``[start, start + num_vertices)``.  The graph lives in
    local (segment-reordered) ids — what a channel tile serves."""
    start: int                          # global id offset of this block
    graph: Graph                        # local ids, reordered within segment
    base: np.ndarray                    # (n_s, D) f32, reordered
    codes: np.ndarray                   # (n_s, M) uint8, reordered
    gap: Optional[GapEncodedGraph]
    reordering: Optional[Reordering]    # source-local -> built-local
    centroid: np.ndarray                # (D,) mean in search geometry

    @property
    def num_vertices(self) -> int:
        return self.base.shape[0]

    @property
    def hot_count(self) -> int:
        return self.reordering.hot_count if self.reordering else 0


@dataclass
class SegmentedIndex:
    """A segment-built index: shared codebook + per-segment mini-indexes +
    (multi-segment only) the cross-stitched global graph.  Serve it tiled
    (``plan.Searcher.open`` / :meth:`tiled_corpus`), or flatten it with
    :meth:`to_flat`."""
    config: ProximaConfig
    codebook: pq_mod.PQCodebook
    segments: List[IndexSegment]
    metric: str
    calibrated_beta: float
    stitch: Optional[object] = None     # stream.stitch.StitchResult (S > 1)
    dataset: Optional[Dataset] = None   # queries/gt in SOURCE id space
    graph_method: str = "knn_prune"
    device: str = "cuda"

    @property
    def num_segments(self) -> int:
        return len(self.segments)

    @property
    def num_base(self) -> int:
        return sum(s.num_vertices for s in self.segments)

    def segment_centroids(self) -> np.ndarray:
        """(S, D) routing metadata: each segment's centroid in search
        geometry."""
        return np.stack([s.centroid for s in self.segments]).astype(np.float32)

    def global_perm(self) -> np.ndarray:
        """(N,) source global id -> built global id (each segment keeps its
        block; the reordering permutes within it)."""
        perm = np.empty(self.num_base, np.int32)
        for seg in self.segments:
            n = seg.num_vertices
            local = seg.reordering.perm if seg.reordering is not None \
                else np.arange(n, dtype=np.int32)
            perm[seg.start : seg.start + n] = seg.start + local
        return perm

    def to_flat(self) -> ProximaIndex:
        """Flatten to a ``ProximaIndex``.  One segment: its artifacts as
        they are.  Several: the stitched global graph over the concatenated
        blocks (per-segment hot prefixes are no global hot prefix, so no
        reordering and ``hot_count`` 0 — serve such builds tiled to keep the
        hot-node accounting)."""
        cfg = self.config
        if self.num_segments == 1:
            seg = self.segments[0]
            return ProximaIndex(
                config=cfg, dataset=self._flat_dataset(seg.base,
                                                       seg.reordering),
                graph=seg.graph, codebook=self.codebook, codes=seg.codes,
                gap=seg.gap, reordering=seg.reordering,
                calibrated_beta=self.calibrated_beta, device=self.device,
            )
        if self.stitch is None:
            raise ValueError(
                "multi-segment index was built without stitching — cannot "
                "flatten to a navigable single graph")
        base = np.concatenate([s.base for s in self.segments])
        codes = np.concatenate([s.codes for s in self.segments])
        graph = self.stitch.graph
        return ProximaIndex(
            config=cfg,
            dataset=self._flat_dataset(base, None, perm=self.global_perm()),
            graph=graph, codebook=self.codebook, codes=codes,
            gap=gap_encode(graph.adjacency) if cfg.gap_encode else None,
            reordering=None, calibrated_beta=self.calibrated_beta,
            device=self.device,
        )

    def _flat_dataset(self, base, reordering, perm=None) -> Dataset:
        if self.dataset is None:
            d = base.shape[1]
            return Dataset(
                base=base, queries=np.zeros((0, d), np.float32),
                gt=np.zeros((0, 1), np.int32), metric=self.metric,
                config=self.config.dataset,
            )
        gt = self.dataset.gt
        if reordering is not None:
            gt = remap_ground_truth(reordering, gt)
        elif perm is not None:
            gt = perm[gt]
        return Dataset(base=base, queries=self.dataset.queries, gt=gt,
                       metric=self.dataset.metric, config=self.dataset.config)

    def tiled_corpus(self):
        """Direct-to-tile emission: (TiledCorpus, TilePartition), one tile
        per segment — see ``shard.tiles_from_segments``."""
        from repro_torch.shard import tiles_from_segments

        return tiles_from_segments(self)

    def index_bytes(self) -> dict:
        """Per-segment storage accounting plus corpus totals — the
        categories of ``ProximaIndex.index_bytes`` with a ``per_segment``
        breakdown; single-segment totals equal the flat build's."""
        per = []
        for seg in self.segments:
            n, r = seg.graph.adjacency.shape
            idx_raw = n * r * 4
            idx_gap = seg.gap.encoded_bytes if seg.gap else idx_raw
            pq_bytes = seg.codes.nbytes
            hot_extra = seg.hot_count * r * seg.codes.shape[1]
            per.append({
                "raw_bytes": seg.base.nbytes,
                "index_bytes_uncompressed": idx_raw,
                "index_bytes_gap": idx_gap,
                "pq_bytes": pq_bytes,
                "hot_repetition_bytes": hot_extra,
                "total_bytes": seg.base.nbytes + idx_gap + pq_bytes + hot_extra,
            })
        totals = {k: sum(p[k] for p in per) for k in per[0]}
        totals["per_segment"] = per
        return totals

    def build_trace(self, index_bits: int = 32):
        raise NotImplementedError(
            "the NAND build trace (nand.simulator.BuildTrace) is not ported "
            "yet: ROADMAP Queue 1 item 13 (nand/)")


def reservoir_sample(source, cap: int, seed: int = 0) -> np.ndarray:
    """Algorithm-R over a segment stream: a uniform sample of
    ``min(cap, N)`` rows in one pass with O(cap) memory — the reference's
    numpy, draw for draw (replacement indices drawn per segment and applied
    in order: fancy assignment is last-write-wins)."""
    rng = np.random.default_rng(seed)
    cap = min(cap, source.num_base)
    buf = np.empty((cap, source.dim), np.float32)
    seen = 0
    for seg in source:
        seg = np.asarray(seg, np.float32)
        m = seg.shape[0]
        take = min(max(cap - seen, 0), m)
        if take:
            buf[seen : seen + take] = seg[:take]
        if take < m:
            rest = seg[take:]
            pos = seen + take + np.arange(rest.shape[0])
            j = rng.integers(0, pos + 1)
            keep = j < cap
            buf[j[keep]] = rest[keep]
        seen += m
    return buf


def _build_segment(start: int, seg_base: np.ndarray,
                   codebook: pq_mod.PQCodebook, cfg: ProximaConfig,
                   metric: str, num_segments: int, seg_idx: int,
                   graph_method: str, reorder_samples: int, device,
                   stage_times: Optional[dict] = None) -> tuple:
    """The monolithic pipeline applied to ONE segment (encode -> graph ->
    reorder -> gap) on ``device``.  Returns ``(IndexSegment, enc_in)``."""
    timer = StageTimer(stage_times, device)
    enc_in = encoder_input(seg_base, metric)
    codes = encode_rows(enc_in, codebook, device)
    timer.mark("pq_encode")
    # each segment holds a 1/S sample of every cluster -> compensate the
    # build neighbourhood (identity for a single segment)
    gcfg = compensated_build_cfg(cfg.graph, num_segments, seg_base.shape[0])
    graph_times: dict = {}
    graph = build_graph(seg_base, gcfg, metric, method=graph_method,
                        device=device, stage_times=graph_times)
    timer.mark("graph")
    add_stage_times(stage_times, graph_times, "graph_")
    reordering = None
    if cfg.hot_node_fraction > 0:
        # segment 0 keeps the monolithic trace seed; later segments
        # decorrelate their trace samples
        seed = cfg.dataset.seed + (seg_idx if num_segments > 1 else 0)
        graph, seg_base, enc_in, codes, reordering = reorder_segment(
            graph, seg_base, enc_in, codes, codebook.centroids, cfg.search,
            metric, cfg.hot_node_fraction, num_samples=reorder_samples,
            seed=seed, device=device, stage_times=stage_times,
        )
        timer.restart()
    gap = gap_encode(graph.adjacency) if cfg.gap_encode else None
    timer.mark("gap")
    cent_in = enc_in if metric == "angular" else seg_base
    seg = IndexSegment(
        start=start, graph=graph, base=seg_base, codes=codes, gap=gap,
        reordering=reordering, centroid=cent_in.mean(0).astype(np.float32),
    )
    return seg, enc_in


def build_segmented(cfg: ProximaConfig, source=None,
                    dataset: Optional[Dataset] = None,
                    graph_method: str = "knn_prune",
                    reorder_samples: int = 128, calibrate: bool = False,
                    segment_size: Optional[int] = None, device="cuda",
                    stage_times: Optional[dict] = None) -> SegmentedIndex:
    """Build a :class:`SegmentedIndex` from a segment ``source`` (any object
    with ``num_base``/``dim``/``num_segments``/``segment(s)``/``bounds(s)``,
    e.g. ``core.dataset.ArraySegmentSource`` or ``SyntheticSegmentSource``)
    on ``device``.  With no ``source``, the ``dataset`` (or
    ``make_dataset(cfg.dataset)``) is viewed through ``Dataset.as_source``;
    ``segment_size`` overrides ``cfg.build.segment_size`` (0 -> one
    segment).  ``stage_times``, if given, receives the seconds of each stage
    (summed over segments) and of the stitch."""
    cfg = upgrade_config(cfg)
    bc = cfg.build
    ds = dataset
    if source is None:
        if ds is None:
            ds = make_dataset(cfg.dataset, device=device)
        sz = bc.segment_size if segment_size is None else segment_size
        source = ds.as_source(sz)
    metric = ds.metric if ds is not None else (
        getattr(source, "metric", None) or cfg.dataset.metric or "l2")
    num_segments = source.num_segments
    timer = StageTimer(stage_times, device)

    # --- pass 1: shared PQ codebook on a bounded reservoir sample (one
    # segment is resident already: the reservoir is bypassed)
    if num_segments == 1:
        sample = np.asarray(source.segment(0), np.float32)
    else:
        sample = reservoir_sample(source, bc.codebook_sample, cfg.pq.seed)
    codebook = pq_mod.train_pq(sample, cfg.pq, metric, device=device)
    del sample
    timer.mark("pq_train")

    # --- pass 2: per-segment encode/graph/reorder/gap
    segments: List[IndexSegment] = []
    enc_ins: List[np.ndarray] = []
    for s in range(num_segments):
        seg_base = np.asarray(source.segment(s), np.float32)
        lo, _ = source.bounds(s)
        seg, enc_in = _build_segment(
            lo, seg_base, codebook, cfg, metric, num_segments, s,
            graph_method, reorder_samples, device, stage_times)
        segments.append(seg)
        if calibrate:
            enc_ins.append(enc_in)
    timer.restart()

    # --- cross-segment stitching
    stitch = None
    if num_segments > 1:
        from repro_torch.stream.stitch import stitch_segments

        stitch = stitch_segments(segments, metric, cfg.graph, bc, device)
        timer.mark("stitch")

    beta = cfg.search.beta
    if calibrate:
        rng = np.random.default_rng(cfg.dataset.seed)
        codes_all = segments[0].codes if num_segments == 1 \
            else np.concatenate([g.codes for g in segments])
        enc_all = enc_ins[0] if num_segments == 1 else np.concatenate(enc_ins)
        beta = pq_mod.calibrate_beta(codebook, codes_all, enc_all, rng,
                                     device=device)
        timer.mark("calibrate")

    return SegmentedIndex(
        config=cfg, codebook=codebook, segments=segments, metric=metric,
        calibrated_beta=beta, stitch=stitch, dataset=ds,
        graph_method=graph_method, device=device,
    )
