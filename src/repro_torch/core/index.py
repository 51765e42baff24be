"""End-to-end Proxima index construction — port of
``src/repro/core/index.py`` (``ProximaIndex``, ``build_index``,
``build_index_monolithic``).

dataset -> PQ codebook/codes -> proximity graph -> visit-frequency
reordering -> hot-node selection -> gap encoding -> device ``Corpus``, each
stage on ``device``.  ``build_index`` is the single-segment case of
``core.segmented.build_segmented``, as in the reference;
``build_index_monolithic`` is the one-pass pipeline kept beside it as the
independent implementation the single-segment path is held against.

``index_from_arrays`` carries an index built by the reference across: it
takes the reference index's numpy arrays (copied, so the port never writes
into them), its reordering and plain config values, recomputes the gap
encoding with the port's copy, and returns the port's ``ProximaIndex``, so
the tests run both packages on one index.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import (
    BuildConfig, DatasetConfig, FilterConfig, GraphConfig, PQConfig,
    ProximaConfig, SearchConfig, ShardConfig, StreamConfig, upgrade_config,
)
from repro_torch.core import pq as pq_mod
from repro_torch.core.dataset import Dataset, make_dataset, normalize
from repro_torch.core.gap_encoding import GapEncodedGraph, gap_encode
from repro_torch.core.graph import (
    Graph, StageTimer, add_stage_times, build_graph,
)
from repro_torch.core.reorder import (
    Reordering, remap_ground_truth, reorder_segment,
)
from repro_torch.core.search import Corpus


@dataclass
class ProximaIndex:
    config: ProximaConfig
    dataset: Dataset                 # arrays in *reordered* id space
    graph: Graph
    codebook: pq_mod.PQCodebook
    codes: np.ndarray                # (N, M) uint8, reordered
    calibrated_beta: float
    gap: Optional[GapEncodedGraph] = None
    reordering: Optional[Reordering] = None
    device: str = "cuda"
    # per-node attribute columns (``filter.AttributeStore``) keyed by
    # internal (reordered) id; filtered search needs it (or a store passed
    # to ``Searcher.open`` / ``ServingEngine``)
    attributes: Optional[Any] = None

    @property
    def hot_count(self) -> int:
        """Ids < hot_count are hot nodes (the reordering's hottest prefix)."""
        return self.reordering.hot_count if self.reordering else 0

    def corpus(self) -> Corpus:
        """Device-side search structures, on ``self.device``."""
        dev = self.device
        return Corpus(
            adjacency=torch.tensor(self.graph.adjacency, device=dev),
            codes=torch.tensor(self.codes, device=dev),
            base=torch.tensor(self._search_base(), device=dev),
            centroids=torch.tensor(self.codebook.centroids, device=dev),
            entry_point=int(self.graph.entry_point),
            hot_count=int(self.hot_count),
        )

    def _search_base(self) -> np.ndarray:
        b = np.ascontiguousarray(self.dataset.base, np.float32)
        if self.dataset.metric == "angular":
            b = normalize(b)
        return b

    def sharded_corpus(self, num_tiles: Optional[int] = None,
                       policy: Optional[str] = None,
                       replicate_hot: Optional[bool] = None):
        """Partition this index into P search tiles (one per NAND channel
        group) for the channel-parallel serving path; see
        ``repro_torch.shard``.  Defaults come from ``config.shard``.
        Returns (TiledCorpus, TilePartition)."""
        from repro_torch.shard import partition_index

        sc = upgrade_config(self.config).shard
        return partition_index(
            self,
            num_tiles=sc.num_tiles if num_tiles is None else num_tiles,
            policy=sc.policy if policy is None else policy,
            replicate_hot=(
                sc.replicate_hot if replicate_hot is None else replicate_hot
            ),
        )

    def index_bytes(self) -> dict:
        """Storage accounting (paper Challenge 3 / §III-E)."""
        n, r = self.graph.adjacency.shape
        raw = self.dataset.base.nbytes
        idx_raw = n * r * 4
        idx_gap = self.gap.encoded_bytes if self.gap else idx_raw
        pq_bytes = self.codes.nbytes
        hot_extra = self.hot_count * r * self.codes.shape[1]  # repeated codes
        return {
            "raw_bytes": raw,
            "index_bytes_uncompressed": idx_raw,
            "index_bytes_gap": idx_gap,
            "pq_bytes": pq_bytes,
            "hot_repetition_bytes": hot_extra,
            "total_bytes": raw + idx_gap + pq_bytes + hot_extra,
        }


def encoder_input(base: np.ndarray, metric: str) -> np.ndarray:
    """The PQ encoder's input: the base, unit-normalized for angular."""
    if metric == "angular":
        return base / np.maximum(np.linalg.norm(base, axis=-1, keepdims=True),
                                 1e-12)
    return base


def encode_rows(enc_in: np.ndarray, codebook: pq_mod.PQCodebook,
                device) -> np.ndarray:
    """(n, M) uint8 codes of ``enc_in`` through the codebook, on ``device``."""
    x = torch.as_tensor(np.ascontiguousarray(enc_in, np.float32),
                        device=device)
    return pq_mod.encode(x, torch.as_tensor(codebook.centroids,
                                            device=device)).cpu().numpy()


def build_index_monolithic(cfg: ProximaConfig,
                           dataset: Optional[Dataset] = None,
                           graph_method: str = "knn_prune",
                           reorder_samples: int = 128,
                           calibrate: bool = False, device="cuda",
                           stage_times: Optional[dict] = None) -> ProximaIndex:
    """The one-pass pipeline with the whole corpus resident (the
    reference's ``build_index_monolithic``): kept as the independent
    implementation ``build_index``'s single-segment path is held against.
    ``stage_times``, if given, receives the seconds of each stage."""
    cfg = upgrade_config(cfg)
    ds = dataset if dataset is not None else make_dataset(cfg.dataset,
                                                          device=device)
    metric = ds.metric
    timer = StageTimer(stage_times, device)
    codebook = pq_mod.train_pq(ds.base, cfg.pq, metric, device=device)
    timer.mark("pq_train")
    enc_in = encoder_input(ds.base, metric)
    codes = encode_rows(enc_in, codebook, device)
    timer.mark("pq_encode")
    graph_times: dict = {}
    graph = build_graph(ds.base, cfg.graph, metric, graph_method, device,
                        stage_times=graph_times)
    timer.mark("graph")
    add_stage_times(stage_times, graph_times, "graph_")
    reordering = None
    if cfg.hot_node_fraction > 0:
        graph, new_base, enc_in, codes, reordering = reorder_segment(
            graph, ds.base, enc_in, codes, codebook.centroids, cfg.search,
            metric, cfg.hot_node_fraction, num_samples=reorder_samples,
            seed=cfg.dataset.seed, device=device, stage_times=stage_times,
        )
        ds = Dataset(base=new_base, queries=ds.queries,
                     gt=remap_ground_truth(reordering, ds.gt),
                     metric=ds.metric, config=ds.config)
        timer.restart()
    gap = gap_encode(graph.adjacency) if cfg.gap_encode else None
    timer.mark("gap")
    beta = cfg.search.beta
    if calibrate:
        rng = np.random.default_rng(cfg.dataset.seed)
        beta = pq_mod.calibrate_beta(codebook, codes, enc_in, rng,
                                     device=device)
        timer.mark("calibrate")
    return ProximaIndex(config=cfg, dataset=ds, graph=graph,
                        codebook=codebook, codes=codes, gap=gap,
                        reordering=reordering, calibrated_beta=beta,
                        device=device)


def build_index(cfg: ProximaConfig, dataset: Optional[Dataset] = None,
                graph_method: str = "knn_prune", reorder_samples: int = 128,
                calibrate: bool = False, device="cuda",
                stage_times: Optional[dict] = None) -> ProximaIndex:
    """Build a flat index on ``device`` — the single-segment case of
    ``core.segmented.build_segmented``, as in the reference.  For a corpus
    in segments, call ``build_segmented`` with ``segment_size > 0``.
    ``stage_times``, if given, receives the seconds of each stage."""
    from repro_torch.core.segmented import build_segmented

    return build_segmented(
        cfg, dataset=dataset, graph_method=graph_method,
        reorder_samples=reorder_samples, calibrate=calibrate,
        segment_size=0, device=device, stage_times=stage_times,
    ).to_flat()


_SECTIONS = {
    "dataset": DatasetConfig, "pq": PQConfig, "graph": GraphConfig,
    "search": SearchConfig, "stream": StreamConfig, "build": BuildConfig,
    "shard": ShardConfig, "filter": FilterConfig,
}


def config_from_fields(fields: dict) -> ProximaConfig:
    """A ``ProximaConfig`` from plain field values, e.g.
    ``dataclasses.asdict`` of a reference config."""
    kw = {k: (_SECTIONS[k](**v) if k in _SECTIONS else v)
          for k, v in fields.items()}
    return ProximaConfig(**kw)


def _copy(a, dtype) -> np.ndarray:
    return np.array(a, dtype=dtype, copy=True)


def index_from_arrays(*, adjacency, degrees, entry_point, codes, base,
                      queries, gt, metric, centroids, config: dict,
                      perm=None, inv=None, hot_count=0,
                      device="cuda") -> ProximaIndex:
    """The port's ``ProximaIndex`` over copies of the arrays of an index
    built elsewhere (the reference's ``graph.adjacency``/``degrees``/
    ``entry_point``, ``codes``, ``dataset.base``/``queries``/``gt``/
    ``metric``, ``codebook.centroids``, the reordering's ``perm``/``inv``/
    ``hot_count``) and its config as plain field values
    (``dataclasses.asdict``).  The gap encoding is recomputed here when the
    config asks for it."""
    cfg = config_from_fields(config)
    ds = Dataset(base=_copy(base, np.float32),
                 queries=_copy(queries, np.float32),
                 gt=_copy(gt, np.int32), metric=metric, config=cfg.dataset)
    graph = Graph(adjacency=_copy(adjacency, np.int32),
                  degrees=_copy(degrees, np.int32),
                  entry_point=int(entry_point), metric=metric)
    reordering = None
    if perm is not None or hot_count:
        n = graph.num_vertices
        ident = np.arange(n, dtype=np.int32)
        reordering = Reordering(
            perm=ident if perm is None else _copy(perm, np.int32),
            inv=ident if inv is None else _copy(inv, np.int32),
            hot_count=int(hot_count))
    return ProximaIndex(
        config=cfg, dataset=ds, graph=graph,
        codebook=pq_mod.PQCodebook(_copy(centroids, np.float32), metric),
        codes=_copy(codes, np.uint8),
        gap=gap_encode(graph.adjacency) if cfg.gap_encode else None,
        reordering=reordering, calibrated_beta=cfg.search.beta,
        device=device,
    )
