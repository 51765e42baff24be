"""Proxima index construction — port of ``src/repro/core/index.py``
(``ProximaIndex``, ``build_index``) restricted to the single-segment path of
``src/repro/core/segmented.py`` (``_build_segment``, ``build_segmented``):
dataset -> PQ codebook/codes -> proximity graph -> device ``Corpus``.

Hot-node reordering, gap encoding and segmented builds are not ported yet
and raise.  ``index_from_arrays`` carries an index built by the reference
across: it takes the reference index's numpy arrays and plain config values
and returns the port's ``ProximaIndex``, so the tests run both packages on
one index.
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
from repro_torch.core.dataset import (
    Dataset, l2_normalize, make_dataset, normalize,
)
from repro_torch.core.graph import Graph, StageTimer, build_graph
from repro_torch.core.search import Corpus


@dataclass
class ProximaIndex:
    config: ProximaConfig
    dataset: Dataset
    graph: Graph
    codebook: pq_mod.PQCodebook
    codes: np.ndarray                # (N, M) uint8
    calibrated_beta: float
    hot_count: int = 0               # ids < hot_count are hot nodes
    device: str = "cuda"
    # per-node attribute columns (``filter.AttributeStore``) keyed by
    # internal id; filtered search needs it (or a store passed to
    # ``Searcher.open`` / ``ServingEngine``)
    attributes: Optional[Any] = None

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

    def index_bytes(self) -> dict:
        """Storage accounting (paper Challenge 3 / §III-E), no gap coding."""
        n, r = self.graph.adjacency.shape
        raw = self.dataset.base.nbytes
        idx_raw = n * r * 4
        pq_bytes = self.codes.nbytes
        hot_extra = self.hot_count * r * self.codes.shape[1]
        return {
            "raw_bytes": raw,
            "index_bytes_uncompressed": idx_raw,
            "index_bytes_gap": idx_raw,
            "pq_bytes": pq_bytes,
            "hot_repetition_bytes": hot_extra,
            "total_bytes": raw + idx_raw + pq_bytes + hot_extra,
        }


def _unported(cfg: ProximaConfig) -> None:
    if cfg.hot_node_fraction > 0:
        raise NotImplementedError(
            "hot-node reordering is not ported yet (ROADMAP Queue 1 item 8: "
            "core/reorder.py and search_reference); use hot_node_fraction=0")
    if cfg.gap_encode:
        raise NotImplementedError(
            "gap encoding is not ported yet (ROADMAP Queue 1 item 8: "
            "core/gap_encoding.py); use gap_encode=False")
    if cfg.build.segment_size > 0:
        raise NotImplementedError(
            "segmented builds are not ported yet (ROADMAP Queue 1 item 8: "
            "core/segmented.py); use segment_size=0")


def build_index(cfg: ProximaConfig, dataset: Optional[Dataset] = None,
                graph_method: str = "knn_prune", device="cuda",
                stage_times: Optional[dict] = None) -> ProximaIndex:
    """Build a flat single-segment index on ``device``: the reference's
    ``build_index`` with ``hot_node_fraction=0``, ``gap_encode=False``.
    ``stage_times``, if given, receives the seconds of each stage."""
    cfg = upgrade_config(cfg)
    _unported(cfg)
    ds = dataset if dataset is not None else make_dataset(cfg.dataset,
                                                          device=device)
    metric = ds.metric
    timer = StageTimer(stage_times, device)
    codebook = pq_mod.train_pq(ds.base, cfg.pq, metric, device=device)
    timer.mark("pq_train")
    enc_in = torch.as_tensor(ds.base, device=device)
    if metric == "angular":
        enc_in = l2_normalize(enc_in)
    codes = pq_mod.encode(enc_in, torch.as_tensor(codebook.centroids,
                                                  device=device)).cpu().numpy()
    del enc_in
    timer.mark("pq_encode")
    graph_times: dict = {}
    graph = build_graph(ds.base, cfg.graph, metric, graph_method, device,
                        stage_times=graph_times)
    timer.mark("graph")
    if stage_times is not None:
        stage_times.update({f"graph_{k}": v for k, v in graph_times.items()})
    return ProximaIndex(config=cfg, dataset=ds, graph=graph,
                        codebook=codebook, codes=codes,
                        calibrated_beta=cfg.search.beta, device=device)


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


def index_from_arrays(*, adjacency, degrees, entry_point, codes, base,
                      queries, gt, metric, centroids, hot_count=0,
                      config: dict, device="cuda") -> ProximaIndex:
    """The port's ``ProximaIndex`` over arrays of an index built elsewhere
    (the reference's ``graph.adjacency``/``degrees``/``entry_point``,
    ``codes``, ``dataset.base``/``queries``/``gt``/``metric``,
    ``codebook.centroids``, ``hot_count``) and its config as plain field
    values (``dataclasses.asdict``)."""
    cfg = config_from_fields(config)
    ds = Dataset(base=np.asarray(base, np.float32),
                 queries=np.asarray(queries, np.float32),
                 gt=np.asarray(gt, np.int32), metric=metric,
                 config=cfg.dataset)
    graph = Graph(adjacency=np.asarray(adjacency, np.int32),
                  degrees=np.asarray(degrees, np.int32),
                  entry_point=int(entry_point), metric=metric)
    return ProximaIndex(
        config=cfg, dataset=ds, graph=graph,
        codebook=pq_mod.PQCodebook(np.asarray(centroids, np.float32), metric),
        codes=np.asarray(codes, np.uint8), calibrated_beta=cfg.search.beta,
        hot_count=int(hot_count), device=device,
    )


