"""Embedding-corpus retrieval backed by Proxima — port of
``src/repro/serve/retrieval.py``.

``EmbeddingRetriever`` takes any (N, D) corpus of embeddings (an encoder's
output), builds the Proxima index over it on ``device`` and answers kNN
queries with ``core.search.graph_search``, in the corpus's original ids
(``reordering.inv`` undoes the hot-node renumbering).  The device corpus is
made once and kept.  ``stage_times``, if given, receives the build's
seconds by stage, as ``build_index``'s does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.configs.base import (
    DatasetConfig, GraphConfig, PQConfig, ProximaConfig, SearchConfig,
)
from repro_torch.core.dataset import Dataset, exact_knn
from repro_torch.core.index import ProximaIndex, build_index


class EmbeddingRetriever:
    def __init__(
        self,
        embeddings: np.ndarray,          # (N, D) corpus embeddings
        metric: str = "angular",
        pq_subvectors: Optional[int] = None,
        max_degree: int = 32,
        hot_fraction: float = 0.03,
        search: Optional[SearchConfig] = None,
        device="cuda",
        stage_times: Optional[dict] = None,
    ):
        n, d = embeddings.shape
        m = pq_subvectors or max(
            mm for mm in (8, 16, 25, 32) if d % mm == 0
        )
        # num_queries is a placeholder until the first query(): the batch
        # size is known only then
        cfg = ProximaConfig(
            dataset=DatasetConfig(name="corpus", num_base=n, num_queries=1,
                                  dim=d, metric=metric),
            pq=PQConfig(num_subvectors=m,
                        num_centroids=min(256, max(n // 4, 16))),
            graph=GraphConfig(max_degree=max_degree,
                              build_list_size=2 * max_degree),
            search=search or SearchConfig(k=10, list_size=64, t_init=16,
                                          t_step=8, repetition_rate=2,
                                          beta=1.06),
            hot_node_fraction=hot_fraction,
        )
        base = np.asarray(embeddings, np.float32)
        queries = base[:1]
        ds = Dataset(
            base=base, queries=queries,
            gt=exact_knn(queries, base, min(10, n), metric, device=device),
            metric=metric, config=cfg.dataset,
        )
        self.index: ProximaIndex = build_index(cfg, dataset=ds,
                                               reorder_samples=64,
                                               device=device,
                                               stage_times=stage_times)
        self._corpus = None

    def query(self, q: np.ndarray, k: int = 10):
        """(Q, k) ids in the corpus's original numbering and their
        distances, as host arrays."""
        from repro_torch.core.search import graph_search

        qb = np.atleast_2d(np.asarray(q, np.float32))
        # the config travels with NAND traces: it records the batch
        # actually searched, not the build-time placeholder
        if self.index.config.dataset.num_queries != qb.shape[0]:
            ds_cfg = dataclasses.replace(self.index.config.dataset,
                                         num_queries=qb.shape[0])
            self.index.config = dataclasses.replace(self.index.config,
                                                    dataset=ds_cfg)
            self.index.dataset.config = ds_cfg
        if self._corpus is None:
            self._corpus = self.index.corpus()
        cfg = dataclasses.replace(self.index.config.search, k=k)
        res = graph_search(self._corpus, qb, cfg, self.index.dataset.metric)
        ids = res.ids.cpu().numpy()
        if self.index.reordering is not None:     # back to corpus ids
            ids = self.index.reordering.inv[np.clip(ids, 0, None)]
        return ids, res.dists.cpu().numpy()
