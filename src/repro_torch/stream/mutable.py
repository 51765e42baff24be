"""MutableIndex: tombstoned deletes + delta inserts over a frozen base —
port of ``src/repro/stream/mutable.py``.  One addition: the index takes its
device from the base index, so ``corpus()``, ``tiled_corpus()`` and the
rebuild in ``consolidate()`` stay on the base's device (the delta segment
and the id bookkeeping stay host numpy).  The old base's device arrays are
dropped before the rebuild starts, so the two are never held together, and
``consolidate_stage_s`` keeps the seconds of the last rebuild's stages.

External ids are stable across the index's lifetime: the initial base corpus
owns ids ``0..N-1`` (in the base index's reordered space) and every insert
allocates the next id. Deletes mark ids in a tombstone set that the merged
search filters at rerank time; the vectors are physically dropped at the
next ``consolidate()``, which rebuilds the base ``ProximaIndex`` from all
live vectors (re-running PQ, graph build, visit-frequency reordering,
hot-node selection and gap encoding) and empties the delta segment.

Write accounting mirrors what the 3D NAND backend would see: each insert
eventually programs its raw vector + PQ code + adjacency row, and each
consolidation reprograms the whole rebuilt index — the ratio is the
subsystem's write amplification (fed to ``nand.simulator``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.configs.base import StreamConfig, upgrade_config
from repro_torch.core.dataset import Dataset, exact_knn
from repro_torch.core.index import ProximaIndex, build_index
from repro_torch.obs import NULL_OBS
from repro_torch.stream.delta import DeltaSegment


class MutableIndex:
    def __init__(self, index: ProximaIndex, stream_cfg: Optional[StreamConfig] = None,
                 attributes=None):
        self.base = index
        self.stream_cfg = stream_cfg or index.config.stream
        n = index.dataset.num_base
        # filtered-search attributes, keyed by STABLE EXTERNAL id (row e =
        # attrs of ext id e) so they survive consolidation's internal-id
        # reshuffle untouched. At construction ext ids 0..N-1 coincide with
        # the base index's internal ids, so a store attached to the built
        # index seeds the table directly.
        self.attributes = (
            attributes if attributes is not None
            else getattr(index, "attributes", None)
        )
        if self.attributes is not None and len(self.attributes) != n:
            raise ValueError(
                f"attribute store has {len(self.attributes)} rows, base "
                f"corpus has {n}"
            )
        self.ext_base = np.arange(n, dtype=np.int64)   # base internal -> ext
        self.next_ext = n
        self.delta_ext: list[int] = []                 # delta local -> ext
        self._live_base: set[int] = set(range(n))      # O(1) liveness checks
        self._delta_set: set[int] = set()
        self.tombstones: set[int] = set()
        self._dead_cache: Optional[np.ndarray] = None  # sorted tombstone array
        self._corpus = None
        # multi-channel base serving: the frozen base goes tiled, the delta
        # segment stays global (it is DRAM-resident; see stream.searcher)
        shard_cfg = upgrade_config(index.config).shard
        self.num_tiles = shard_cfg.num_tiles
        self.shard_policy = shard_cfg.policy
        self._tiled = None
        self._delta = self._new_delta()
        self.stats = {
            "inserts": 0, "deletes": 0, "consolidations": 0,
            "logical_bytes": 0.0, "consolidation_bytes": 0.0,
        }
        self.consolidate_stage_s: dict = {}   # the last rebuild's stages
        # observability bundle — ``Searcher.open(..., obs=...)`` and the
        # serving engine install a live one; default no-op
        self.obs = NULL_OBS

    def _new_delta(self) -> DeltaSegment:
        return DeltaSegment(
            dim=self.base.dataset.dim,
            metric=self.base.dataset.metric,
            centroids=self.base.codebook.centroids,
            graph_cfg=self.base.config.graph,
            stream_cfg=self.stream_cfg,
        )

    # ------------------------------------------------------------ properties
    @property
    def delta(self) -> DeltaSegment:
        return self._delta

    @property
    def metric(self) -> str:
        return self.base.dataset.metric

    @property
    def device(self):
        """The base index's device: its corpus and its rebuilds live there."""
        return self.base.device

    def corpus(self):
        """Cached device-side base corpus (refreshed on consolidation)."""
        if self._corpus is None:
            self._corpus = self.base.corpus()
        return self._corpus

    def set_num_tiles(self, num_tiles: int, policy: Optional[str] = None):
        """Route the base segment through ``num_tiles`` search tiles from the
        next flush on (the delta always stays global)."""
        self.num_tiles = int(num_tiles)
        if policy is not None:
            self.shard_policy = policy
        self._tiled = None

    def tiled_corpus(self):
        """Cached per-tile base corpus; repartitioned after consolidation
        (the rebuilt base has a fresh id space and vertex set)."""
        if self._tiled is None:
            self._tiled, _ = self.base.sharded_corpus(
                self.num_tiles, self.shard_policy
            )
        return self._tiled

    def delta_fraction(self) -> float:
        return len(self._delta) / max(self.base.dataset.num_base, 1)

    def needs_consolidation(self) -> bool:
        return (
            self._delta.full
            or self.delta_fraction() >= self.stream_cfg.consolidate_fraction
        )

    @property
    def delta_full(self) -> bool:
        """True when the next ``insert`` MUST consolidate first (the delta
        segment is at capacity).  The continuous serving engine checks this
        to complete in-flight merged lanes before the base index is rebuilt
        under them."""
        return self._delta.full

    def live_count(self) -> int:
        return (
            self.base.dataset.num_base + len(self.delta_ext)
            - len(self.tombstones)
        )

    def is_live(self, ext_id: int) -> bool:
        if ext_id in self.tombstones:
            return False
        return ext_id in self._live_base or ext_id in self._delta_set

    def tombstone_mask(self, ext_ids: np.ndarray) -> np.ndarray:
        """True where ext_ids are tombstoned. The dead-id array is cached
        across calls (search_merged calls this per query in a batch)."""
        if not self.tombstones:
            return np.zeros(ext_ids.shape, bool)
        if self._dead_cache is None:
            self._dead_cache = np.fromiter(
                self.tombstones, dtype=np.int64, count=len(self.tombstones)
            )
        return np.isin(ext_ids, self._dead_cache)

    def live_vectors(self) -> tuple[np.ndarray, np.ndarray]:
        """(ext_ids, raw vectors) of the *current* corpus — the ground-truth
        population for streaming recall measurements."""
        dead_base = self.tombstone_mask(self.ext_base)
        ids = [self.ext_base[~dead_base]]
        vecs = [self.base.dataset.base[~dead_base]]
        if self.delta_ext:
            dext = np.asarray(self.delta_ext, np.int64)
            alive = ~self.tombstone_mask(dext)
            ids.append(dext[alive])
            vecs.append(self._delta.vecs[: len(self._delta)][alive])
        return np.concatenate(ids), np.concatenate(vecs).astype(np.float32)

    # ---------------------------------------------------------------- filter
    def filter_masks(self, spec) -> tuple[np.ndarray, np.ndarray]:
        """(base_mask, ext_mask) for a ``FilterSpec``: ``ext_mask`` over all
        external ids ever allocated, ``base_mask`` the combined
        filter ∧ ¬tombstone admission mask over the CURRENT base index's
        internal ids (what the masked base traversal consumes)."""
        if self.attributes is None:
            raise RuntimeError(
                "index has no attribute store — pass attributes= to "
                "MutableIndex (or attach one to the base ProximaIndex) "
                "before filtered search"
            )
        ext_mask = self.attributes.mask(spec)           # (next_ext,)
        base_mask = ext_mask[self.ext_base] & ~self.tombstone_mask(self.ext_base)
        return base_mask, ext_mask

    # -------------------------------------------------------------- mutation
    def insert(self, vec: np.ndarray, attrs=None) -> int:
        """Insert a vector (and, when the index carries an attribute store,
        its attribute row — required so filters stay total over the live
        corpus)."""
        attr_row = None
        if self.attributes is not None:
            if attrs is None:
                raise ValueError(
                    "index carries an attribute store; insert(vec, "
                    "attrs=...) must provide the new vector's attributes"
                )
            # validate BEFORE any mutation: a malformed row must not leave
            # a live vector without its attribute entry
            attr_row = self.attributes.coerce_row(attrs)
        if self._delta.full:
            self.consolidate()
        self._delta.insert(vec)
        ext = self.next_ext
        self.next_ext += 1
        self.delta_ext.append(ext)
        self._delta_set.add(ext)
        if attr_row is not None:
            row = self.attributes.append(attr_row)
            assert row == ext, "attribute rows must track external ids"
        self.stats["inserts"] += 1
        self.stats["logical_bytes"] += self._delta.logical_bytes_per_insert()
        if self.obs.enabled:
            self.obs.metrics.counter("stream_inserts")
            self.obs.metrics.gauge("delta_fraction", self.delta_fraction())
        return ext

    def delete(self, ext_id: int) -> bool:
        """Tombstone an external id; False if already dead or never existed."""
        if not self.is_live(ext_id):
            return False
        self.tombstones.add(int(ext_id))
        self._dead_cache = None
        self.stats["deletes"] += 1
        return True

    def consolidate(self, reorder_samples: int = 64) -> ProximaIndex:
        """Merge delta + base into a rebuilt single-segment index."""
        if self.obs.enabled:
            t0 = time.perf_counter()
            with self.obs.tracer.span("consolidate", cat="stream",
                                      live=self.live_count()):
                out = self._consolidate(reorder_samples)
            self.obs.metrics.observe(
                "consolidate_ms", (time.perf_counter() - t0) * 1e3)
            self.obs.metrics.counter("stream_consolidations")
            return out
        return self._consolidate(reorder_samples)

    def _consolidate(self, reorder_samples: int = 64) -> ProximaIndex:
        ext_ids, vecs = self.live_vectors()
        cfg = upgrade_config(self.base.config)
        device = self.device
        # the old base's device arrays go before the new ones are built
        self._corpus = None
        self._tiled = None
        new_n = int(vecs.shape[0])
        ds_cfg = dataclasses.replace(
            cfg.dataset, num_base=new_n, num_queries=1,
        )
        # keep the kNN build neighbourhood proportional to corpus density:
        # when the corpus grows past the build list size, every kNN list
        # turns purely local and the graph loses its natural long-range
        # (inter-cluster) edges — greedy search then cannot navigate out of
        # the entry point's neighbourhood and recall collapses
        graph_cfg = cfg.graph
        old_n = cfg.dataset.num_base
        if new_n > old_n:
            scaled = int(np.ceil(cfg.graph.build_list_size * new_n / old_n))
            graph_cfg = dataclasses.replace(cfg.graph, build_list_size=scaled)
        new_cfg = dataclasses.replace(cfg, dataset=ds_cfg, graph=graph_cfg)
        queries = vecs[:1]
        ds = Dataset(
            base=vecs,
            queries=queries,
            gt=exact_knn(queries, vecs, min(10, vecs.shape[0]), self.metric,
                         device=device),
            metric=self.metric,
            config=ds_cfg,
        )
        stages: dict = {}
        new_index = build_index(new_cfg, dataset=ds,
                                reorder_samples=reorder_samples,
                                device=device, stage_times=stages)
        self.consolidate_stage_s = stages
        if new_index.reordering is not None:
            self.ext_base = ext_ids[new_index.reordering.inv]
        else:
            self.ext_base = ext_ids
        self.base = new_index
        self._delta = self._new_delta()
        self.delta_ext = []
        self._live_base = set(int(e) for e in self.ext_base)
        self._delta_set = set()
        self.tombstones = set()
        self._dead_cache = None
        self.stats["consolidations"] += 1
        self.stats["consolidation_bytes"] += float(
            new_index.index_bytes()["total_bytes"]
        )
        return new_index

    # ------------------------------------------------------------ accounting
    def write_amplification(self) -> float:
        """NAND bytes programmed / logical bytes inserted (>= 1)."""
        logical = self.stats["logical_bytes"]
        if logical <= 0:
            return 1.0
        return (logical + self.stats["consolidation_bytes"]) / logical

    # ---------------------------------------------------------------- search
    def search(self, queries: np.ndarray, cfg=None, filter_spec=None):
        from repro_torch.stream.searcher import merged_search_kernel

        return merged_search_kernel(self, queries, cfg,
                                    filter_spec=filter_spec)
