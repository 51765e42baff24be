"""``Searcher`` — the host-side query API; port of
``src/repro/plan/searcher.py`` (``open`` on an index, a segment-built
index, a ``stream.MutableIndex``, a ``Corpus``, a ``TiledCorpus`` or a
``core.distributed.ShardedCorpus`` on a device mesh; ``search``, ``plan``,
``execute``, ``round_session``; ``warn_legacy`` for the deprecated entry
points).

    s = Searcher.open(index, num_tiles=4, shard_policy="cluster",
                      probe_tiles=2, attributes=store)
    res = s.search(SearchRequest(queries=q, k=10,
                                 filter=FilterSpec.eq("category", 3)))
    res.ids, res.dists                           # (Q, k) numpy
    res.stats.as_dict(), res.plan.kind   # flat | tiled | merged | distributed

The search runs on the device of the opened corpus (a mutable index's: its
base index's).  ``num_tiles > 1`` on a flat index partitions it
(``ProximaIndex.sharded_corpus``, per-tile graphs rebuilt on the device); a
``core.segmented.SegmentedIndex`` is served through its segments as tiles;
a ``MutableIndex`` plans ``merged`` (its base tiled when its own
``num_tiles`` says so).  ``obs=`` takes an ``obs.Observability`` bundle (or
an ``ObsConfig``): the planner then bills plan-cache traffic and kernel
execution, and with a quality monitor ``search`` feeds the shadow-recall
oracle (``shadow_ground_truth``, an exact kNN on the searcher's device).
``mesh=`` (a ``launch.mesh.make_mesh`` device mesh) or a ``ShardedCorpus``
target opens a distributed searcher: ``mode``, ``data_axis`` and
``queue_axis`` go into its ``PlanConfig``; every rank of the mesh makes
the same calls.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import (
    FilterConfig, PlanConfig, SearchConfig, upgrade_config,
)
from repro_torch.core.search import Corpus
from repro_torch.obs import Observability
from repro_torch.plan.planner import (
    Execution, IndexCapabilities, QueryPlan, QueryPlanner,
)
from repro_torch.plan.request import SearchRequest, SearchResult

# legacy entry points that already warned this process: one warning per
# entry point, not one per call
_warned_legacy: set = set()


def warn_legacy(old: str, new: str = "repro_torch.plan.Searcher.search"
                ) -> None:
    """One DeprecationWarning per legacy entry point per process, as in the
    reference; ``reset_legacy_warnings`` re-arms them (tests)."""
    if old in _warned_legacy:
        return
    _warned_legacy.add(old)
    warnings.warn(
        f"{old} is a deprecated entry point kept for compatibility; build a "
        f"SearchRequest and call {new} instead (see README 'query plan "
        f"layer')",
        DeprecationWarning, stacklevel=3,
    )


def reset_legacy_warnings() -> None:
    """Re-arm every deduplicated deprecation warning (test helper)."""
    _warned_legacy.clear()


def validate_attribute_store(store, expected_rows: int, owner: str):
    """The attribute-store/corpus length check shared by ``Searcher.open``
    and ``ServingEngine``.  Returns the store; ``None`` passes through."""
    if store is not None and len(store) != expected_rows:
        raise ValueError(
            f"attribute store has {len(store)} rows, {owner} has "
            f"{expected_rows}"
        )
    return store


class Searcher:
    """Facade over one opened search target.  Use :meth:`open`."""

    def __init__(self, *, planner: QueryPlanner, plan_cfg: PlanConfig,
                 index=None, num_tiles: int = 1,
                 shard_policy: Optional[str] = None):
        self.planner = planner
        self.plan_cfg = plan_cfg
        self._index = index
        self.num_tiles = num_tiles
        self.shard_policy = shard_policy
        self._oracle = None          # the oracle's base on the device
        self._live_oracle = None     # (mutable's update counts, ext ids,
                                     #  live vectors on the device)

    @classmethod
    def open(cls, index, plan: Optional[PlanConfig] = None, *,
             cfg: Optional[SearchConfig] = None,
             metric: Optional[str] = None,
             attributes=None,
             num_tiles: Optional[int] = None,
             shard_policy: Optional[str] = None,
             probe_tiles: Optional[int] = None,
             beam_width: Optional[int] = None,
             filter_cfg: Optional[FilterConfig] = None,
             bloom_bits: Optional[int] = None,
             num_hashes: Optional[int] = None,
             use_vmap: Optional[bool] = None,
             mesh=None,
             mode: Optional[str] = None,
             data_axis: Optional[str] = None,
             queue_axis: Optional[str] = None,
             obs=None) -> "Searcher":
        """Open a ``ProximaIndex``, a ``SegmentedIndex``, a
        ``stream.MutableIndex``, a ``Corpus``, a ``TiledCorpus`` or (with
        ``mesh=``) a ``ShardedCorpus``.  Keyword arguments override the
        matching ``PlanConfig`` fields; unset fields defer to the index's own config
        (its ``search``/``shard``/``filter`` sections).  ``attributes`` (a
        ``filter.AttributeStore`` keyed by internal id) serves filtered
        requests; an index's own ``attributes`` is the default.  ``obs``
        takes an ``obs.Observability`` bundle or an ``ObsConfig`` (None:
        the shared no-op bundle).  ``use_vmap`` picks a tiled target's
        fan-out (``shard.sharded_search_kernel``; None: the batched one).
        ``mesh`` (or a ``ShardedCorpus`` target, which needs it) opens a
        distributed searcher, run with ``mode`` (``nsp`` | ``fetch``),
        ``data_axis`` and ``queue_axis`` (``core.distributed.
        distributed_search_kernel``)."""
        obs = Observability.resolve(obs)
        pc = plan or PlanConfig()
        kw = dict(search=cfg, num_tiles=num_tiles, shard_policy=shard_policy,
                  probe_tiles=probe_tiles, beam_width=beam_width,
                  filter=filter_cfg, bloom_bits=bloom_bits,
                  num_hashes=num_hashes, use_vmap=use_vmap, mode=mode,
                  data_axis=data_axis, queue_axis=queue_axis)
        pc = dataclasses.replace(
            pc, **{k: v for k, v in kw.items() if v is not None})
        if mesh is not None or _is_sharded_corpus(index):
            return cls._open_distributed(index, pc, metric, mesh, obs)
        if _is_mutable(index):
            return cls._open_mutable(index, pc, metric, attributes, obs)
        if isinstance(index, Corpus):
            return cls._open_corpus(index, pc, metric, attributes, obs)
        if _is_tiled(index):
            return cls._open_tiled(index, pc, metric, attributes, obs)
        if _is_segmented(index):
            return cls._open_segmented(index, pc, metric, attributes, obs)
        if not hasattr(index, "graph"):
            raise NotImplementedError(
                f"Searcher.open takes an index, a segmented or mutable "
                f"index, a Corpus, a TiledCorpus or a ShardedCorpus, not a "
                f"{type(index).__name__}")
        return cls._open_index(index, pc, metric, attributes, obs)

    @classmethod
    def _resolve_cfg(cls, pc: PlanConfig, default: SearchConfig):
        scfg = pc.search or default
        if pc.beam_width is not None:
            scfg = dataclasses.replace(scfg, beam_width=pc.beam_width)
        return scfg

    @staticmethod
    def _probe_warning(probe_tiles: int, num_tiles: int, policy) -> None:
        if probe_tiles and num_tiles > 1 and policy != "cluster":
            warnings.warn(
                "probe_tiles routing assumes geometry-aware tiles "
                "(shard_policy='cluster'); with hash/contiguous allocation "
                "tile centroids are near-identical and routed recall "
                "collapses", stacklevel=3)

    @classmethod
    def _open_index(cls, index, pc, metric, attributes, obs):
        cfg_full = upgrade_config(index.config)
        scfg = cls._resolve_cfg(pc, cfg_full.search)
        shard_cfg = cfg_full.shard
        n_tiles = shard_cfg.num_tiles if pc.num_tiles is None else pc.num_tiles
        policy = shard_cfg.policy if pc.shard_policy is None \
            else pc.shard_policy
        probe = shard_cfg.probe_tiles if pc.probe_tiles is None \
            else pc.probe_tiles
        attributes = validate_attribute_store(
            attributes, index.dataset.num_base, "index"
        ) if attributes is not None else index.attributes
        tiled = corpus = None
        if n_tiles > 1:
            tiled, _ = index.sharded_corpus(n_tiles, policy)
        else:
            corpus = index.corpus()
        cls._probe_warning(probe, n_tiles, policy)
        caps = IndexCapabilities(kind="tiled" if tiled is not None else "flat",
                                 tiled=tiled is not None, num_tiles=n_tiles)
        planner = QueryPlanner(
            capabilities=caps, cfg=scfg,
            metric=metric or index.dataset.metric,
            filter_cfg=pc.filter or cfg_full.filter, plan_cfg=pc,
            corpus=corpus, tiled=tiled, attributes=attributes,
            probe_tiles=probe, obs=obs)
        return cls(planner=planner, plan_cfg=pc, index=index,
                   num_tiles=n_tiles, shard_policy=policy)

    @classmethod
    def _open_mutable(cls, mutable, pc, metric, attributes, obs):
        """A ``stream.MutableIndex``: merged plans over its base and delta.
        An attribute store passed here is keyed by external id and must
        cover every id allocated so far; the tiling defaults come from the
        mutable index itself, which an explicit request re-tiles."""
        base = mutable.base
        cfg_full = upgrade_config(base.config)
        scfg = cls._resolve_cfg(pc, cfg_full.search)
        probe = cfg_full.shard.probe_tiles if pc.probe_tiles is None \
            else pc.probe_tiles
        if attributes is not None:
            validate_attribute_store(
                attributes, mutable.next_ext,
                "mutable index (allocated external ids)")
            mutable.attributes = attributes
        n_tiles = mutable.num_tiles if pc.num_tiles is None else pc.num_tiles
        policy = mutable.shard_policy if pc.shard_policy is None \
            else pc.shard_policy
        if (n_tiles, policy) != (mutable.num_tiles, mutable.shard_policy):
            mutable.set_num_tiles(n_tiles, policy)
        cls._probe_warning(probe, n_tiles, policy)
        caps = IndexCapabilities(kind="merged", mutable=True,
                                 tiled=n_tiles > 1, num_tiles=n_tiles)
        planner = QueryPlanner(
            capabilities=caps, cfg=scfg,
            metric=metric or base.dataset.metric,
            filter_cfg=pc.filter or cfg_full.filter, plan_cfg=pc,
            mutable=mutable, attributes=mutable.attributes,
            probe_tiles=probe, obs=obs)
        if obs.enabled:
            mutable.obs = obs        # insert / consolidate spans and counters
        return cls(planner=planner, plan_cfg=pc, index=mutable,
                   num_tiles=n_tiles, shard_policy=policy)

    @classmethod
    def _open_corpus(cls, corpus, pc, metric, attributes, obs):
        if (pc.num_tiles or 1) > 1:
            raise ValueError("a Corpus is one tile; partition a ProximaIndex "
                             "(num_tiles=) or open a TiledCorpus")
        scfg = cls._resolve_cfg(pc, pc.search or SearchConfig())
        validate_attribute_store(attributes, corpus.base.shape[0], "corpus")
        planner = QueryPlanner(
            capabilities=IndexCapabilities(kind="flat"), cfg=scfg,
            metric=metric or "l2", filter_cfg=pc.filter or FilterConfig(),
            plan_cfg=pc, corpus=corpus, attributes=attributes, obs=obs)
        return cls(planner=planner, plan_cfg=pc)

    @classmethod
    def _open_tiled(cls, tiled, pc, metric, attributes, obs):
        scfg = cls._resolve_cfg(pc, pc.search or SearchConfig())
        caps = IndexCapabilities(kind="tiled", tiled=True,
                                 num_tiles=tiled.num_tiles)
        planner = QueryPlanner(
            capabilities=caps, cfg=scfg, metric=metric or "l2",
            filter_cfg=pc.filter or FilterConfig(), plan_cfg=pc,
            tiled=tiled, attributes=attributes,
            probe_tiles=pc.probe_tiles or 0, obs=obs)
        return cls(planner=planner, plan_cfg=pc, num_tiles=tiled.num_tiles)

    @classmethod
    def _open_segmented(cls, seg_index, pc, metric, attributes, obs):
        """A segment-built index is tiled by construction: its segments are
        emitted as tiles directly (``shard.tiles_from_segments``, no
        repartition, no graph rebuild) and its segment centroids are the
        router's coarse index."""
        cfg_full = upgrade_config(seg_index.config)
        scfg = cls._resolve_cfg(pc, cfg_full.search)
        probe = cfg_full.shard.probe_tiles if pc.probe_tiles is None \
            else pc.probe_tiles
        attributes = validate_attribute_store(
            attributes, seg_index.num_base, "segmented index")
        tiled, _ = seg_index.tiled_corpus()
        n_segments = seg_index.num_segments
        caps = IndexCapabilities(kind="tiled", tiled=True,
                                 num_tiles=n_segments)
        planner = QueryPlanner(
            capabilities=caps, cfg=scfg, metric=metric or seg_index.metric,
            filter_cfg=pc.filter or cfg_full.filter, plan_cfg=pc,
            tiled=tiled, attributes=attributes, probe_tiles=probe, obs=obs)
        return cls(planner=planner, plan_cfg=pc, index=seg_index,
                   num_tiles=n_segments, shard_policy="segments")

    @classmethod
    def _open_distributed(cls, dcorpus, pc, metric, mesh, obs):
        if mesh is None:
            raise ValueError("distributed targets need mesh=")
        scfg = cls._resolve_cfg(pc, pc.search or SearchConfig())
        num_shards = getattr(dcorpus, "num_shards", 1)
        caps = IndexCapabilities(kind="distributed",
                                 mesh_devices=int(mesh.size()),
                                 num_tiles=num_shards)
        planner = QueryPlanner(
            capabilities=caps, cfg=scfg, metric=metric or "l2",
            filter_cfg=pc.filter or FilterConfig(), plan_cfg=pc,
            dcorpus=dcorpus, mesh=mesh, obs=obs)
        return cls(planner=planner, plan_cfg=pc, num_tiles=num_shards)

    # -------------------------------------------------------------- querying
    def plan(self, request: SearchRequest) -> QueryPlan:
        return self.planner.plan(request)

    def execute(self, plan: QueryPlan, queries) -> Execution:
        """Run a precompiled plan over a (possibly padded) query batch —
        the serving engine's batch-flush path."""
        return self.planner.execute(plan, queries)

    def search(self, request: SearchRequest) -> SearchResult:
        """Plan + execute one request."""
        plan = self.planner.plan(request)
        ex = self.planner.execute(plan, request.queries)
        res = SearchResult(ids=ex.ids, dists=ex.dists,
                           stats=self.planner.stats_for(plan, ex),
                           plan=plan, raw=ex.raw)
        qm = self.obs.quality
        if qm is not None:
            # shadow-recall sampling (off-path exact-oracle replay); the
            # engine's flush/retire paths feed the monitor themselves
            qm.observe(self, plan, request.queries, res.ids)
        return res

    def round_session(self, plan: QueryPlan):
        """Steppable session for a plan (``None`` when the plan has no
        round-steppable spine) — the continuous engine's entry point."""
        return self.planner.round_session(plan)

    # ------------------------------------------------------- quality oracle
    def shadow_ground_truth(self, plan: QueryPlan, queries):
        """Exact-oracle neighbour ids for a query batch under ``plan``, in
        the plan's own result-id space — the shadow-recall estimator's
        ground truth (``obs.quality.QualityMonitor``).  The population is
        what the plan searched: for a merged plan the LIVE corpus
        (``MutableIndex.live_vectors``: tombstones out, delta inserts in;
        filtered through the live external-id mask), for a filtered plan
        the attribute-passing subset of the base, otherwise the whole base.
        The exact kNN runs on the searcher's device (``core.dataset.
        exact_knn``).  Returns ``(Q, k')`` int64 with ``k' = min(plan.cfg.k,
        population)``, or ``None`` for distributed fan-outs, one-shot
        caller-mask plans and targets with no raw vectors."""
        from repro_torch.core.dataset import exact_knn

        if plan.kind == "distributed" or plan.mask_token:
            return None
        q = np.atleast_2d(np.asarray(queries, np.float32))
        k = int(plan.cfg.k)
        if plan.kind == "merged":
            return self._live_ground_truth(plan, q, k)
        base = self._oracle_base()
        if base is None:
            return None
        dev = self._device
        if plan.spec is not None:
            mask = np.asarray(self.planner._mask_for(plan.spec), bool)
            pids = np.nonzero(mask)[0]
            if pids.size == 0:
                return np.empty((q.shape[0], 0), np.int64)
            rows = base[torch.as_tensor(pids, device=base.device)] \
                if torch.is_tensor(base) else base[pids]
            nn = exact_knn(q, rows, k, self.metric, device=dev)
            return pids[nn].astype(np.int64)
        return exact_knn(q, base, k, self.metric, device=dev).astype(np.int64)

    def release_live_oracle(self) -> None:
        """Drop the merged oracle's device copy of the live vectors (a
        consolidation frees the old base before it builds the new one)."""
        self._live_oracle = None

    def _live_ground_truth(self, plan: QueryPlan, q: np.ndarray, k: int):
        """The merged plan's oracle: exact kNN over the mutable's live
        vectors, in external ids.  On a card the live vectors are copied
        there once per state of the index (its insert, delete and
        consolidation counts), not once a call: at 1M a copy is 512 MB."""
        from repro_torch.core.dataset import exact_knn

        mut = self.planner.mutable
        dev = self._device
        st = mut.stats
        key = (st["inserts"], st["deletes"], st["consolidations"])
        if self._live_oracle is None or self._live_oracle[0] != key:
            self._live_oracle = None      # the old copy goes first
            ext_ids, vecs = mut.live_vectors()
            if dev.type != "cpu":
                vecs = torch.as_tensor(vecs, device=dev)
            self._live_oracle = (key, ext_ids, vecs)
        _, ext_ids, vecs = self._live_oracle
        if plan.spec is not None:
            _, ext_mask = mut.filter_masks(plan.spec)
            keep = np.nonzero(np.asarray(ext_mask, bool)[ext_ids])[0]
            ext_ids = ext_ids[keep]
            vecs = vecs[torch.as_tensor(keep, device=dev)] \
                if torch.is_tensor(vecs) else vecs[keep]
        if ext_ids.size == 0:
            return np.empty((q.shape[0], 0), np.int64)
        nn = exact_knn(q, vecs, k, mut.metric, device=dev)
        return ext_ids[nn].astype(np.int64)

    @property
    def _device(self) -> torch.device:
        if self.planner.mutable is not None:
            return torch.device(self.planner.mutable.device)
        t = self.planner.corpus if self.planner.corpus is not None \
            else self.planner.tiled
        return t.base.device

    def _oracle_base(self):
        """Base vectors in the target's internal (reordered) id space — host
        numpy on the CPU, a copy on the device, made once, on a card — or
        ``None`` when the opened target carries no raw vectors."""
        idx = self._index
        ds = getattr(idx, "dataset", None) if idx is not None else None
        if ds is not None:
            base = np.asarray(ds.base, np.float32)
        elif self.planner.corpus is not None:
            base = self.planner.corpus.base
        else:
            return None
        if self._device.type == "cpu":
            return base.numpy() if torch.is_tensor(base) else base
        if self._oracle is None:
            self._oracle = torch.as_tensor(base, device=self._device)
        return self._oracle

    # ------------------------------------------------------------ inspection
    @property
    def obs(self) -> Observability:
        return self.planner.obs

    @property
    def cfg(self) -> SearchConfig:
        return self.planner.cfg

    @property
    def metric(self) -> str:
        return self.planner.metric

    @property
    def filter_cfg(self) -> FilterConfig:
        return self.planner.filter_cfg

    @property
    def capabilities(self) -> IndexCapabilities:
        return self.planner.capabilities

    @property
    def attributes(self):
        return self.planner.attributes

    @property
    def corpus(self):
        return self.planner.corpus

    @property
    def tiled(self):
        return self.planner.tiled

    @property
    def probe_tiles(self) -> int:
        return self.planner.probe_tiles

    @property
    def mutable(self):
        return self.planner.mutable

    @property
    def index(self):
        """The served base index — a mutable's latest after a
        consolidation."""
        if self.planner.mutable is not None:
            return self.planner.mutable.base
        return self._index

    def plan_cache_stats(self) -> dict:
        return {"plan_cache_hits": self.planner.plan_cache_hits,
                "plan_cache_misses": self.planner.plan_cache_misses}


def _is_mutable(obj) -> bool:
    return hasattr(obj, "delta") and hasattr(obj, "tombstones") \
        and hasattr(obj, "base")


def _is_sharded_corpus(obj) -> bool:
    return hasattr(obj, "num_shards") and hasattr(obj, "hot_adjacency")


def _is_tiled(obj) -> bool:
    return hasattr(obj, "tile_ids") and hasattr(obj, "entry_points")


def _is_segmented(obj) -> bool:
    """Segment-built index: per-segment mini-indexes + shared codebook, no
    single flat graph (``core.segmented.SegmentedIndex``)."""
    return hasattr(obj, "segments") and hasattr(obj, "codebook") \
        and not hasattr(obj, "graph")
