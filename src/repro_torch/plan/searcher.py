"""``Searcher`` — the host-side query API; port of
``src/repro/plan/searcher.py`` (``open`` on an index, a segment-built
index, a ``Corpus`` or a ``TiledCorpus``; ``search``, ``plan``,
``execute``, ``round_session``).

    s = Searcher.open(index, num_tiles=4, shard_policy="cluster",
                      probe_tiles=2, attributes=store)
    res = s.search(SearchRequest(queries=q, k=10,
                                 filter=FilterSpec.eq("category", 3)))
    res.ids, res.dists                           # (Q, k) numpy
    res.stats.as_dict(), res.plan.kind           # flat | tiled

The search runs on the device of the opened corpus.  ``num_tiles > 1`` on a
flat index partitions it (``ProximaIndex.sharded_corpus``, per-tile graphs
rebuilt on the device); a ``core.segmented.SegmentedIndex`` is served
through its segments as tiles.  ``obs=`` takes an ``obs.Observability``
bundle (or an ``ObsConfig``): the planner then bills plan-cache traffic and
kernel execution, and with a quality monitor ``search`` feeds the
shadow-recall oracle (``shadow_ground_truth``, an exact kNN on the
searcher's device).  Mutable and distributed targets, the vmapped tile
fan-out and the mesh keywords are not ported yet and raise (ROADMAP Queue 1
items 10, 15 and 19).
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
        """Open a ``ProximaIndex``, a ``SegmentedIndex``, a ``Corpus`` or a
        ``TiledCorpus``.  Keyword arguments override the matching
        ``PlanConfig`` fields; unset fields defer to the index's own config
        (its ``search``/``shard``/``filter`` sections).  ``attributes`` (a
        ``filter.AttributeStore`` keyed by internal id) serves filtered
        requests; an index's own ``attributes`` is the default.  ``obs``
        takes an ``obs.Observability`` bundle or an ``ObsConfig`` (None:
        the shared no-op bundle).  The reference's ``use_vmap`` and its
        mesh keywords (``mesh``, ``mode``, ``data_axis``, ``queue_axis``)
        are accepted and raise, naming the ROADMAP item that ports them."""
        if use_vmap is not None:
            raise NotImplementedError(
                "the vmapped tile fan-out (use_vmap=) is not ported yet: "
                "ROADMAP Queue 1 item 19")
        given = [n for n, v in (("mesh", mesh), ("mode", mode),
                                ("data_axis", data_axis),
                                ("queue_axis", queue_axis)) if v is not None]
        if given:
            raise NotImplementedError(
                f"distributed search ({', '.join(given)}=) is not ported "
                "yet: ROADMAP Queue 1 item 15")
        obs = Observability.resolve(obs)
        pc = plan or PlanConfig()
        kw = dict(search=cfg, num_tiles=num_tiles, shard_policy=shard_policy,
                  probe_tiles=probe_tiles, beam_width=beam_width,
                  filter=filter_cfg, bloom_bits=bloom_bits,
                  num_hashes=num_hashes)
        pc = dataclasses.replace(
            pc, **{k: v for k, v in kw.items() if v is not None})
        if isinstance(index, Corpus):
            return cls._open_corpus(index, pc, metric, attributes, obs)
        if _is_tiled(index):
            return cls._open_tiled(index, pc, metric, attributes, obs)
        if _is_segmented(index):
            return cls._open_segmented(index, pc, metric, attributes, obs)
        if not hasattr(index, "graph"):
            raise NotImplementedError(
                f"{type(index).__name__} targets are not ported yet: mutable "
                "indexes wait for ROADMAP Queue 1 item 10, device meshes for "
                "item 15")
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
        what the plan searched: the attribute-passing subset of the base
        for a filtered plan, otherwise the whole base.  The exact kNN runs
        on the searcher's device (``core.dataset.exact_knn``).  Returns
        ``(Q, k')`` int64 with ``k' = min(plan.cfg.k, population)``, or
        ``None`` for one-shot caller-mask plans and targets with no raw
        vectors."""
        from repro_torch.core.dataset import exact_knn

        if plan.kind not in ("flat", "tiled"):
            raise NotImplementedError(
                f"the shadow oracle of {plan.kind} plans is not ported yet: "
                "ROADMAP Queue 1 item 10 (stream/)")
        if plan.mask_token:
            return None
        base = self._oracle_base()
        if base is None:
            return None
        q = np.atleast_2d(np.asarray(queries, np.float32))
        k = int(plan.cfg.k)
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

    @property
    def _device(self) -> torch.device:
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
    def index(self):
        return self._index

    def plan_cache_stats(self) -> dict:
        return {"plan_cache_hits": self.planner.plan_cache_hits,
                "plan_cache_misses": self.planner.plan_cache_misses}


def _is_tiled(obj) -> bool:
    return hasattr(obj, "tile_ids") and hasattr(obj, "entry_points")


def _is_segmented(obj) -> bool:
    """Segment-built index: per-segment mini-indexes + shared codebook, no
    single flat graph (``core.segmented.SegmentedIndex``)."""
    return hasattr(obj, "segments") and hasattr(obj, "codebook") \
        and not hasattr(obj, "graph")
