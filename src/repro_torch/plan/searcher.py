"""``Searcher`` — the host-side query API; port of
``src/repro/plan/searcher.py`` (``open`` on an index or a ``Corpus``,
``search``, ``plan``, ``execute``, ``round_session``).

    s = Searcher.open(index, attributes=store)   # a repro_torch ProximaIndex
    res = s.search(SearchRequest(queries=q, k=10,
                                 filter=FilterSpec.eq("category", 3)))
    res.ids, res.dists                           # (Q, k) numpy
    res.stats.as_dict(), res.plan.strategy       # none|masked|scan|empty

The search runs on the device of the opened corpus.  Only flat targets are
ported: a mutable, tiled, segmented or distributed target, or a
``PlanConfig`` asking for tiles, raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import (
    FilterConfig, PlanConfig, SearchConfig, upgrade_config,
)
from repro_torch.core.search import Corpus
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
                 index=None):
        self.planner = planner
        self.plan_cfg = plan_cfg
        self._index = index
        self.num_tiles = 1
        self.shard_policy = None

    @classmethod
    def open(cls, index, plan: Optional[PlanConfig] = None, *,
             cfg: Optional[SearchConfig] = None,
             metric: Optional[str] = None,
             attributes=None,
             beam_width: Optional[int] = None,
             bloom_bits: Optional[int] = None,
             num_hashes: Optional[int] = None) -> "Searcher":
        """Open a ``ProximaIndex`` or a ``Corpus``.  Keyword arguments
        override the matching ``PlanConfig`` fields; unset fields defer to
        the index's own config.  ``attributes`` (a ``filter.AttributeStore``
        keyed by internal id) serves filtered requests; an index's own
        ``attributes`` is the default."""
        pc = plan or PlanConfig()
        kw = dict(search=cfg, beam_width=beam_width, bloom_bits=bloom_bits,
                  num_hashes=num_hashes)
        pc = dataclasses.replace(
            pc, **{k: v for k, v in kw.items() if v is not None})
        if (pc.num_tiles or 1) > 1 or pc.probe_tiles:
            raise NotImplementedError(
                "tiled serving is not ported yet: ROADMAP Queue 1 item 11 "
                "(shard/)")
        if isinstance(index, Corpus):
            scfg = cls._resolve_cfg(pc, pc.search or SearchConfig())
            validate_attribute_store(attributes, index.base.shape[0],
                                     "corpus")
            planner = QueryPlanner(
                capabilities=IndexCapabilities(kind="flat"), cfg=scfg,
                metric=metric or "l2",
                filter_cfg=pc.filter or FilterConfig(), plan_cfg=pc,
                corpus=index, attributes=attributes)
            return cls(planner=planner, plan_cfg=pc)
        if not hasattr(index, "graph"):
            raise NotImplementedError(
                f"{type(index).__name__} targets are not ported yet: only a "
                "flat ProximaIndex or Corpus (ROADMAP Queue 1 items 10-11)")
        cfg_full = upgrade_config(index.config)
        scfg = cls._resolve_cfg(pc, cfg_full.search)
        attributes = validate_attribute_store(
            attributes, index.dataset.num_base, "index"
        ) if attributes is not None else index.attributes
        planner = QueryPlanner(
            capabilities=IndexCapabilities(kind="flat"), cfg=scfg,
            metric=metric or index.dataset.metric,
            filter_cfg=pc.filter or cfg_full.filter, plan_cfg=pc,
            corpus=index.corpus(), attributes=attributes)
        return cls(planner=planner, plan_cfg=pc, index=index)

    @classmethod
    def _resolve_cfg(cls, pc: PlanConfig, default: SearchConfig):
        scfg = pc.search or default
        if pc.beam_width is not None:
            scfg = dataclasses.replace(scfg, beam_width=pc.beam_width)
        return scfg

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
        return SearchResult(ids=ex.ids, dists=ex.dists,
                            stats=self.planner.stats_for(plan, ex),
                            plan=plan, raw=ex.raw)

    def round_session(self, plan: QueryPlan):
        """Steppable session for a plan (``None`` when the plan has no
        round-steppable spine) — the continuous engine's entry point."""
        return self.planner.round_session(plan)

    # ------------------------------------------------------------ inspection
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
    def attributes(self):
        return self.planner.attributes

    @property
    def corpus(self):
        return self.planner.corpus

    @property
    def index(self):
        return self._index

    def plan_cache_stats(self) -> dict:
        return {"plan_cache_hits": self.planner.plan_cache_hits,
                "plan_cache_misses": self.planner.plan_cache_misses}
