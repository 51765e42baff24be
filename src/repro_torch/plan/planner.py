"""QueryPlanner — request + index capabilities -> executable ``QueryPlan``;
port of ``src/repro/plan/planner.py`` for the one plan this slice serves:
kind ``flat``, strategy ``none`` (one Algorithm-1 traversal over one corpus).
Filtered, tiled, merged and distributed plans raise, naming the ROADMAP item
that ports them.  The plan cache and ``QueryPlan.cache_key`` (the serving
layer's batching identity) are the reference's.  Observability is not
ported yet (ROADMAP Queue 1 item 12), so nothing is billed or traced.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np

from repro_torch.configs.base import (
    FilterConfig, PlanConfig, SearchConfig, upgrade_config,
)
from repro_torch.plan.request import SearchRequest, SearchStats


@dataclasses.dataclass(frozen=True)
class IndexCapabilities:
    """What the opened index supports (derived once by ``Searcher.open``)."""
    kind: str                        # flat (the only kind ported)
    num_tiles: int = 1


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """One executable strategy.  Frozen and hashable: ``cache_key`` is the
    serving layer's batching identity."""
    kind: str
    strategy: str
    cfg: SearchConfig                # EFFECTIVE config executed
    metric: str
    spec: Optional[Any] = None
    selectivity: float = 1.0
    probe_tiles: int = 0
    num_tiles: int = 1
    attr_bits: int = 0
    pushdown: bool = True
    tenant: Optional[str] = None
    mask_token: int = 0

    @property
    def cache_key(self) -> tuple:
        return (self.kind, self.strategy, self.metric, self.cfg, self.spec,
                self.probe_tiles, self.tenant, self.mask_token)


class Execution(NamedTuple):
    """Executor reply: host arrays + the raw kernel result."""
    ids: np.ndarray
    dists: np.ndarray
    raw: Any
    counters: Any
    selectivity: float
    delta_candidates: float


def _mean_counters(res) -> dict:
    """Per-query mean counters of a core ``SearchResult``."""
    if res is None:
        return {}

    def agg(x):
        return float(x.double().mean())

    return dict(
        hops=agg(res.n_hops), pq=agg(res.n_pq), acc=agg(res.n_acc),
        hot_hops=agg(res.n_hot_hops), free_pq=agg(res.n_free_pq),
        rounds=agg(res.rounds),
    )


class QueryPlanner:
    """Compiles ``SearchRequest`` -> ``QueryPlan`` and executes plans over
    one opened flat corpus.  Owns the plan cache."""

    def __init__(self, *, capabilities: IndexCapabilities, cfg: SearchConfig,
                 metric: str, filter_cfg: FilterConfig, plan_cfg: PlanConfig,
                 corpus=None):
        self.capabilities = capabilities
        self.cfg = cfg
        self.metric = metric
        self.filter_cfg = filter_cfg
        self.plan_cfg = plan_cfg
        self.corpus = corpus
        self._plan_cache: Dict[tuple, QueryPlan] = {}
        self.plan_cache_hits = 0
        self.plan_cache_misses = 0

    # ------------------------------------------------------------- planning
    def plan(self, request: SearchRequest) -> QueryPlan:
        """Compile (or fetch from the plan cache) the plan serving
        ``request``."""
        if request.node_mask is not None or request.filter is not None:
            raise NotImplementedError(
                "filtered plans are not ported yet: ROADMAP Queue 1 item 9 "
                "(filter/)")
        if request.probe_tiles:
            raise NotImplementedError(
                "tile routing is not ported yet: ROADMAP Queue 1 item 11 "
                "(shard/)")
        key = (None, request.k, request.override_items(),
               request.probe_tiles, request.tenant)
        cached = self._plan_cache.get(key)
        if cached is not None:
            self.plan_cache_hits += 1
            return cached
        self.plan_cache_misses += 1
        plan = QueryPlan(kind="flat", strategy="none",
                         cfg=self._effective_cfg(request), metric=self.metric,
                         num_tiles=self.capabilities.num_tiles,
                         tenant=request.tenant,
                         pushdown=bool(self.filter_cfg.pushdown))
        self._plan_cache[key] = plan
        return plan

    def _effective_cfg(self, request: SearchRequest) -> SearchConfig:
        cfg = self.cfg
        if request.k is not None and request.k != cfg.k:
            cfg = dataclasses.replace(cfg, k=int(request.k))
        items = request.override_items()
        if items:
            cfg = dataclasses.replace(cfg, **dict(items))
        return cfg

    # ------------------------------------------------------------ execution
    def execute(self, plan: QueryPlan, queries) -> Execution:
        """Run one plan over a query batch on the corpus's device."""
        from repro_torch.core.search import graph_search

        if (plan.kind, plan.strategy) != ("flat", "none"):
            raise NotImplementedError(
                f"{plan.kind}/{plan.strategy} plans are not ported yet "
                "(ROADMAP Queue 1 items 9-11, 15)")
        pc = self.plan_cfg
        q_np = np.atleast_2d(np.asarray(queries, np.float32))
        res = graph_search(self.corpus, q_np, plan.cfg, self.metric,
                           pc.bloom_bits, pc.num_hashes)
        return Execution(ids=res.ids.cpu().numpy(),
                         dists=res.dists.cpu().numpy(), raw=res,
                         counters=res, selectivity=1.0, delta_candidates=0.0)

    # ----------------------------------------------------------------- stats
    def stats_for(self, plan: QueryPlan, execution: Execution) -> SearchStats:
        return SearchStats(
            queries=int(np.atleast_2d(execution.ids).shape[0]),
            k=plan.cfg.k, kind=plan.kind, strategy=plan.strategy,
            selectivity=float(execution.selectivity),
            delta_candidates=float(execution.delta_candidates),
            beam_width=int(upgrade_config(plan.cfg).beam_width),
            num_tiles=plan.num_tiles, **_mean_counters(execution.counters),
        )
