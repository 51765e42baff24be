"""QueryPlanner — request + index capabilities -> executable ``QueryPlan``;
port of ``src/repro/plan/planner.py`` for flat, tiled, mutable and
distributed targets.

A plan's ``kind`` is its execution spine: ``flat`` (one traversal),
``tiled`` (per-channel fan-out + cross-tile merge, ``shard.
sharded_search_kernel``), ``merged`` (a mutable index: the base search
plus the host delta segment, fused with the tombstones, ``stream.searcher.
merged_search_kernel``) or ``distributed`` (a round-robin ``core.
distributed.ShardedCorpus`` over a device mesh, ``core.distributed.
distributed_search_kernel``: no filter, no caller mask, no counters).  Its
``strategy`` says where the filter runs: ``none``, ``masked`` traversal
(inflated frontier, ``filter.adapt_search_cfg``; on tiles with per-tile
node masks, ``filter.tile_node_masks``), bitmap PQ ``scan``, the ``empty``
short-circuit — the flat selectivity regime switch of ``_filter_strategy``
— or ``adaptive`` (merged plans: the admission mask depends on the live
tombstone set, so the regime is decided at execute time).
``round_session`` gives the steppable form of the flat ``none`` and
``masked`` plans and of merged plans over a flat base whose live regime is
a traversal (``plan.rounds.RoundSession``), which the continuous engine
runs one round at a time; tiled and distributed plans, scans and empty
plans have none (``None``, as in the reference), so the engine flushes
them through the batch path.  The plan cache, ``QueryPlan.cache_key`` (the
serving layer's batching identity) and the per-plan artifact cache
(compiled pass masks) are the reference's.  With an enabled ``obs=`` bundle
the planner counts plan-cache hits, misses and compiled plans and wraps
each execution in a ``kernel-execute`` span and the ``kernel_execute_ms``
histogram, as the reference does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (
    FilterConfig, PlanConfig, SearchConfig, upgrade_config,
)
from repro_torch.filter.spec import FilterSpec
from repro_torch.kernels import ops
from repro_torch.obs import NULL_OBS, Observability
from repro_torch.plan.request import SearchRequest, SearchStats


@dataclasses.dataclass(frozen=True)
class IndexCapabilities:
    """What the opened index supports (derived once by ``Searcher.open``)."""
    kind: str                        # flat | tiled | merged | distributed
    mutable: bool = False
    tiled: bool = False
    num_tiles: int = 1
    mesh_devices: int = 0            # device count (distributed targets)


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """One executable strategy.  Frozen and hashable: ``cache_key`` is the
    serving layer's batching identity and the artifact-cache key."""
    kind: str                        # flat | tiled | merged | distributed
    strategy: str                    # none | masked | scan | empty | adaptive
    cfg: SearchConfig                # EFFECTIVE config executed (adapted)
    metric: str
    spec: Optional[FilterSpec] = None
    selectivity: float = 1.0         # exact passing fraction
    probe_tiles: int = 0
    num_tiles: int = 1
    attr_bits: int = 0
    pushdown: bool = True
    tenant: Optional[str] = None
    mask_token: int = 0              # >0: plan built from a caller mask

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
    """Per-query mean counters of a core ``SearchResult``, read to the host
    in one copy (a sharded result's (P, Q) counters are summed over the
    tiles first: the total cross-channel work per query)."""
    if res is None:
        return {}
    per = res.per_tile if hasattr(res, "per_tile") else res
    fields = torch.stack((per.n_hops, per.n_pq, per.n_acc, per.n_hot_hops,
                          per.n_free_pq, per.rounds)).double()
    if fields.dim() > 2:         # (6, P, Q): total cross-tile work per query
        fields = fields.sum(1)
    means = fields.mean(1).tolist()
    return dict(zip(("hops", "pq", "acc", "hot_hops", "free_pq", "rounds"),
                    means))


def flat_filtered_search(corpus, queries, mask, cfg: SearchConfig,
                         metric: str, filter_cfg: Optional[FilterConfig] = None):
    """Selectivity-adaptive filtered search over a flat corpus through a
    one-off plan — the single regime-decision point.  Returns a
    ``filter.FilteredSearchResult``."""
    fcfg = filter_cfg or FilterConfig()
    planner = QueryPlanner(
        capabilities=IndexCapabilities(kind="flat"), cfg=cfg, metric=metric,
        filter_cfg=fcfg, plan_cfg=PlanConfig(search=cfg, filter=fcfg),
        corpus=corpus,
    )
    request = SearchRequest(queries=queries, node_mask=mask, adaptive=True)
    return planner.execute(planner.plan(request), queries).raw


class QueryPlanner:
    """Compiles ``SearchRequest`` -> ``QueryPlan`` and executes plans over
    one opened flat corpus, tiled corpus, mutable index or sharded corpus
    on a device mesh.  Owns the plan cache and the per-plan artifact cache
    (compiled masks, per-tile mask slices)."""

    def __init__(self, *, capabilities: IndexCapabilities, cfg: SearchConfig,
                 metric: str, filter_cfg: FilterConfig, plan_cfg: PlanConfig,
                 corpus=None, tiled=None, mutable=None, attributes=None,
                 probe_tiles: int = 0, dcorpus=None, mesh=None,
                 obs: Optional[Observability] = None):
        self.capabilities = capabilities
        self.cfg = cfg
        self.metric = metric
        self.filter_cfg = filter_cfg
        self.plan_cfg = plan_cfg
        self.corpus = corpus
        self.tiled = tiled
        self.mutable = mutable
        self.attributes = attributes
        self.probe_tiles = int(probe_tiles or 0)
        self.dcorpus = dcorpus
        self.mesh = mesh
        self._plan_cache: Dict[tuple, QueryPlan] = {}
        self._mask_cache: Dict[FilterSpec, np.ndarray] = {}
        self._artifacts: Dict[tuple, dict] = {}
        self._mask_tokens = 0
        self.plan_cache_hits = 0
        self.plan_cache_misses = 0
        self.obs = obs or NULL_OBS

    # ------------------------------------------------------------- planning
    def plan(self, request: SearchRequest) -> QueryPlan:
        """Compile (or fetch from the plan cache) the plan serving
        ``request``.  Mask requests are compiled fresh — the mask has no
        hashable identity."""
        if request.node_mask is not None:
            return self._plan_for_mask(request)
        spec = request.filter
        if spec is not None and spec.is_all:
            spec = None              # all-pass spec == unfiltered plan
        key = (spec, request.k, request.override_items(),
               request.probe_tiles, request.tenant)
        cached = self._plan_cache.get(key)
        if cached is not None:
            self.plan_cache_hits += 1
            if self.obs.enabled:
                self.obs.metrics.counter("plan_cache_hits",
                                         tenant=request.tenant)
            return cached
        self.plan_cache_misses += 1
        plan = self._compile(spec, request)
        self._plan_cache[key] = plan
        if self.obs.enabled:
            self.obs.metrics.counter("plan_cache_misses",
                                     tenant=request.tenant)
            self.obs.metrics.counter("plans_compiled", kind=plan.kind,
                                     strategy=plan.strategy,
                                     tenant=request.tenant)
        return plan

    def _effective_cfg(self, request: SearchRequest) -> SearchConfig:
        cfg = self.cfg
        if request.k is not None and request.k != cfg.k:
            cfg = dataclasses.replace(cfg, k=int(request.k))
        items = request.override_items()
        if items:
            cfg = dataclasses.replace(cfg, **dict(items))
        return cfg

    def _resolved_probe(self, request: SearchRequest) -> int:
        p = self.probe_tiles if request.probe_tiles is None \
            else int(request.probe_tiles)
        return int(p or 0)

    def _mask_for(self, spec: FilterSpec) -> np.ndarray:
        mask = self._mask_cache.get(spec)
        if mask is None:
            if self.attributes is None:
                raise RuntimeError(
                    "filtered search needs an attribute store — pass "
                    "attributes= to Searcher.open / ServingEngine or attach "
                    "one to the index"
                )
            mask = np.asarray(self.attributes.mask(spec), bool)
            self._mask_cache[spec] = mask
        return mask

    def _filter_strategy(self, mask: np.ndarray, k: int) -> Tuple[str, float]:
        """The selectivity regime switch."""
        n = mask.size
        n_pass = int(mask.sum())
        sel = n_pass / max(n, 1)
        if n_pass == 0:
            return "empty", 0.0
        if sel <= self.filter_cfg.brute_force_selectivity or n_pass <= k:
            return "scan", sel
        return "masked", sel

    def _attr_bits(self) -> int:
        if self.attributes is not None:
            return int(self.attributes.attr_bits)
        return int(self.filter_cfg.attr_bits)

    def _flat_plan(self, mask: np.ndarray, cfg: SearchConfig,
                   **common) -> QueryPlan:
        """The empty / scan / masked plan of a compiled pass mask, with the
        mask cached as its artifact."""
        from repro_torch.filter.traversal import adapt_search_cfg

        strategy, sel = self._filter_strategy(mask, cfg.k)
        eff = adapt_search_cfg(cfg, sel, self.filter_cfg) \
            if strategy == "masked" else cfg
        plan = QueryPlan(kind="flat", strategy=strategy, cfg=eff,
                         selectivity=sel, attr_bits=self._attr_bits(),
                         **common)
        self._artifacts[plan.cache_key] = {"mask": mask}
        return plan

    def _common(self, request: SearchRequest) -> dict:
        return dict(metric=self.metric,
                    probe_tiles=self._resolved_probe(request),
                    num_tiles=self.capabilities.num_tiles,
                    tenant=request.tenant,
                    pushdown=bool(self.filter_cfg.pushdown))

    def _compile(self, spec: Optional[FilterSpec],
                 request: SearchRequest) -> QueryPlan:
        from repro_torch.filter.traversal import (
            adapt_search_cfg, tile_node_masks,
        )

        cfg = self._effective_cfg(request)
        if self.capabilities.kind == "distributed":
            if spec is not None:
                raise NotImplementedError(
                    "the distributed (device-mesh) path has no filtered "
                    "traversal — drop the filter or open a flat/tiled target"
                )
            return QueryPlan(kind="distributed", strategy="none", cfg=cfg,
                             **self._common(request))
        if self.capabilities.mutable:
            # the admission mask depends on the live tombstone set, so the
            # regime is decided inside the merged kernel at execute time
            return QueryPlan(kind="merged",
                             strategy="none" if spec is None else "adaptive",
                             cfg=cfg, spec=spec,
                             attr_bits=self._attr_bits() if spec else 0,
                             **self._common(request))
        kind = "tiled" if self.capabilities.tiled else "flat"
        if spec is None:
            return QueryPlan(kind=kind, strategy="none", cfg=cfg,
                             **self._common(request))
        mask = self._mask_for(spec)
        if kind == "flat":
            return self._flat_plan(mask, cfg, spec=spec,
                                   **self._common(request))
        sel = float(mask.mean())
        plan = QueryPlan(kind="tiled", strategy="masked",
                         cfg=adapt_search_cfg(cfg, sel, self.filter_cfg),
                         spec=spec, selectivity=sel,
                         attr_bits=self._attr_bits(), **self._common(request))
        self._artifacts[plan.cache_key] = {
            "mask": mask,
            "node_masks": tile_node_masks(self.tiled.tile_ids, mask),
        }
        return plan

    def _plan_for_mask(self, request: SearchRequest) -> QueryPlan:
        """Plans for caller-compiled masks.  ``adaptive`` selects the
        regime switch + config adaptation vs the verbatim
        ``graph_search(node_mask=...)`` traversal."""
        kind = self.capabilities.kind
        if kind not in ("flat", "tiled"):
            raise NotImplementedError(
                "precompiled node masks apply to flat or tiled targets only "
                f"(target is {kind}); use FilterSpec requests instead")
        cfg = self._effective_cfg(request)
        self._mask_tokens += 1
        common = dict(self._common(request), mask_token=self._mask_tokens)
        mask = np.asarray(request.node_mask, bool)
        if kind == "tiled":
            # per-tile slices, applied verbatim (the caller adapts the
            # config, as the reference's tiled entry point leaves it to)
            plan = QueryPlan(kind="tiled", strategy="masked", cfg=cfg,
                             selectivity=float(mask.mean()),
                             attr_bits=self._attr_bits(), **common)
            self._artifacts[plan.cache_key] = {"node_masks": mask}
            return plan
        if request.adaptive:
            return self._flat_plan(mask, cfg, **common)
        plan = QueryPlan(kind="flat", strategy="masked", cfg=cfg,
                         selectivity=float(mask.mean()),
                         attr_bits=self._attr_bits(), **common)
        self._artifacts[plan.cache_key] = {"mask": mask}
        return plan

    # -------------------------------------------------------- round stepping
    def round_session(self, plan: QueryPlan):
        """The round-steppable form of ``plan`` (a ``plan.rounds.
        RoundSession``), or ``None`` when the plan has no per-round spine —
        tiled fan-outs, bitmap scans, empty short-circuits, one-shot
        mask-token plans — in which case callers fall back to whole-batch
        ``execute``.  Merged plans decide the live filter regime here, as
        the merged kernel does at execute time, and are steppable only when
        it is a traversal of a single-tile base."""
        from repro_torch.plan.rounds import RoundSession

        if plan.kind == "merged":
            return self._merged_session(plan)
        if plan.kind != "flat" or plan.mask_token \
                or plan.strategy not in ("none", "masked"):
            return None
        pc = self.plan_cfg
        common = dict(planner=self, plan=plan, corpus=self.corpus,
                      cfg=plan.cfg, metric=self.metric,
                      bloom_bits=pc.bloom_bits, num_hashes=pc.num_hashes)
        if plan.strategy == "none":
            return RoundSession(**common)
        return RoundSession(node_mask=self._device_mask(plan),
                            selectivity=plan.selectivity, **common)

    def _merged_session(self, plan: QueryPlan):
        """The merged plan's session over the mutable's current base: the
        base over-fetch k, the merged kernel's own Bloom parameters (its
        ``graph_search`` defaults, not the ``PlanConfig``'s: bit-identity),
        and for a filtered plan the combined filter ∧ ¬tombstone admission
        mask against the live tombstones, pinned for the session."""
        from repro_torch.filter.traversal import adapt_search_cfg
        from repro_torch.plan.rounds import RoundSession

        mut = self.mutable
        if mut is None or getattr(mut, "num_tiles", 1) > 1:
            return None
        k = plan.cfg.k
        k_base = min(plan.cfg.list_size, k + mut.stream_cfg.base_overfetch)
        base_cfg = dataclasses.replace(plan.cfg, k=k_base) \
            if k_base != k else plan.cfg
        common = dict(planner=self, plan=plan, metric=mut.metric,
                      bloom_bits=1 << 17, num_hashes=8, mutable=mut)
        if plan.strategy == "none":
            return RoundSession(corpus=mut.corpus(), cfg=base_cfg, **common)
        fcfg = upgrade_config(mut.base.config).filter
        base_mask, ext_mask = mut.filter_masks(plan.spec)
        base_mask = np.asarray(base_mask, bool)
        n_pass = int(base_mask.sum())
        sel = n_pass / max(base_mask.size, 1)
        if n_pass == 0 or sel <= fcfg.brute_force_selectivity \
                or n_pass <= base_cfg.k:
            return None              # scan / empty regimes: not steppable
        corpus = mut.corpus()
        return RoundSession(
            corpus=corpus, cfg=adapt_search_cfg(base_cfg, sel, fcfg),
            node_mask=torch.as_tensor(base_mask, device=corpus.base.device),
            ext_mask=ext_mask, selectivity=sel, base_mode="traversal",
            **common)

    def _artifacts_for(self, plan: QueryPlan) -> dict:
        """Compiled artifacts for a plan.  Spec-keyed plans keep theirs
        cached; mask-token plans are one-shot, so theirs are popped here."""
        if plan.mask_token:
            return self._artifacts.pop(plan.cache_key, {})
        return self._artifacts.get(plan.cache_key, {})

    def _device_mask(self, plan: QueryPlan) -> torch.Tensor:
        """The plan's pass mask on the corpus's device, copied there once
        per spec-keyed plan."""
        art = self._artifacts_for(plan)
        dev = art.get("mask_on_device")
        if dev is None:
            dev = torch.as_tensor(art["mask"], device=self.corpus.base.device)
            if not plan.mask_token:
                art["mask_on_device"] = dev
        return dev

    # ------------------------------------------------------------ execution
    def execute(self, plan: QueryPlan, queries) -> Execution:
        """Run one plan over a query batch on the corpus's device.

        With observability enabled the dispatch is wrapped in a
        ``kernel-execute`` span and billed into ``kernel_execute_ms``
        (labelled by plan kind / filter strategy / tenant); once the ids
        are on the host the launches' event pairs are read
        (``ops.flush_kernel_timings``)."""
        obs = self.obs
        if not obs.enabled:
            ex = self._execute_plan(plan, queries)
            ops.flush_kernel_timings()   # hooks another bundle installed
            return ex
        t0 = time.perf_counter()
        with obs.tracer.span("kernel-execute", kind=plan.kind,
                             strategy=plan.strategy) as sp:
            ex = self._execute_plan(plan, queries)
            sp.set(queries=int(np.atleast_2d(ex.ids).shape[0]))
        obs.metrics.observe(
            "kernel_execute_ms", (time.perf_counter() - t0) * 1e3,
            kind=plan.kind, strategy=plan.strategy, tenant=plan.tenant,
        )
        obs.metrics.counter("kernel_executions", kind=plan.kind,
                            strategy=plan.strategy, tenant=plan.tenant)
        ops.flush_kernel_timings()
        return ex

    def _execute_plan(self, plan: QueryPlan, queries) -> Execution:
        from repro_torch.core.search import empty_search_result, graph_search
        from repro_torch.filter.traversal import (
            FilteredSearchResult, scan_search,
        )

        pc = self.plan_cfg
        q_np = np.atleast_2d(np.asarray(queries, np.float32))
        if plan.kind == "distributed":
            from repro_torch.core.distributed import distributed_search_kernel

            ids, dists = distributed_search_kernel(
                self.dcorpus, q_np, plan.cfg, self.metric, pc.mode,
                mesh=self.mesh, data_axis=pc.data_axis,
                queue_axis=pc.queue_axis, bloom_bits=pc.bloom_bits,
                num_hashes=pc.num_hashes)
            return Execution(ids=ids.cpu().numpy(), dists=dists.cpu().numpy(),
                             raw=(ids, dists), counters=None,
                             selectivity=1.0, delta_candidates=0.0)
        if plan.kind == "tiled":
            return self._execute_tiled(plan, q_np)
        if plan.kind == "merged":
            from repro_torch.stream.searcher import merged_search_kernel

            res = merged_search_kernel(
                self.mutable, q_np, plan.cfg,
                probe_tiles=plan.probe_tiles or None, filter_spec=plan.spec)
            return Execution(ids=res.ids, dists=res.dists, raw=res,
                             counters=res.base, selectivity=res.selectivity,
                             delta_candidates=float(
                                 np.asarray(res.delta_candidates).mean()))
        if plan.strategy == "none":
            res = graph_search(self.corpus, q_np, plan.cfg, self.metric,
                               pc.bloom_bits, pc.num_hashes)
            return Execution(ids=res.ids.cpu().numpy(),
                             dists=res.dists.cpu().numpy(), raw=res,
                             counters=res, selectivity=1.0,
                             delta_candidates=0.0)
        if plan.strategy == "empty":
            core = empty_search_result(q_np.shape[0], plan.cfg.k,
                                       device=self.corpus.base.device)
            fres = FilteredSearchResult(
                ids=core.ids.cpu().numpy(), dists=core.dists.cpu().numpy(),
                result=core, mode="empty", selectivity=0.0,
                effective=plan.cfg)
        elif plan.strategy == "scan":
            fres = scan_search(self.corpus, q_np,
                               self._artifacts_for(plan)["mask"], plan.cfg,
                               self.metric, self.filter_cfg, plan.selectivity)
        else:                        # masked traversal, plan.cfg pre-adapted
            res = graph_search(self.corpus, q_np, plan.cfg, self.metric,
                               pc.bloom_bits, pc.num_hashes,
                               node_mask=self._device_mask(plan))
            fres = FilteredSearchResult(
                ids=res.ids.cpu().numpy(), dists=res.dists.cpu().numpy(),
                result=res, mode="traversal", selectivity=plan.selectivity,
                effective=plan.cfg)
        return Execution(ids=fres.ids, dists=fres.dists, raw=fres,
                         counters=fres.result, selectivity=fres.selectivity,
                         delta_candidates=0.0)

    def _execute_tiled(self, plan: QueryPlan, q_np: np.ndarray) -> Execution:
        """Fan-out over the tiles + cross-tile merge; a masked plan's
        per-tile node masks go to the tiles' device once per spec-keyed
        plan."""
        from repro_torch.shard.search import sharded_search_kernel

        node_masks = None
        if plan.strategy == "masked":
            art = self._artifacts_for(plan)
            node_masks = art.get("node_masks_on_device")
            if node_masks is None:
                node_masks = torch.as_tensor(art["node_masks"],
                                             device=self.tiled.base.device)
                if not plan.mask_token:
                    art["node_masks_on_device"] = node_masks
        res = sharded_search_kernel(
            self.tiled, q_np, plan.cfg, self.metric,
            use_vmap=self.plan_cfg.use_vmap,
            probe_tiles=plan.probe_tiles or None, node_masks=node_masks)
        return Execution(ids=res.ids.cpu().numpy(),
                         dists=res.dists.cpu().numpy(), raw=res,
                         counters=res, selectivity=plan.selectivity,
                         delta_candidates=0.0)

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
