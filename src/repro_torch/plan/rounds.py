"""Round-stepped plan execution — port of ``src/repro/plan/rounds.py``, the
bridge between the plan layer and the ``core.search`` round-step API.

A :class:`RoundSession` is the steppable form of one flat ``QueryPlan``:
where ``QueryPlanner.execute`` runs the plan's whole traversal, a session
exposes the same traversal one round at a time (``init`` / ``step`` /
``active`` / ``finalize``) so the continuous engine can retire finished
lanes and refill their slots between rounds.  ``complete`` wraps a retired
lane batch into the plan-layer ``SearchResult`` the batch executor returns
for the same queries.

Sessions exist for flat ``none`` (the plain traversal) and flat ``masked``
(masked traversal with the planner-cached mask, held on the corpus's
device).  Merged sessions (the streaming base + delta segment) wait for
ROADMAP Queue 1 item 10 and raise.  ``record_round`` appends per-round
telemetry to an ``obs.ConvergenceLog``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import SearchConfig


class RoundSession:
    """Steppable execution of one ``QueryPlan``.  Create via
    ``QueryPlanner.round_session(plan)``.  ``step`` updates the state's
    Bloom bits in place: step each state once and keep only the result."""

    def __init__(self, *, planner, plan, corpus, cfg: SearchConfig,
                 metric: str, bloom_bits: int, num_hashes: int,
                 node_mask: Optional[torch.Tensor] = None,
                 selectivity: float = 1.0):
        if plan.kind != "flat":
            raise NotImplementedError(
                f"{plan.kind} round sessions are not ported yet: ROADMAP "
                "Queue 1 item 10 (stream/) brings merged sessions")
        self.planner = planner
        self.plan = plan
        self.corpus = corpus
        self.cfg = cfg                  # EFFECTIVE traversal config
        self.metric = metric
        self.bloom_bits = int(bloom_bits)
        self.num_hashes = int(num_hashes)
        self._mask = node_mask
        self.selectivity = float(selectivity)

    # ------------------------------------------------------------- stepping
    def init(self, queries):
        """Round 0 for a (Q, D) batch -> ``core.search.SearchState``."""
        from repro_torch.core.search import init_search_state

        q = np.atleast_2d(np.asarray(queries, np.float32))
        return init_search_state(self.corpus, q, self.cfg, self.metric,
                                 self.bloom_bits, self.num_hashes, self._mask)

    def step(self, state):
        """ONE traversal round over every lane; quiet lanes pass through."""
        from repro_torch.core.search import graph_search_step

        return graph_search_step(self.corpus, state, self.cfg, self.metric,
                                 self.bloom_bits, self.num_hashes, self._mask)

    def active(self, state) -> np.ndarray:
        """(Q,) bool host array — lanes with rounds still to run (one
        device-to-host read)."""
        from repro_torch.core.search import search_state_active

        return search_state_active(state, self.cfg).cpu().numpy()

    def rounds(self, state) -> np.ndarray:
        """(Q,) int host array — rounds each lane has executed so far."""
        return state.lanes.rounds.cpu().numpy()

    def finalize(self, state):
        """Beta rerank + top-k over the batch -> core ``SearchResult``."""
        from repro_torch.core.search import finalize_search

        return finalize_search(self.corpus, state, self.cfg, self.metric,
                               self._mask)

    def record_round(self, log, qids, state, select=None) -> None:
        """Append one per-round telemetry record per (selected) lane to an
        ``obs.convergence.ConvergenceLog`` — the engine's tick path and the
        off-line collector (``obs.convergence.trace_session``) share this, so
        the feature extraction has one owner (the session knows the
        effective k).  The lanes come to the host in one copy."""
        log.record_lanes(qids, state, int(self.cfg.k), select=select)

    # -------------------------------------------------------------- retire
    def complete(self, queries, core_res):
        """Wrap a finalized lane batch into the plan-layer ``SearchResult``
        the batch executor would have returned for the same queries."""
        from repro_torch.plan.planner import Execution
        from repro_torch.plan.request import SearchResult as PlanSearchResult

        plan = self.plan
        ids, dists = core_res.ids.cpu().numpy(), core_res.dists.cpu().numpy()
        if plan.strategy == "masked":
            from repro_torch.filter.traversal import FilteredSearchResult

            raw = FilteredSearchResult(
                ids=ids, dists=dists, result=core_res, mode="traversal",
                selectivity=plan.selectivity, effective=plan.cfg)
            ex = Execution(ids=ids, dists=dists, raw=raw, counters=core_res,
                           selectivity=plan.selectivity, delta_candidates=0.0)
        else:
            ex = Execution(ids=ids, dists=dists, raw=core_res,
                           counters=core_res, selectivity=1.0,
                           delta_candidates=0.0)
        stats = self.planner.stats_for(plan, ex)
        return PlanSearchResult(ids=ex.ids, dists=ex.dists, stats=stats,
                                plan=plan, raw=ex.raw)
