"""Online result-quality observability: shadow-recall estimation + SLOs;
copy of ``src/repro/obs/quality.py`` (numpy).  The port's oracle
(``Searcher.shadow_ground_truth``) runs its exact kNN on the searcher's
device.

Production serving has no ground truth, so "what recall are we actually
delivering?" is unanswerable from the request path alone.  This module
answers it the way the large-scale ANN serving literature does — by
*shadowing*: a :class:`QualityMonitor` deterministically samples a small
fraction of live requests and replays them OFF-PATH against an exact
brute-force oracle (``core.dataset.exact_knn`` over the same population the
plan searched — tombstone-aware for merged plans, filter-aware for
masked/scan plans), then publishes the running recall estimate with a
Wilson-score confidence interval into the shared ``MetricsRegistry``::

    obs = Observability.on(quality=True, quality_sample_rate=0.05)
    eng = ServingEngine(idx, obs=obs, slo={None: SLOTarget(recall_floor=0.8,
                                                           p99_latency_ms=50)})
    ... serve ...
    obs.quality.overall()        # {'estimate': .91, 'ci_low': .88, ...}
    obs.metrics.gauge_value("recall_estimate", kind="flat", strategy="none")
    eng.stats["slo_violations"]

Sampling is a seeded PCG64 stream indexed by the monitor's request sequence
number, so a replayed workload samples the *same* requests regardless of how
the engine batched them — estimates are reproducible, and
``benchmarks/serving_bench --quality`` asserts the estimate lands within its
own CI of the true (full ground-truth) recall.

:class:`SLOTracker` evaluates per-tenant targets (recall floor, p99 latency
ceiling) over rolling windows: every recorded observation re-evaluates its
tenant's window and, while the window statistic is in breach, bumps a
burn-rate-style ``slo_violations{tenant,slo}`` counter (plus a
``slo_burn_rate`` gauge — error-budget consumption rate, 1.0 = exactly on
budget).  Boundary values are NOT violations: a window p99 exactly at the
ceiling, or a window recall exactly at the floor, passes.

Both classes follow the ``nand_bridge`` contract: they never raise into the
serving path (oracle failures are counted, not thrown) and they exist only
when explicitly enabled — the default ``NULL_OBS`` bundle carries neither.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from collections import deque
from typing import Deque, Dict, Optional

import numpy as np


def wilson_interval(hits: float, trials: float, z: float = 1.96
                    ) -> tuple[float, float]:
    """Wilson score interval for a binomial proportion — well-behaved at the
    extremes (p near 0/1, few trials) where the normal approximation's
    interval escapes [0, 1].  Returns the vacuous (0, 1) for zero trials."""
    if trials <= 0:
        return 0.0, 1.0
    p = hits / trials
    z2 = z * z
    denom = 1.0 + z2 / trials
    center = (p + z2 / (2.0 * trials)) / denom
    half = z * math.sqrt(p * (1.0 - p) / trials
                         + z2 / (4.0 * trials * trials)) / denom
    return max(0.0, center - half), min(1.0, center + half)




# --------------------------------------------------------------------- SLOs
@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """Per-tenant service-level objectives.  ``None`` fields are untracked."""
    recall_floor: Optional[float] = None      # rolling recall must stay >=
    p99_latency_ms: Optional[float] = None    # rolling window p99 must stay <=


class SLOTracker:
    """Rolling-window SLO evaluation, one window pair per tenant.

    ``record_latency`` feeds every completed request; ``record_recall`` feeds
    the shadow-recall samples the :class:`QualityMonitor` produces (recall is
    only observable where ground truth was computed).  Evaluation happens on
    record — an empty window never evaluates, so it never violates."""

    def __init__(self, metrics, targets: Dict[Optional[str], SLOTarget],
                 window: int = 256, min_samples: int = 8):
        self.metrics = metrics
        self.targets = dict(targets or {})
        self.window = int(window)
        # windows below this depth have meaningless statistics — a p99 of
        # three points, or a recall mean of one all-or-nothing query (per-
        # query recall is bimodal, so a single sampled miss would burn the
        # whole budget); both window kinds evaluate only once this deep
        self.min_samples = int(min_samples)
        self._lat: Dict[Optional[str], Deque[float]] = {}
        self._rec: Dict[Optional[str], Deque[float]] = {}
        self.total_violations = 0

    def target_for(self, tenant: Optional[str]) -> Optional[SLOTarget]:
        return self.targets.get(tenant)

    # ------------------------------------------------------------ recording
    def record_latency(self, tenant: Optional[str], ms: float) -> None:
        tgt = self.target_for(tenant)
        if tgt is None or tgt.p99_latency_ms is None:
            return
        w = self._lat.setdefault(tenant, deque(maxlen=self.window))
        w.append(float(ms))
        if len(w) < self.min_samples:
            return
        arr = np.fromiter(w, float, len(w))
        p99 = float(np.percentile(arr, 99))
        # burn rate: fraction of the window over the ceiling, normalized by
        # the 1% budget a p99 target implies (1.0 = exactly on budget)
        burn = float((arr > tgt.p99_latency_ms).mean()) / 0.01
        self.metrics.gauge("slo_window_p99_ms", p99, tenant=tenant)
        self.metrics.gauge("slo_burn_rate", burn, tenant=tenant,
                           slo="latency_p99")
        if p99 > tgt.p99_latency_ms:          # boundary value passes
            self.total_violations += 1
            self.metrics.counter("slo_violations", tenant=tenant,
                                 slo="latency_p99")

    def record_recall(self, tenant: Optional[str], value: float) -> None:
        tgt = self.target_for(tenant)
        if tgt is None or tgt.recall_floor is None:
            return
        w = self._rec.setdefault(tenant, deque(maxlen=self.window))
        w.append(float(value))
        if len(w) < self.min_samples:
            return
        est = float(np.mean(np.fromiter(w, float, len(w))))
        # budget here is the tolerated recall shortfall (1 - floor); a
        # window estimate at floor - (1 - floor) burns at 1.0
        gap = max(0.0, tgt.recall_floor - est)
        burn = gap / max(1.0 - tgt.recall_floor, 1e-9)
        self.metrics.gauge("slo_window_recall", est, tenant=tenant)
        self.metrics.gauge("slo_burn_rate", burn, tenant=tenant,
                           slo="recall_floor")
        if est < tgt.recall_floor:            # boundary value passes
            self.total_violations += 1
            self.metrics.counter("slo_violations", tenant=tenant,
                                 slo="recall_floor")

    # ------------------------------------------------------------ inspection
    def status(self) -> dict:
        """Current window statistics per tracked tenant (for snapshots and
        admin endpoints); tenants with empty windows report ``samples: 0``
        and no breach."""
        out = {}
        for tenant, tgt in self.targets.items():
            lat = self._lat.get(tenant)
            rec = self._rec.get(tenant)
            entry: dict = {"target": dataclasses.asdict(tgt),
                           "latency_samples": len(lat) if lat else 0,
                           "recall_samples": len(rec) if rec else 0}
            if lat and len(lat) >= self.min_samples:
                entry["window_p99_ms"] = float(
                    np.percentile(np.fromiter(lat, float, len(lat)), 99))
            if rec:
                entry["window_recall"] = float(
                    np.mean(np.fromiter(rec, float, len(rec))))
            out[tenant] = entry
        return out


# ------------------------------------------------------------ shadow recall
class QualityMonitor:
    """Seeded shadow-recall estimator over live serving traffic.

    ``observe`` is called once per completed batch (engine flush/retire, or
    ``Searcher.search``) with the batch's plan, queries and result ids.  It
    advances the sampling stream one draw per request, replays the sampled
    subset against ``Searcher.shadow_ground_truth`` (the exact oracle in the
    plan's own result-id space) and accumulates hits/trials per
    (kind, strategy, tenant) cell, publishing::

        recall_estimate{kind,strategy,tenant}           running estimate
        recall_estimate_ci_low / _ci_high{...}          95% Wilson bounds
        shadow_samples / shadow_trials / shadow_hits    counters
        shadow_unsupported / shadow_errors              skipped requests

    The stream position depends only on how many requests were observed
    before this one — not on batch boundaries — so a replayed workload
    samples identically however the scheduler packed it."""

    def __init__(self, metrics, *, sample_rate: float = 0.05, seed: int = 0):
        self.metrics = metrics
        self.sample_rate = float(sample_rate)
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self._seq = 0                       # requests observed (stream pos)
        self._paused = 0
        self.slo: Optional[SLOTracker] = None
        # (kind, strategy, tenant) -> [hits, trials, samples, recall_sum]
        self._cells: Dict[tuple, list] = {}
        self.hits = 0
        self.trials = 0
        self.samples = 0
        self._recall_sum = 0.0

    # ------------------------------------------------------------- sampling
    def sample_mask(self, n: int) -> np.ndarray:
        """Deterministic coin flips for the next ``n`` requests; advances the
        stream."""
        self._seq += n
        if n == 0:
            return np.zeros((0,), bool)
        return self._rng.random(n) < self.sample_rate

    @contextlib.contextmanager
    def paused(self):
        """Suspend sampling (no draws, no stream advance) — the engine wraps
        its warm-up searches so synthetic queries never pollute the
        estimate."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # ------------------------------------------------------------ observing
    def observe(self, searcher, plan, queries, ids) -> Optional[dict]:
        """Score one completed batch; returns the batch's shadow stats (or
        ``None`` when nothing was sampled).  Never raises into the serving
        path — oracle failures are counted as ``shadow_errors``."""
        if self._paused:
            return None
        q = np.atleast_2d(np.asarray(queries, np.float32))
        mask = self.sample_mask(q.shape[0])
        if not mask.any():
            return None
        labels = dict(kind=plan.kind, strategy=plan.strategy,
                      tenant=plan.tenant)
        try:
            return self._replay(searcher, plan, q[mask],
                                np.atleast_2d(np.asarray(ids))[mask], labels)
        except Exception:
            self.metrics.counter("shadow_errors", float(mask.sum()), **labels)
            return None

    def _replay(self, searcher, plan, q, pred, labels) -> Optional[dict]:
        gt = searcher.shadow_ground_truth(plan, q)
        if gt is None:
            self.metrics.counter("shadow_unsupported", float(len(q)),
                                 **labels)
            return None
        from repro_torch.core.dataset import recall_hits_per_query

        k = min(int(plan.cfg.k), gt.shape[1])
        if k == 0:            # empty oracle population (e.g. nothing passes
            return None       # the filter) — recall is undefined, skip
        row_hits = recall_hits_per_query(pred[:, :k], gt[:, :k])
        hits, trials, n = int(row_hits.sum()), len(q) * k, len(q)
        rsum = float((row_hits / k).sum())
        cell = self._cells.setdefault(
            (plan.kind, plan.strategy, plan.tenant), [0, 0, 0, 0.0])
        cell[0] += hits
        cell[1] += trials
        cell[2] += n
        cell[3] += rsum
        self.hits += hits
        self.trials += trials
        self.samples += n
        self._recall_sum += rsum
        m = self.metrics
        m.counter("shadow_samples", float(n), **labels)
        m.counter("shadow_trials", float(trials), **labels)
        m.counter("shadow_hits", float(hits), **labels)
        est = cell[0] / cell[1]
        # CI at QUERY granularity: a query's k result slots hit or miss
        # together when its traversal diverges, so trial-level Wilson would
        # be overconfident by up to sqrt(k).  Wilson over the per-query
        # recall mean treats each sampled query as one (fractional) trial —
        # conservative under within-query correlation.
        lo, hi = wilson_interval(cell[3], cell[2])
        m.gauge("recall_estimate", est, **labels)
        m.gauge("recall_estimate_ci_low", lo, **labels)
        m.gauge("recall_estimate_ci_high", hi, **labels)
        if self.slo is not None:
            for h in row_hits:
                self.slo.record_recall(plan.tenant, h / k)
        return {"sampled": n, "hits": hits, "trials": trials,
                "estimate": est, "ci_low": lo, "ci_high": hi}

    # ------------------------------------------------------------ inspection
    def overall(self) -> dict:
        """Running estimate pooled over every label cell."""
        lo, hi = wilson_interval(self._recall_sum, self.samples)
        return {"samples": self.samples, "hits": self.hits,
                "trials": self.trials,
                "estimate": self.hits / self.trials if self.trials else None,
                "ci_low": lo, "ci_high": hi}

    def estimate(self, kind: str, strategy: str,
                 tenant: Optional[str] = None) -> Optional[dict]:
        """Per-cell estimate, or ``None`` if the cell has no samples."""
        cell = self._cells.get((kind, strategy, tenant))
        if cell is None or not cell[1]:
            return None
        lo, hi = wilson_interval(cell[3], cell[2])
        return {"samples": cell[2], "hits": cell[0], "trials": cell[1],
                "estimate": cell[0] / cell[1], "ci_low": lo, "ci_high": hi}
