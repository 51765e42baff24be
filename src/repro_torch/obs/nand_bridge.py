"""NAND cost-accounting bridge — simulated hardware cost into the registry;
copy of ``src/repro/obs/nand_bridge.py`` over the port's ``nand``.  The
simulator's per-query figures are recorded under their literal names.

Proxima's claims are about where energy and time go in the 3D NAND array;
the serving stack's claims are about host wall-time.  This bridge puts both
in ONE snapshot: after each executed batch, the plan execution's measured
counters are converted to a ``nand.simulator.WorkloadTrace`` (via
``trace_from_plan_execution`` — billing facts read off the plan) and run
through the analytic simulator, and the resulting per-query energy/latency/
transfer figures are recorded next to the host-side queue-wait and latency
histograms, labeled by plan kind / filter strategy / tenant.

Unbillable executions (distributed plans carry no NAND counters; targets
opened without geometry) record a ``nand_unbilled_batches`` counter instead
of raising — observability must never fail the serving path.
"""
from __future__ import annotations

from typing import Optional


def record_plan_execution(metrics, pres, *, index=None, nand=None, eng=None,
                          batch_queries: Optional[int] = None,
                          n_queues: Optional[int] = None):
    """Bill one plan-layer ``SearchResult`` into ``metrics``.

    ``index`` resolves trace geometry (the served ``ProximaIndex``);
    ``nand``/``eng`` override the simulator configs and ``n_queues`` the
    modeled scheduler queue count (Fig. 16 sweeps it through the serving
    path).  Returns the ``SimResult`` (or None when the
    execution is unbillable).
    """
    if not getattr(metrics, "enabled", False):
        return None
    from repro_torch.nand.simulator import (
        simulate, trace_from_plan_execution,
    )

    plan = pres.plan
    labels = dict(kind=plan.kind, strategy=plan.strategy, tenant=plan.tenant)
    try:
        trace = trace_from_plan_execution(pres, index=index)
    except ValueError:
        metrics.counter("nand_unbilled_batches", **labels)
        return None
    kwargs = {}
    if nand is not None:
        kwargs["nand"] = nand
    if eng is not None:
        kwargs["eng"] = eng
    if n_queues is not None:
        kwargs["n_queues"] = n_queues
    sim = simulate(trace, **kwargs)
    fig = sim.metrics()
    metrics.observe("nand_latency_us", fig["nand_latency_us"], **labels)
    metrics.observe("nand_model_qps", fig["nand_model_qps"], **labels)
    metrics.observe("nand_power_w", fig["nand_power_w"], **labels)
    metrics.observe("nand_pj_per_query", fig["nand_pj_per_query"], **labels)
    metrics.observe("nand_transfer_pj_per_query",
                    fig["nand_transfer_pj_per_query"], **labels)
    metrics.observe("nand_core_utilization", fig["nand_core_utilization"],
                    **labels)
    metrics.observe("nand_round_latency_us", fig["nand_round_latency_us"],
                    **labels)
    metrics.observe("nand_overlap_saved_us", fig["nand_overlap_saved_us"],
                    **labels)
    for category, nbytes in sim.traffic_bytes_per_query.items():
        metrics.counter("nand_traffic_bytes", nbytes, category=category,
                        **labels)
    n = batch_queries if batch_queries is not None else pres.stats.queries
    metrics.counter("nand_billed_queries", n, **labels)
    return sim
