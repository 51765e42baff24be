"""The port's observability (``repro_torch.obs``) against the reference's
(``repro.obs``) on the CPU, on ``tiny_index`` carried across with
``port_index``.

The registry, tracer, quality and convergence modules are copies, so the
same observations give the same snapshots.  Served end to end, both
engines (batch and continuous, flat with a masked filter mix and tiled)
with ``Observability.on(quality=True, quality_sample_rate=1.0)`` give
snapshots with the reference's metric names and labels, apart from the
renamed rebuild gauges (``kernel_builds`` / ``kernel_build_growth`` for
``jit_cache_entries`` / ``jit_cache_growth``) and the port's ``kernel_*``
hook metrics (the reference's jnp path calls no kernel wrapper); the
plan-cache, ``kernel_executions``, ``nand_billed_queries``, ``shadow_*``
and ``tile_lanes_*`` counters are equal, and the ``nand_*`` histograms
equal to rtol 1e-6.  Observability changes no id or distance."""
import dataclasses
import types
import warnings

import numpy as np
import pytest
import torch

from _torch_port import port_index
from repro.core.segmented import SegmentedIndex as RefSegmentedIndex
from repro.filter import FilterSpec as RefSpec
from repro.filter import random_attributes as ref_random_attributes
from repro.obs import ConvergenceLog as RefConvergenceLog
from repro.obs import MetricsRegistry as RefRegistry
from repro.obs import Observability as RefObservability
from repro.obs import SLOTarget as RefSLOTarget
from repro.obs import SLOTracker as RefSLOTracker
from repro.obs import trace_session as ref_trace_session
from repro.obs import wilson_interval as ref_wilson
from repro.plan import Searcher as RefSearcher
from repro.plan import SearchRequest as RefRequest
from repro.serve.engine import ServingEngine as RefEngine
from repro.stream import MutableIndex as RefMutable
from repro_torch.configs.base import ObsConfig
from repro_torch.core.segmented import SegmentedIndex
from repro_torch.filter import FilterSpec, random_attributes
from repro_torch.kernels import loader, ops
from repro_torch.obs import (
    NULL_OBS, NULL_REGISTRY, ConvergenceLog, KernelWatch, MetricsRegistry,
    Observability, RecompileWarning, SLOTarget, SLOTracker,
    default_kernel_sources, record_plan_execution, trace_session,
    wilson_interval,
)
from repro_torch.plan import Searcher, SearchRequest
from repro_torch.serve import ServingEngine
from repro_torch.shard import search as shard_search
from repro_torch.stream import MutableIndex

SCHEMA = {"category": 8, "price": 1000}
# names the port renames, and the port-only kernel hook metrics
RENAMED = {"jit_cache_entries": "kernel_builds",
           "jit_cache_growth": "kernel_build_growth"}
PORT_ONLY = {"kernel_calls", "kernel_wall_ms", "kernel_launches"}
EQUAL_COUNTERS = ("plan_cache_hits", "plan_cache_misses", "plans_compiled",
                  "kernel_executions", "nand_billed_queries",
                  "nand_unbilled_batches", "shadow_samples", "shadow_trials",
                  "shadow_hits", "shadow_unsupported", "shadow_errors",
                  "tile_lanes_served", "tile_lanes_skipped")
NAND_HISTS = ("nand_latency_us", "nand_model_qps", "nand_power_w",
              "nand_pj_per_query", "nand_transfer_pj_per_query",
              "nand_core_utilization", "nand_round_latency_us",
              "nand_overlap_saved_us")
OPS_PLAIN = {"pq_adt_plain": "pq_adt", "pq_lookup_plain": "pq_lookup",
             "pq_lookup_gather_plain": "pq_lookup",
             "bitonic_sort_pairs_plain": "bitonic_sort_pairs",
             "bitonic_merge_topl_plain": "bitonic_sort_pairs",
             "l2_rerank_plain": "l2_rerank",
             "l2_rerank_masked_plain": "l2_rerank"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's tiny tensors: the suite runs
    in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clear_hooks():
    """Engines install process-wide kernel hooks; clear them after each
    test so no other test records into this one's registry."""
    yield
    NULL_OBS.install_kernel_hooks()
    RefObservability.off().install_kernel_hooks()


@pytest.fixture(scope="module")
def tiny_port(tiny_index):
    return port_index(tiny_index)


@pytest.fixture(scope="module")
def stores(tiny_index):
    n = tiny_index.dataset.num_base
    return (random_attributes(n, SCHEMA, seed=5),
            ref_random_attributes(n, SCHEMA, seed=5))


# --------------------------------------------------------------------------
# the copied modules: same inputs, same outputs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dist", ["lognormal", "uniform", "exponential"])
def test_registry_snapshot_equals_reference(dist):
    rng = np.random.default_rng(3)
    xs = getattr(rng, dist)(size=2000)
    got, want = MetricsRegistry(), RefRegistry()
    for r in (got, want):
        for i, x in enumerate(xs):
            r.observe("lat_ms", x, kind="flat", tenant=None if i % 3 else "a")
            r.counter("reqs", kind="flat")
        r.gauge("depth", float(len(xs)))
    assert got.snapshot() == want.snapshot()
    assert got.to_json() == want.to_json()
    assert NULL_REGISTRY.snapshot() == {"counters": {}, "gauges": {},
                                        "histograms": {}}


@pytest.mark.parametrize("hits,trials", [(0, 0), (3, 10), (10, 10),
                                         (41.5, 60)])
def test_wilson_interval_equals_reference(hits, trials):
    assert wilson_interval(hits, trials) == ref_wilson(hits, trials)


def test_slo_tracker_equals_reference():
    rng = np.random.default_rng(0)
    lat, rec = rng.lognormal(1.0, 0.7, 300), rng.uniform(0.6, 1.0, 300)
    out = []
    for tracker_cls, target_cls, reg in (
            (SLOTracker, SLOTarget, MetricsRegistry()),
            (RefSLOTracker, RefSLOTarget, RefRegistry())):
        t = tracker_cls(reg, {None: target_cls(recall_floor=0.8,
                                               p99_latency_ms=8.0),
                              "b": target_cls(p99_latency_ms=50.0)},
                        window=64)
        for x, y in zip(lat, rec):
            t.record_latency(None, x)
            t.record_latency("b", x)
            t.record_recall(None, y)
        out.append((t.total_violations, t.status(), reg.snapshot()))
    assert out[0] == out[1]


def test_resolve_accepts_none_bundle_and_obsconfig():
    assert Observability.resolve(None) is NULL_OBS
    live = Observability.on()
    assert Observability.resolve(live) is live
    assert Observability.resolve(ObsConfig()) is NULL_OBS
    got = Observability.resolve(ObsConfig(metrics=True, tracing=False,
                                          nand_billing=True))
    assert got.metrics.enabled and not got.tracer.enabled
    assert got.nand_billing
    with pytest.raises(TypeError):
        Observability.resolve(42)


def test_kernelwatch_counts_library_builds(monkeypatch):
    """The twin of the jit-cache watch: the default sources are the four
    libraries' build counts; growth after construction warns once."""
    assert sorted(default_kernel_sources()) == sorted(loader.KERNELS)
    monkeypatch.setattr(loader, "BUILDS", {k: 1 for k in loader.KERNELS})
    r = MetricsRegistry()
    w = KernelWatch(r)
    w.check(0)                                  # no growth: silent
    assert r.gauge_value("kernel_builds", kernel="pq_adt") == 1
    assert r.gauge_value("kernel_build_growth", kernel="pq_adt") == 0
    loader.BUILDS["l2_rerank"] = 3
    with pytest.warns(RecompileWarning, match="built 2 more times"):
        w.check(0)
    assert r.counter_value("unexpected_recompiles", kernel="l2_rerank") == 2
    with warnings.catch_warnings():             # warns once per kernel
        warnings.simplefilter("error", RecompileWarning)
        w.check(0)


# --------------------------------------------------------------------------
# served end to end, against the reference engine
# --------------------------------------------------------------------------

def _serve(engine_cls, index, store, spec_cls, target, continuous):
    """Serve tiny_index's queries (flat: every third masked by a ~25%
    filter) through an engine with quality sampling at rate 1.0; returns
    (engine, obs)."""
    obs_cls = Observability if engine_cls is ServingEngine \
        else RefObservability
    obs = obs_cls.on(quality=True, quality_sample_rate=1.0,
                     convergence=continuous)
    kw = dict(batch_size=8, flush_us=0.0, continuous=continuous, slots=8,
              obs=obs, nand_queues=64)
    if target == "tiled":
        kw.update(num_tiles=2, shard_policy="cluster")
    else:
        kw.update(attributes=store)
    eng = engine_cls(index, **kw)
    spec = spec_cls.range("price", 0, 249)
    for i, v in enumerate(index.dataset.queries):
        eng.submit(v, filter=spec if target == "flat" and i % 3 == 0
                   else None)
    eng.drain()
    return eng, obs


def _cells(snap: dict) -> dict:
    """{(section, name): set of label strings}, with the port's renames."""
    out = {}
    for section, metrics in snap.items():
        for name, cells in metrics.items():
            out[section, RENAMED.get(name, name)] = set(cells)
    return out


@pytest.fixture(scope="module")
def served(tiny_index, tiny_port, stores):
    """{(target, continuous): ((port engine, obs), (reference engine, obs))}."""
    out = {}
    for target in ("flat", "tiled"):
        for continuous in (False, True):
            out[target, continuous] = (
                _serve(ServingEngine, tiny_port, stores[0], FilterSpec,
                       target, continuous),
                _serve(RefEngine, tiny_index, stores[1], RefSpec, target,
                       continuous))
            NULL_OBS.install_kernel_hooks()
            RefObservability.off().install_kernel_hooks()
    return out


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("target", ["flat", "tiled"])
def test_engine_snapshot_matches_reference(served, target, continuous):
    (eng, obs), (ref, ref_obs) = served[target, continuous]
    snap, ref_snap = obs.metrics.snapshot(), ref_obs.metrics.snapshot()
    got, want = _cells(snap), _cells(ref_snap)
    port_only = {k for k in got if k[1] in PORT_ONLY}
    assert port_only >= {("counters", "kernel_calls"),
                         ("histograms", "kernel_wall_ms")}
    want.pop(("counters", "kernel_traces"), None)
    # the rebuild gauges are labelled by library, the reference's by jitted
    # function (sampled only where jax exposes a cache size)
    libraries = {f"kernel={k}" for k in loader.KERNELS}
    for name in RENAMED.values():
        assert got.pop(("gauges", name)) == libraries
        want.pop(("gauges", name), None)
    assert {k: v for k, v in got.items() if k not in port_only} == want
    m, rm = obs.metrics, ref_obs.metrics
    for name in EQUAL_COUNTERS:
        assert snap["counters"].get(name) == ref_snap["counters"].get(name), \
            name
    assert m.counter_total("nand_billed_queries") == \
        len(eng.done)
    assert m.counter_total("nand_unbilled_batches") == 0
    assert m.counter_total("shadow_errors") == 0
    assert m.counter_total("shadow_samples") == len(eng.done)
    for name in NAND_HISTS:
        for label, cell in snap["histograms"][name].items():
            want_cell = ref_snap["histograms"][name][label]
            assert cell["count"] == want_cell["count"], (name, label)
            for stat in ("sum", "min", "max", "p50"):
                np.testing.assert_allclose(cell[stat], want_cell[stat],
                                           rtol=1e-6, err_msg=(name, label))
    for label, v in snap["counters"]["nand_traffic_bytes"].items():
        np.testing.assert_allclose(
            v, ref_snap["counters"]["nand_traffic_bytes"][label], rtol=1e-6)
    assert snap["gauges"]["recall_estimate"] == \
        ref_snap["gauges"]["recall_estimate"]
    assert eng.stats["queries"] == ref.stats["queries"]


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("target", ["flat", "tiled"])
def test_results_bit_equal_with_obs_on_and_off(served, tiny_port, stores,
                                               target, continuous):
    (eng, _), _ = served[target, continuous]
    kw = dict(batch_size=8, flush_us=0.0, continuous=continuous, slots=8)
    if target == "tiled":
        kw.update(num_tiles=2, shard_policy="cluster")
    else:
        kw.update(attributes=stores[0])
    off = ServingEngine(tiny_port, **kw)
    assert off.obs is NULL_OBS
    spec = FilterSpec.range("price", 0, 249)
    for i, v in enumerate(tiny_port.dataset.queries):
        off.submit(v, filter=spec if target == "flat" and i % 3 == 0
                   else None)
    off.drain()
    assert sorted(off.done) == sorted(eng.done)
    for rid, r in off.done.items():
        np.testing.assert_array_equal(eng.done[rid].ids, r.ids)
        np.testing.assert_array_equal(eng.done[rid].dists, r.dists)


def test_engine_trace_nests_spans(tiny_port):
    obs = Observability.on(tracing=True)
    eng = ServingEngine(tiny_port, batch_size=8, flush_us=0.0, obs=obs)
    for v in tiny_port.dataset.queries[:12]:
        eng.submit(v)
    eng.drain()
    evs = obs.tracer.export()["traceEvents"]
    begins = sorted(e["id"] for e in evs if e["ph"] == "b")
    ends = sorted(e["id"] for e in evs if e["ph"] == "e")
    assert begins == ends and len(begins) == 12
    batches = [e for e in evs if e["ph"] == "X" and e["name"] == "batch"]
    assert len(batches) == 2
    for b in batches:
        inner = {e["name"] for e in evs if e["ph"] == "X"
                 and b["ts"] - 1e-6 <= e["ts"]
                 and e["ts"] + e["dur"] <= b["ts"] + b["dur"] + 1e-6}
        assert inner >= {"batch-assembly", "kernel-execute", "post-process",
                         "nand-billing"}


def test_engine_obs_default_off_records_nothing(tiny_port):
    eng = ServingEngine(tiny_port, batch_size=4, flush_us=0.0)
    assert eng.obs is NULL_OBS and ops._obs is None
    for v in tiny_port.dataset.queries[:4]:
        eng.submit(v)
    eng.drain()
    assert NULL_OBS.metrics.snapshot() == {"counters": {}, "gauges": {},
                                           "histograms": {}}
    assert NULL_OBS.tracer.events() == [] and loader.TIMING is None


def test_kernel_calls_equal_the_ports_call_counts(tiny_port, monkeypatch):
    """``kernel_calls{kernel=}`` counts every call of the wrappers, by the
    TPU kernel each ports; on the CPU each call also has one wall time.
    (The CPU search builds its ADTs in the reference's expanded form, not
    through ``ops.pq_adt``: that count is 0 on both sides.)"""
    calls = {k: 0 for k in loader.LAUNCHES}
    for fn, kernel in OPS_PLAIN.items():
        real = getattr(ops, fn)

        def spy(*a, _real=real, _k=kernel, **kw):
            calls[_k] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, fn, spy)
    obs = Observability.on(tracing=False)
    obs.install_kernel_hooks()
    s = Searcher.open(tiny_port, num_tiles=2, obs=obs)
    s.search(SearchRequest(queries=tiny_port.dataset.queries))
    Searcher.open(tiny_port, obs=obs).search(
        SearchRequest(queries=tiny_port.dataset.queries[:5]))
    m = obs.metrics
    assert calls["pq_adt"] == 0 and min(calls.values()) == 0 < \
        sorted(calls.values())[1]
    for kernel, n in calls.items():
        assert m.counter_value("kernel_calls", kernel=kernel) == n, kernel
        h = m.histogram("kernel_wall_ms", kernel=kernel)
        assert (h.count if h is not None else 0) == n, kernel
    assert m.counter_total("kernel_launches") == 0     # no card, no launch


class _Mesh:
    """Stands in for a one-rank device mesh where nothing is executed."""

    def size(self):
        return 1


@pytest.mark.parametrize("keyword,value", [
    ("mesh", _Mesh()), ("mode", "fetch"), ("data_axis", "shards"),
    ("queue_axis", "queues")])
def test_searcher_open_reference_keywords_name_their_item(tiny_port, keyword,
                                                          value):
    """The reference's mesh keywords (item 15, ported): with ``mesh=`` the
    target opens as a distributed searcher, whose plans are
    ``distributed``; ``mode``, ``data_axis`` and ``queue_axis`` land in its
    ``PlanConfig`` and, without a mesh, leave a flat target flat, as in the
    reference."""
    kw = {"mesh": _Mesh(), keyword: value}
    s = Searcher.open(tiny_port, **kw)
    assert s.capabilities.kind == "distributed"
    assert s.capabilities.mesh_devices == 1
    plan = s.plan(SearchRequest(queries=tiny_port.dataset.queries[:1]))
    assert plan.kind == "distributed" and s.round_session(plan) is None
    if keyword != "mesh":
        assert getattr(s.plan_cfg, keyword) == value
        flat = Searcher.open(tiny_port, **{keyword: value})
        assert flat.capabilities.kind == "flat"
        assert getattr(flat.plan_cfg, keyword) == value


@pytest.mark.parametrize("use_vmap,lanes", [(None, [16]), (True, [16]),
                                            (False, [8, 8])])
def test_searcher_open_use_vmap_routes_the_fan_out(tiny_port, monkeypatch,
                                                   use_vmap, lanes):
    """``Searcher.open(use_vmap=)`` is the reference's keyword: it sets
    ``PlanConfig.use_vmap``, and a tiled plan then runs the batched fan-out
    (None or True: one traversal of P x Q lanes) or the unrolled one
    (False: one per tile), with the same ids.  ``ServingEngine(num_tiles=)``
    takes the batched one."""
    from repro_torch.serve import ServingEngine
    from repro_torch.shard import search as shard_search

    seen = []
    real = shard_search.graph_search

    def spy(corpus, queries, *a, **kw):
        res = real(corpus, queries, *a, **kw)
        seen.append(res.ids.shape[0])
        return res

    monkeypatch.setattr(shard_search, "graph_search", spy)
    q = tiny_port.dataset.queries[:8]
    s = Searcher.open(tiny_port, num_tiles=2, use_vmap=use_vmap)
    assert s.plan_cfg.use_vmap is use_vmap
    got = s.search(SearchRequest(queries=q))
    assert got.plan.kind == "tiled" and seen == lanes
    want = Searcher.open(tiny_port, num_tiles=2, use_vmap=False).search(
        SearchRequest(queries=q))
    np.testing.assert_array_equal(got.ids, want.ids)
    seen.clear()
    eng = ServingEngine(tiny_port, batch_size=8, num_tiles=2)
    for v in q:
        eng.submit(v)
    eng.drain()
    assert seen and set(seen) == {16}       # its warm-up batch included


def test_searcher_shadow_oracle_equals_reference(tiny_index, tiny_port,
                                                 stores):
    """``Searcher.open(obs=)`` samples shadow recall in ``search``; the
    oracle's ids are the reference's (whole base and filtered subset); a
    merged plan's oracle over a static index fails as the reference's does,
    and over a MutableIndex (an insert and a delete applied) it equals the
    reference's: exact kNN over the live vectors, in external ids."""
    q = tiny_index.dataset.queries
    for spec, ref_spec in ((None, None),
                           (FilterSpec.range("price", 0, 249),
                            RefSpec.range("price", 0, 249))):
        obs = Observability.on(tracing=False, quality=True,
                               quality_sample_rate=1.0)
        ref_obs = RefObservability.on(tracing=False, quality=True,
                                      quality_sample_rate=1.0)
        s = Searcher.open(tiny_port, attributes=stores[0], obs=obs)
        rs = RefSearcher.open(tiny_index, attributes=stores[1], obs=ref_obs)
        res = s.search(SearchRequest(queries=q, filter=spec))
        ref_res = rs.search(RefRequest(queries=q, filter=ref_spec))
        np.testing.assert_array_equal(
            s.shadow_ground_truth(res.plan, q),
            rs.shadow_ground_truth(ref_res.plan, q))
        assert obs.quality.overall() == ref_obs.quality.overall()
    for searcher, r in ((s, res), (rs, ref_res)):
        with pytest.raises(AttributeError):
            searcher.shadow_ground_truth(
                dataclasses.replace(r.plan, kind="merged"), q)
    mut, ref_mut = MutableIndex(tiny_port), RefMutable(tiny_index)
    for m in (mut, ref_mut):
        m.insert(q[0] + 1e-3)
        m.delete(int(tiny_index.dataset.gt[1, 0]))
    ms, rms = Searcher.open(mut), RefSearcher.open(ref_mut)
    plan = ms.plan(SearchRequest(queries=q))
    ref_plan = rms.plan(RefRequest(queries=q))
    assert plan.kind == ref_plan.kind == "merged"
    np.testing.assert_array_equal(ms.shadow_ground_truth(plan, q),
                                  rms.shadow_ground_truth(ref_plan, q))


def test_unbillable_execution_counts_not_raises(tiny_index, tiny_port):
    s = Searcher.open(tiny_port.corpus(), cfg=tiny_port.config.search,
                      metric=tiny_port.dataset.metric)
    res = s.search(SearchRequest(queries=tiny_port.dataset.queries[:4]))
    r = MetricsRegistry()
    assert record_plan_execution(r, res, index=None) is None
    assert r.counter_total("nand_unbilled_batches") == 1
    sim = record_plan_execution(r, res, index=tiny_port)
    assert sim is not None and r.counter_total("nand_billed_queries") == 4
    assert record_plan_execution(NULL_REGISTRY, res, index=tiny_port) is None


@pytest.mark.parametrize("beam_width", [1, 4])
def test_trace_session_equals_reference(tiny_index, tiny_port, beam_width):
    """Per-lane rounds, labels and every integer column equal the
    reference's; the distance columns hold to the search's bar against the
    reference (rtol 1e-5 plus 1e-6 of the largest, ROADMAP): the port's
    distances are its own float32 arithmetic."""
    q = tiny_index.dataset.queries
    s = Searcher.open(tiny_port, beam_width=beam_width)
    rs = RefSearcher.open(tiny_index, beam_width=beam_width)
    log, ref_log = ConvergenceLog(1 << 12), RefConvergenceLog(1 << 12)
    _, rounds = trace_session(
        s.round_session(s.plan(SearchRequest(queries=q))), q, log)
    _, ref_rounds = ref_trace_session(
        rs.round_session(rs.plan(RefRequest(queries=q))), q, ref_log)
    np.testing.assert_array_equal(rounds, ref_rounds)
    got, want = log.to_arrays(), ref_log.to_arrays()
    assert got.keys() == want.keys() and log.count == ref_log.count > 0
    for f in got:
        assert got[f].dtype == want[f].dtype, f
        if got[f].dtype == np.float32:
            fin = np.isfinite(want[f])
            np.testing.assert_array_equal(np.isfinite(got[f]), fin, f)
            np.testing.assert_allclose(
                got[f][fin], want[f][fin], rtol=1e-5,
                atol=1e-6 * np.abs(want[f][fin]).max(), err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert log.labels == ref_log.labels


def test_convergence_log_holds_one_record_per_lane_round(tiny_port):
    obs = Observability.on(tracing=False, convergence=True)
    eng = ServingEngine(tiny_port, batch_size=8, continuous=True, slots=8,
                        obs=obs)
    stepped = 0
    for v in tiny_port.dataset.queries:
        eng.submit(v)
    while eng.queue or eng.inflight():
        done = eng.step(force=True)
        stepped += eng.inflight() + len(done)
    log = obs.convergence
    assert log.count == stepped == sum(log.labels.values())
    assert len(log.labels) == len(tiny_port.dataset.queries)
    hist = obs.metrics.merged_histogram("rounds_in_flight")
    assert hist.count == len(tiny_port.dataset.queries)


@pytest.mark.parametrize("segments,stitched", [((1500,), None),
                                               ((600, 500, 400), 97)])
def test_build_trace_equals_reference(segments, stitched):
    """``SegmentedIndex.build_trace`` carries the segment sizes and the
    stitch's patched rows, as the reference's does on the same index."""
    seg = [types.SimpleNamespace(num_vertices=n,
                                 base=np.zeros((n, 24), np.float32),
                                 codes=np.zeros((n, 12), np.uint8))
           for n in segments]
    fake = types.SimpleNamespace(
        segments=seg,
        stitch=None if stitched is None
        else types.SimpleNamespace(patched_rows=stitched),
        config=types.SimpleNamespace(
            graph=types.SimpleNamespace(max_degree=20)))
    got = SegmentedIndex.build_trace(fake, index_bits=21)
    want = RefSegmentedIndex.build_trace(fake, index_bits=21)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.segment_sizes == segments
    assert got.stitched_rows == (stitched or 0)


def test_channel_stats_hook(tiny_port):
    """Routed to one of two tiles, half the (tile, query) lanes are
    skipped; the hook records nothing once cleared."""
    obs = Observability.on(tracing=False)
    shard_search.set_observability(obs)
    s = Searcher.open(tiny_port, num_tiles=2, shard_policy="cluster",
                      probe_tiles=1)
    s.search(SearchRequest(queries=tiny_port.dataset.queries[:6]))
    m = obs.metrics
    assert m.counter_total("tile_lanes_served") == 6
    assert m.counter_total("tile_lanes_skipped") == 6
    assert m.gauge_value("tile_load_imbalance") >= 1.0
    shard_search.set_observability(None)
    s.search(SearchRequest(queries=tiny_port.dataset.queries[:6]))
    assert m.counter_total("tile_lanes_served") == 6
