"""The port's streaming mutable index (``repro_torch.stream``), its merged
plans and the engines' insert/delete/consolidate path against the reference
(``repro.stream``) on the CPU, on ``tests/test_stream.py``'s 900 x 32
corpus (built by the reference and carried across with ``port_index``),
and the incremental Vamana build and ``EmbeddingRetriever`` beside them.

Bars: the incremental graph and the delta segment bit for bit (numpy
copies); merged ids and delta candidates equal before a consolidation,
distances to rtol 1e-5 plus 1e-6 of the largest (the search bar of
ROADMAP), flat, filtered and tiled; the engines' ids and counters equal
the reference engines'.  A consolidation rebuilds with the port's own
build (0.9973 of adjacency rows identical to the reference's, not bit for
bit), so after one the bar is recall@10 against the live exact kNN within
0.02 of the reference's, the same live external ids, no tombstones, equal
logical bytes and write amplification within 1%."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import port_index, port_tiled
from repro.configs.base import (
    DatasetConfig, GraphConfig, PQConfig, ProximaConfig, SearchConfig,
    StreamConfig,
)
from repro.configs.base import GraphConfig as RefGraphConfig
from repro.core import build_index as ref_build_index
from repro.core.dataset import exact_knn as ref_exact_knn
from repro.core.graph import build_incremental as ref_build_incremental
from repro.filter import FilterSpec as RefSpec
from repro.filter import random_attributes as ref_random_attributes
from repro.serve.engine import ServingEngine as RefEngine
from repro.serve.retrieval import EmbeddingRetriever as RefRetriever
from repro.stream import DeltaSegment as RefDelta
from repro.stream import MutableIndex as RefMutable
from repro.stream import merged_search_kernel as ref_merged
from repro_torch.configs.base import GraphConfig as PortGraphConfig
from repro_torch.configs.base import StreamConfig as PortStreamConfig
from repro_torch.core.dataset import recall_at_k
from repro_torch.core.graph import build_graph, build_incremental
from repro_torch.filter import FilterSpec, random_attributes
from repro_torch.plan import Searcher, SearchRequest
from repro_torch.serve import ServingEngine
from repro_torch.serve.retrieval import EmbeddingRetriever
from repro_torch.stream import (
    DeltaSegment, MergedResult, MutableIndex, merged_search_kernel,
    search_merged,
)
from repro_torch.stream.searcher import merge_order

SCHEMA = {"category": 8, "price": 1000}
# unfiltered, masked ~25%, scan ~1.5%, empty
SPECS = {"none": None, "masked": (0, 249), "scan": (0, 14),
         "empty": (1000, None)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's tiny tensors (the suite runs
    in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream_cfg():
    return ProximaConfig(
        dataset=DatasetConfig(name="sift-like", num_base=900, num_queries=24,
                              dim=32, num_clusters=10, cluster_std=0.25,
                              seed=3),
        pq=PQConfig(num_subvectors=8, num_centroids=64, kmeans_iters=6),
        graph=GraphConfig(max_degree=16, build_list_size=32, alpha=1.2),
        search=SearchConfig(k=10, list_size=64, t_init=16, t_step=8,
                            repetition_rate=3, beta=1.06),
        stream=StreamConfig(delta_capacity=512, consolidate_fraction=0.6,
                            delta_list_size=32, brute_force_below=32,
                            base_overfetch=16),
        hot_node_fraction=0.03,
    )


@pytest.fixture(scope="module")
def stream_index(stream_cfg):
    return ref_build_index(stream_cfg, reorder_samples=16)


@pytest.fixture(scope="module")
def stream_port(stream_index):
    return port_index(stream_index)


def _perturbed(base, n, rng, scale=0.1):
    picks = base[rng.choice(base.shape[0], n)]
    return (picks + scale * rng.standard_normal(picks.shape)).astype(
        np.float32)


def _updated_pair(ref_idx, port_idx, n_ins=60, n_del=45, seed=7,
                  attributes=False):
    """A reference and a port MutableIndex after the same inserts and
    deletes (with attribute rows when ``attributes``)."""
    n = ref_idx.dataset.num_base
    kw = {}
    rkw = {}
    if attributes:
        kw["attributes"] = random_attributes(n, SCHEMA, seed=11)
        rkw["attributes"] = ref_random_attributes(n, SCHEMA, seed=11)
    rm, pm = RefMutable(ref_idx, **rkw), MutableIndex(port_idx, **kw)
    rng = np.random.default_rng(seed)
    vecs = _perturbed(ref_idx.dataset.base, n_ins, rng)
    rows = rng.integers(0, [8, 1000], size=(n_ins, 2))
    for v, row in zip(vecs, rows):
        attrs = dict(zip(SCHEMA, map(int, row))) if attributes else None
        assert rm.insert(v, attrs=attrs) == pm.insert(v, attrs=attrs)
    dead = rng.choice(n + n_ins, n_del, replace=False)
    for e in dead:
        assert rm.delete(int(e)) == pm.delete(int(e))
    return rm, pm, dead


def _assert_merged_equal(got, want):
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.delta_candidates,
                                  want.delta_candidates)
    fin = np.isfinite(want.dists)
    np.testing.assert_array_equal(np.isfinite(got.dists), fin)
    if fin.any():
        np.testing.assert_allclose(got.dists[fin], want.dists[fin],
                                   rtol=1e-5,
                                   atol=1e-6 * np.abs(want.dists[fin]).max())


# ---------------------------------------------------------------------------
# Incremental Vamana build and the delta segment: numpy copies, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "angular"])
def test_build_incremental_bit_equal(metric):
    rng = np.random.default_rng(4)
    base = rng.standard_normal((300, 16)).astype(np.float32)
    want = ref_build_incremental(base, RefGraphConfig(
        max_degree=12, build_list_size=24, alpha=1.2), metric)
    cfg = PortGraphConfig(max_degree=12, build_list_size=24, alpha=1.2)
    got = build_incremental(base, cfg, metric)
    np.testing.assert_array_equal(got.adjacency, want.adjacency)
    np.testing.assert_array_equal(got.degrees, want.degrees)
    assert got.entry_point == want.entry_point
    # build_graph routes to it, on the host, for any device
    routed = build_graph(base, cfg, metric, method="incremental",
                         device="cuda")
    np.testing.assert_array_equal(routed.adjacency, want.adjacency)


@pytest.mark.parametrize("count", [20, 150])
def test_delta_segment_bit_equal(count):
    """Same inserts, same graph and codes; ``search_batch`` and ``search``
    return the reference's ids below ``brute_force_below`` (the exact scan)
    and above it (the greedy graph search)."""
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((count, 16)).astype(np.float32)
    cents = rng.standard_normal((4, 16, 4)).astype(np.float32)
    ref = RefDelta(dim=16, metric="l2", centroids=cents,
                   graph_cfg=RefGraphConfig(max_degree=12,
                                            build_list_size=24),
                   stream_cfg=StreamConfig(delta_capacity=256,
                                           delta_list_size=32,
                                           brute_force_below=32))
    got = DeltaSegment(dim=16, metric="l2", centroids=cents,
                       graph_cfg=PortGraphConfig(max_degree=12,
                                                 build_list_size=24),
                       stream_cfg=PortStreamConfig(delta_capacity=256,
                                                   delta_list_size=32,
                                                   brute_force_below=32))
    for v in vecs:
        assert got.insert(v) == ref.insert(v)
    for f in ("adjacency", "degrees", "codes", "vecs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), f)
    assert got.entry_point == ref.entry_point
    assert got._brute_force() == (count <= 32)
    q = vecs[:12] + 0.01 * rng.standard_normal((12, 16)).astype(np.float32)
    for a, b in zip(got.search_batch(q, 10), ref.search_batch(q, 10)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.search(q[0], 5), ref.search(q[0], 5)):
        np.testing.assert_array_equal(a, b)
    assert got.logical_bytes_per_insert() == ref.logical_bytes_per_insert()


# ---------------------------------------------------------------------------
# The merged kernel before a consolidation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", list(SPECS))
def test_merged_search_kernel_matches_reference(stream_index, stream_port,
                                                spec):
    """After the same inserts and deletes: flat unfiltered, and filtered
    under the combined filter ∧ ¬tombstone mask in each base regime."""
    band = SPECS[spec]
    rm, pm, dead = _updated_pair(stream_index, stream_port,
                                 attributes=band is not None)
    q = stream_index.dataset.queries
    fs = None if band is None else FilterSpec.range("price", *band)
    rfs = None if band is None else RefSpec.range("price", *band)
    got = merged_search_kernel(pm, q, filter_spec=fs)
    want = ref_merged(rm, q, filter_spec=rfs)
    _assert_merged_equal(got, want)
    assert isinstance(got, MergedResult) and got.ids.dtype == np.int32
    assert got.base_mode == want.base_mode == (
        "none" if band is None else
        {"masked": "traversal"}.get(spec, spec))
    assert got.selectivity == want.selectivity
    assert not np.isin(got.ids, dead).any()


def test_merged_tiled_matches_reference(stream_index, stream_port):
    """A 2-tile base (the reference's tiles carried across) under a masked
    filter: the fan-out's candidates fused with the delta."""
    rm, pm, _ = _updated_pair(stream_index, stream_port, attributes=True)
    rm.set_num_tiles(2, "cluster")
    pm.set_num_tiles(2, "cluster")
    pm._tiled, _ = port_tiled(rm.tiled_corpus())
    q = stream_index.dataset.queries
    for band in (None, (0, 249)):
        got = merged_search_kernel(
            pm, q, filter_spec=None if band is None
            else FilterSpec.range("price", *band))
        want = ref_merged(
            rm, q, filter_spec=None if band is None
            else RefSpec.range("price", *band))
        _assert_merged_equal(got, want)
    assert got.base.per_tile.ids.shape[0] == 2


@pytest.mark.parametrize("width,k", [(52, 10), (33, 10), (6, 10)])
def test_merge_order_is_the_stable_argsort(width, k):
    """The merge's sort (``bitonic_sort_pairs``, its plain version here)
    gives the reference's ``np.argsort(kind="stable")`` order: ties to the
    lower column (the base's), +inf after every finite key, -0.0 equal to
    +0.0, and rows shorter than k padded past their end."""
    rng = np.random.default_rng(width)
    keys = rng.integers(0, 6, (64, width)).astype(np.float32)
    keys[rng.random(keys.shape) < 0.3] = np.inf
    keys[keys == 0] = np.where(rng.random(int((keys == 0).sum())) < 0.5,
                               -0.0, 0.0)
    keys = np.pad(keys, ((0, 0), (0, max(k - width, 0))),
                  constant_values=np.inf)      # as the merge pads
    order = merge_order(keys, k, "cpu")
    want = np.argsort(keys, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(order, want)


# ---------------------------------------------------------------------------
# Plans, Searcher and the engines
# ---------------------------------------------------------------------------

def test_searcher_plans_merged(stream_index, stream_port):
    rm, pm, _ = _updated_pair(stream_index, stream_port, attributes=True)
    q = stream_index.dataset.queries
    s = Searcher.open(pm)
    assert s.mutable is pm and s.index is pm.base
    assert s.capabilities.mutable and s.capabilities.kind == "merged"
    res = s.search(SearchRequest(queries=q))
    assert (res.plan.kind, res.plan.strategy) == ("merged", "none")
    np.testing.assert_array_equal(res.ids, ref_merged(rm, q).ids)
    spec = FilterSpec.range("price", 0, 249)
    fres = s.search(SearchRequest(queries=q, filter=spec))
    assert fres.plan.strategy == "adaptive"
    np.testing.assert_array_equal(
        fres.ids,
        ref_merged(rm, q, filter_spec=RefSpec.range("price", 0, 249)).ids)
    assert fres.stats.delta_candidates > 0
    np.testing.assert_array_equal(search_merged(pm, q).ids, res.ids)
    with pytest.raises(NotImplementedError, match="flat or tiled"):
        s.search(SearchRequest(queries=q, node_mask=np.ones(900, bool)))


@pytest.mark.parametrize("band", [None, (0, 249)])
def test_merged_round_session_equals_execute(stream_index, stream_port,
                                             band):
    """The steppable merged session (the merged kernel's Bloom parameters,
    the base over-fetch) fused at retire gives the batch execution's ids
    and distances bit for bit."""
    _, pm, _ = _updated_pair(stream_index, stream_port,
                             attributes=band is not None)
    s = Searcher.open(pm)
    q = stream_index.dataset.queries
    req = SearchRequest(queries=q, filter=None if band is None
                        else FilterSpec.range("price", *band))
    plan = s.plan(req)
    sess = s.round_session(plan)
    assert sess.bloom_bits == 1 << 17 and sess.num_hashes == 8
    assert sess.cfg.k == 10 + pm.stream_cfg.base_overfetch
    state = sess.init(q)
    for _ in range(plan.cfg.max_rounds):
        state = sess.step(state)
    res = sess.complete(q, sess.finalize(state))
    ex = s.execute(plan, q)
    np.testing.assert_array_equal(res.ids, ex.ids)
    np.testing.assert_array_equal(res.dists, ex.dists)
    assert res.stats.delta_candidates == ex.delta_candidates
    if band is not None:     # a scan regime has no round spine
        scan = s.plan(SearchRequest(
            queries=q[:1], filter=FilterSpec.range("price", 0, 14)))
        assert s.round_session(scan) is None


def _serve_interleaved(engine, queries, inserts, deletes, continuous):
    """Submits, inserts and deletes interleaved, steps between them."""
    rng = np.random.default_rng(3)
    ins = iter(inserts)
    dels = iter(deletes)
    for i, v in enumerate(queries):
        engine.submit(v)
        if i % 3 == 0:
            engine.insert(next(ins))
        if i % 4 == 1:
            engine.delete(int(next(dels)))
        if continuous or i % 5 == 4:
            engine.step(force=True)
    engine.insert(next(ins))
    engine.delete(int(rng.integers(0, 900)))
    engine.drain()
    return engine


@pytest.mark.parametrize("continuous", [False, True])
def test_streaming_engine_matches_reference(stream_index, stream_port,
                                            continuous):
    """Batch and continuous engines over a MutableIndex, with insert,
    delete and submit interleaved: the reference engines' ids and
    counters; the continuous engine's ids equal the batch engine's."""
    q = np.concatenate([stream_index.dataset.queries] * 2)[:30]
    rng = np.random.default_rng(5)
    inserts = _perturbed(stream_index.dataset.base, 16, rng)
    deletes = rng.choice(900, 12, replace=False)
    kw = dict(batch_size=8, flush_us=1e12, continuous=continuous, slots=4)
    ref = _serve_interleaved(RefEngine(RefMutable(stream_index), **kw), q,
                             inserts, deletes, continuous)
    got = _serve_interleaved(ServingEngine(MutableIndex(stream_port), **kw),
                             q, inserts, deletes, continuous)
    assert sorted(got.done) == sorted(ref.done) == list(range(len(q)))
    for rid, r in ref.done.items():
        np.testing.assert_array_equal(got.done[rid].ids, r.ids)
        fin = np.isfinite(r.dists)
        np.testing.assert_allclose(got.done[rid].dists[fin], r.dists[fin],
                                   rtol=1e-5,
                                   atol=1e-6 * np.abs(r.dists[fin]).max())
    for f in ("inserts", "deletes", "consolidations", "queries", "batches",
              "retired", "ticks", "fallback_batches", "pad_fraction"):
        assert got.stats[f] == ref.stats[f], f
    assert got.index is got.mutable.base


def test_continuous_streaming_consolidation_safety(tiny_index):
    """Consolidation mid-flight: in-flight merged lanes complete against the
    old base BEFORE the rebuild, sessions reset, and post-consolidation
    submits serve correctly against the new id space (the reference's
    ``tests/test_continuous.py`` test, on the port, on the same index)."""
    tiny_port = port_index(tiny_index)
    mut = MutableIndex(tiny_port)
    eng = ServingEngine(mut, batch_size=8, continuous=True, slots=4,
                        auto_consolidate=False)
    q = tiny_port.dataset.queries
    ext = eng.insert(np.asarray(q[0]) + 1e-4)
    eng.delete(3)
    rids = [eng.submit(qq) for qq in q[:6]]
    eng.step(force=True)                       # lanes now mid-traversal
    assert eng.inflight() > 0
    inflight = eng.inflight()
    old_corpus = mut.corpus()
    eng.consolidate()                          # must complete lanes first
    assert eng.inflight() == 0
    assert sum(r in eng.done for r in rids) >= inflight
    assert eng.stats["consolidations"] == 1
    assert mut.corpus() is not old_corpus
    eng.drain()
    assert all(r in eng.done for r in rids)
    for r in rids:
        assert 3 not in set(int(i) for i in eng.done[r].ids)
    r2 = eng.submit(q[0])
    eng.drain()
    assert ext in set(int(i) for i in eng.done[r2].ids)


def test_capacity_forced_consolidation_with_lanes_in_flight(stream_index,
                                                            stream_port):
    """A full delta consolidates inside ``insert``: the lanes in flight
    retire first (against the old base), the engine's index follows the
    rebuild, and the merged sessions reopen on it."""
    mut = MutableIndex(stream_port, stream_cfg=PortStreamConfig(
        delta_capacity=8, consolidate_fraction=0.99, brute_force_below=4,
        base_overfetch=8))
    eng = ServingEngine(mut, batch_size=8, continuous=True, slots=4,
                        auto_consolidate=False)
    rng = np.random.default_rng(17)
    vecs = _perturbed(stream_port.dataset.base, 9, rng)
    for v in vecs[:8]:
        eng.insert(v)
    q = stream_port.dataset.queries
    rids = [eng.submit(v) for v in q[:6]]
    eng.step(force=True)
    flying = [r.rid for p in eng._pools.values() for r in p.requests
              if r is not None]
    assert flying
    eng.insert(vecs[8])                        # the 9th: consolidates first
    assert all(r in eng.done for r in flying)
    assert eng.stats["consolidations"] == 1 and eng.stats["inserts"] == 9
    assert eng.index is mut.base and len(mut.delta) == 1
    assert not eng._pools
    eng.drain()
    assert all(r in eng.done for r in rids)


@pytest.mark.parametrize("trigger", ["consolidate", "insert"])
def test_rebuild_starts_after_the_old_base_is_freed(stream_port, monkeypatch,
                                                    trigger):
    """The old base's corpus, which the continuous engine's merged
    sessions also hold, and the shadow oracle's copy of the live vectors
    are freed before the rebuild allocates the new base: through
    ``engine.consolidate()`` and the capacity-forced consolidation inside
    ``insert``.  Queued requests then open sessions on the new base."""
    import gc
    import weakref

    import repro_torch.stream.mutable as mutable_mod

    mut = MutableIndex(stream_port, stream_cfg=PortStreamConfig(
        delta_capacity=8, consolidate_fraction=0.99, brute_force_below=4,
        base_overfetch=8))
    eng = ServingEngine(mut, batch_size=8, continuous=True, slots=4,
                        auto_consolidate=False)
    vecs = _perturbed(stream_port.dataset.base, 9,
                      np.random.default_rng(17))
    for v in vecs[:8]:
        eng.insert(v)
    q = stream_port.dataset.queries
    rids = [eng.submit(v) for v in q[:6]]
    eng.step(force=True)
    pinned = [weakref.ref(mut.corpus().base)] + [
        weakref.ref(p.session.corpus.base) for p in eng._pools.values()]
    assert len(pinned) > 1
    plan = eng.searcher.plan(SearchRequest(queries=q[:2]))
    eng.searcher.shadow_ground_truth(plan, q[:2])
    assert eng.searcher._live_oracle is not None
    seen = {}
    real_build = mutable_mod.build_index

    def build_index(*a, **k):
        gc.collect()
        seen["old_base_alive"] = any(r() is not None for r in pinned)
        seen["oracle_copy"] = eng.searcher._live_oracle
        return real_build(*a, **k)

    monkeypatch.setattr(mutable_mod, "build_index", build_index)
    if trigger == "insert":
        eng.insert(vecs[8])
    else:
        eng.consolidate()
    assert seen == {"old_base_alive": False, "oracle_copy": None}
    assert eng.stats["consolidations"] == 1
    eng.drain()
    assert all(r in eng.done for r in rids)
    assert all(p.session.corpus is mut.corpus() for p in eng._pools.values())


# ---------------------------------------------------------------------------
# After a consolidation: the port's own rebuild
# ---------------------------------------------------------------------------

def test_consolidation_matches_reference_by_measure(stream_index,
                                                    stream_port):
    rm, pm, dead = _updated_pair(stream_index, stream_port, n_ins=120)
    q = stream_index.dataset.queries
    live_before = np.sort(pm.live_vectors()[0])
    np.testing.assert_array_equal(live_before, np.sort(rm.live_vectors()[0]))
    for m in (rm, pm):
        m.consolidate(reorder_samples=16)
    assert len(pm.delta) == 0 and not pm.tombstones
    assert pm.base.device == stream_port.device
    np.testing.assert_array_equal(np.sort(pm.ext_base), live_before)
    assert pm.stats["logical_bytes"] == rm.stats["logical_bytes"]
    wa, ref_wa = pm.write_amplification(), rm.write_amplification()
    assert abs(wa - ref_wa) <= 0.01 * ref_wa, (wa, ref_wa)
    assert {"graph", "pq_train"} <= set(pm.consolidate_stage_s)
    ext_ids, vecs = pm.live_vectors()
    gt = ext_ids[ref_exact_knn(q, vecs, 10, "l2")]
    got, want = merged_search_kernel(pm, q), ref_merged(rm, q)
    assert not np.isin(got.ids, dead).any()
    r_got, r_want = recall_at_k(got.ids, gt, 10), recall_at_k(want.ids, gt,
                                                             10)
    assert abs(r_got - r_want) <= 0.02, (r_got, r_want)


def test_merged_shadow_oracle_equals_reference(stream_index, stream_port):
    """The merged plan's oracle: exact kNN over the live vectors, in
    external ids, filtered by the live mask; recomputed after updates."""
    from repro.plan import Searcher as RefSearcher
    from repro.plan import SearchRequest as RefRequest

    rm, pm, _ = _updated_pair(stream_index, stream_port, attributes=True)
    q = stream_index.dataset.queries
    s, rs = Searcher.open(pm), RefSearcher.open(rm)
    for band in (None, (0, 249)):
        plan = s.plan(SearchRequest(queries=q, filter=None if band is None
                                    else FilterSpec.range("price", *band)))
        ref_plan = rs.plan(RefRequest(queries=q, filter=None if band is None
                                      else RefSpec.range("price", *band)))
        np.testing.assert_array_equal(s.shadow_ground_truth(plan, q),
                                      rs.shadow_ground_truth(ref_plan, q))
    victim = int(s.shadow_ground_truth(plan, q)[0, 0])
    for m in (rm, pm):
        m.delete(victim)
    np.testing.assert_array_equal(s.shadow_ground_truth(plan, q),
                                  rs.shadow_ground_truth(ref_plan, q))


def test_embedding_retriever_matches_reference():
    rng = np.random.default_rng(12)
    emb = rng.standard_normal((600, 32)).astype(np.float32)
    q = emb[:20] + 0.05 * rng.standard_normal((20, 32)).astype(np.float32)
    ref = RefRetriever(emb, metric="angular")
    got = EmbeddingRetriever(emb, metric="angular", device="cpu")
    ids, dists = got.query(q, k=10)
    want_ids, want_d = ref.query(q, k=10)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(dists, want_d, rtol=1e-5,
                               atol=1e-6 * np.abs(want_d).max())
    assert got.index.config.dataset.num_queries == 20


@pytest.mark.parametrize("band", [None, (0, 249), (0, 14)])
def test_merged_billing_equals_reference(stream_index, stream_port, band):
    """A merged execution bills the base's counters with the plan's
    filter facts: the NAND trace equals the reference's (rtol 1e-6), the
    scan regime undiscounted (``tests/test_plan.py::
    test_merged_scan_billing_not_discounted``), and an engine with NAND
    billing on bills every query of a merged batch."""
    from repro.nand.simulator import (
        trace_from_plan_execution as ref_trace,
    )
    from repro.plan import Searcher as RefSearcher
    from repro.plan import SearchRequest as RefRequest
    from repro_torch.nand import trace_from_plan_execution
    from repro_torch.obs import NULL_OBS, Observability

    rm, pm, _ = _updated_pair(stream_index, stream_port,
                              attributes=band is not None)
    q = stream_index.dataset.queries
    res = Searcher.open(pm).search(SearchRequest(
        queries=q, filter=None if band is None
        else FilterSpec.range("price", *band)))
    want = RefSearcher.open(rm).search(RefRequest(
        queries=q, filter=None if band is None
        else RefSpec.range("price", *band)))
    assert res.raw.base_mode == want.raw.base_mode
    got_t = dataclasses.asdict(trace_from_plan_execution(res, index=pm))
    want_t = dataclasses.asdict(ref_trace(want, index=rm))
    assert got_t.keys() == want_t.keys()
    for f, v in want_t.items():
        assert got_t[f] == pytest.approx(v, rel=1e-6), f
    if res.raw.base_mode == "scan":
        assert got_t["filter_selectivity"] == 1.0
    obs = Observability.on(tracing=False, nand_billing=True)
    eng = ServingEngine(pm, batch_size=8, flush_us=0.0, obs=obs)
    spec = None if band is None else FilterSpec.range("price", *band)
    for v in q[:8]:
        eng.submit(v, filter=spec)
    eng.drain()
    NULL_OBS.install_kernel_hooks()
    assert obs.metrics.counter_total("nand_billed_queries") == 8
    assert obs.metrics.counter_total("nand_unbilled_batches") == 0
