"""The port's continuous (iteration-level) serving engine and round-stepped
plan sessions on the CPU, on ``tiny_index`` (carried across with
``port_index``): the continuous engine equals the port's batch-flush engine
bit for bit and the reference continuous engine's ids (distances within the
search bar of ROADMAP: rtol 1e-5 plus 1e-6 of the largest), lanes retire
across ticks, refill serves a backlog, the drain guard raises, non-steppable
plans fall back to batch flushes, masked plans run in slot pools, and what
is not ported yet raises naming its ROADMAP item.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import port_index
from repro.filter import FilterSpec as RefSpec
from repro.filter import random_attributes as ref_random_attributes
from repro.serve.engine import ServingEngine as RefEngine
from repro_torch.filter import (
    FilterSpec, adapt_search_cfg, random_attributes,
)
from repro_torch.plan import QueryPlan, RoundSession, Searcher, SearchRequest
from repro_torch.serve import ServingEngine
from repro_torch.serve.engine import (
    _gather_rows, _quiet_free_lanes, _scatter_rows,
)

SCHEMA = {"category": 8, "price": 1000}
# unfiltered, masked ~10%, masked ~25%, scan ~1.5%, empty
BANDS = (None, (0, 99), (0, 249), (0, 14), (1000, None))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's tiny tensors: the suite runs
    in several worker processes, and torch's default of a thread per core
    in each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_port(tiny_index):
    return port_index(tiny_index)


@pytest.fixture(scope="module")
def tiny_store(tiny_index):
    return random_attributes(tiny_index.dataset.num_base, SCHEMA, seed=7)


def _specs(cls):
    return [None if b is None else cls.range("price", *b) for b in BANDS]


def _run(engine, queries, filters=None):
    for i, v in enumerate(queries):
        engine.submit(v, filter=None if filters is None
                      else filters[i % len(filters)])
    engine.drain()
    return engine


def _assert_equal_done(a, b, exact=True):
    assert sorted(a.done) == sorted(b.done)
    for rid, r in b.done.items():
        np.testing.assert_array_equal(a.done[rid].ids, r.ids)
        if exact:
            np.testing.assert_array_equal(a.done[rid].dists, r.dists)
        else:
            fin = np.isfinite(r.dists)
            np.testing.assert_array_equal(np.isfinite(a.done[rid].dists), fin)
            if fin.any():
                np.testing.assert_allclose(
                    a.done[rid].dists[fin], r.dists[fin], rtol=1e-5,
                    atol=1e-6 * np.abs(r.dists[fin]).max())


@pytest.mark.parametrize("beam", [1, 4])
def test_continuous_matches_batch_engine(tiny_port, beam):
    """Same queries, same ids and distances bit for bit, whichever
    scheduler served them."""
    q = tiny_port.dataset.queries[:13]
    cont = _run(ServingEngine(tiny_port, batch_size=8, continuous=True,
                              slots=4, beam_width=beam), q)
    batch = _run(ServingEngine(tiny_port, batch_size=8, flush_us=0.0,
                               beam_width=beam), q)
    _assert_equal_done(cont, batch)
    assert cont.stats["retired"] == cont.stats["queries"] == len(q)
    assert cont.stats["batches"] == 0          # never fell back


@pytest.mark.parametrize("slots", [3, 4, 12])
def test_continuous_matches_reference_engine(tiny_index, tiny_port, slots):
    q = tiny_index.dataset.queries
    ref = _run(RefEngine(tiny_index, batch_size=8, continuous=True,
                         slots=slots), q)
    got = _run(ServingEngine(tiny_port, batch_size=8, continuous=True,
                             slots=slots), q)
    _assert_equal_done(got, ref, exact=False)
    for f in ("queries", "retired", "ticks", "batches", "fallback_batches"):
        assert got.stats[f] == ref.stats[f], f


def test_filtered_continuous_matches_reference_and_batch(tiny_index,
                                                         tiny_port,
                                                         tiny_store):
    """Unfiltered, masked, scan and empty requests interleaved: masked
    plans take slot pools, scan and empty fall back to batch flushes; the
    ids equal the reference continuous engine's and, bit for bit, the
    port's batch engine's, and the scheduling counters are the
    reference's."""
    q = tiny_index.dataset.queries
    rstore = ref_random_attributes(tiny_index.dataset.num_base, SCHEMA,
                                   seed=7)
    ref = _run(RefEngine(tiny_index, batch_size=8, continuous=True, slots=4,
                         attributes=rstore, flush_us=0.0), q, _specs(RefSpec))
    got = _run(ServingEngine(tiny_port, batch_size=8, continuous=True,
                             slots=4, attributes=tiny_store, flush_us=0.0),
               q, _specs(FilterSpec))
    batch = _run(ServingEngine(tiny_port, batch_size=8, flush_us=0.0,
                               attributes=tiny_store), q, _specs(FilterSpec))
    _assert_equal_done(got, ref, exact=False)
    _assert_equal_done(got, batch)
    for f in ("queries", "retired", "ticks", "batches", "fallback_batches",
              "filtered_queries", "filter_scan_batches"):
        assert got.stats[f] == ref.stats[f], f
    strategies = {k[1] for k in got._pools}
    assert strategies == {"none", "masked"}
    for rid, r in got.done.items():
        if r.filter is not None:
            mask = tiny_store.mask(r.filter)
            assert mask[r.ids[r.ids >= 0]].all()


def test_lanes_retire_across_ticks_not_at_barrier(tiny_port):
    eng = ServingEngine(tiny_port, batch_size=8, continuous=True, slots=12)
    for v in tiny_port.dataset.queries[:12]:
        eng.submit(v)
    retire_ticks = []
    guard = 0
    while eng.queue or eng.inflight():
        done = eng.step(force=True)
        if done:
            retire_ticks.append(len(done))
        guard += 1
        assert guard < 500
    assert sum(retire_ticks) == 12
    assert len(retire_ticks) > 1


def test_slot_refill_serves_backlog(tiny_port):
    q = np.tile(tiny_port.dataset.queries, (2, 1))[:20]
    eng = ServingEngine(tiny_port, batch_size=8, continuous=True, slots=3)
    rids = [eng.submit(v) for v in q]
    guard = 0
    while eng.queue or eng.inflight():
        eng.step(force=True)
        assert eng.inflight() <= 3
        guard += 1
        assert guard < 2000
    assert all(r in eng.done for r in rids)
    assert eng.stats["retired"] == 20


def test_drain_guard_raises_instead_of_spinning(tiny_port):
    eng = ServingEngine(tiny_port, batch_size=8, continuous=True, slots=4)
    eng.submit(tiny_port.dataset.queries[0])
    with pytest.raises(RuntimeError, match="drain"):
        eng.drain(max_steps=0)
    eng.drain()
    assert eng.stats["retired"] == 1


def test_deferred_plan_recached_on_flush(tiny_port):
    eng = ServingEngine(tiny_port, batch_size=4, flush_us=0.0)
    for v in tiny_port.dataset.queries[:6]:
        eng.submit(v)
    for r in eng.queue:
        r.plan = None                          # simulate deferred planning
    done = eng.step(force=True)
    assert len(done) == 4 and all(r.plan is not None for r in done)
    assert all(r.plan is not None for r in eng.queue)
    assert len({id(r.plan) for r in list(eng.queue) + done}) == 1
    eng.drain()
    assert eng.stats["queries"] == 6


def test_continuous_non_steppable_plan_falls_back(tiny_port, tiny_store):
    eng = ServingEngine(tiny_port, batch_size=8, continuous=True, slots=4,
                        attributes=tiny_store, flush_us=0.0)
    sharp = FilterSpec.range("price", 0, 4)
    rids = [eng.submit(v, filter=sharp)
            for v in tiny_port.dataset.queries[:5]]
    eng.drain()
    assert all(r in eng.done for r in rids)
    assert eng.stats["fallback_batches"] >= 1
    assert eng.stats["filter_scan_batches"] >= 1
    assert eng.stats["retired"] == 0
    passing = set(np.flatnonzero(tiny_store.mask(sharp)).tolist())
    for r in rids:
        assert set(int(i) for i in eng.done[r].ids if i >= 0) <= passing


def test_masked_requests_use_a_slot_pool(tiny_port, tiny_store):
    eng = ServingEngine(tiny_port, batch_size=8, continuous=True, slots=4,
                        attributes=tiny_store)
    spec = FilterSpec.range("price", 0, 249)
    for v in tiny_port.dataset.queries[:6]:
        eng.submit(v, filter=spec)
    eng.step(force=True)
    (pool,) = eng._pools.values()
    assert pool.session.plan.strategy == "masked"
    assert pool.session.cfg == adapt_search_cfg(
        eng.cfg, pool.session.plan.selectivity, eng.filter_cfg)
    assert pool.session.cfg.list_size > eng.cfg.list_size
    assert eng.inflight() == 4 and len(eng.queue) == 2
    eng.drain()
    assert eng.stats["retired"] == eng.stats["filtered_queries"] == 6
    assert eng.stats["batches"] == 0


@pytest.mark.parametrize("band", [None, (0, 99)])
def test_round_session_equals_execute(tiny_port, tiny_store, band):
    """Stepping a plan's session to quiescence and completing it returns
    what ``execute`` does, stats included."""
    s = Searcher.open(tiny_port, attributes=tiny_store)
    spec = None if band is None else FilterSpec.range("price", *band)
    q = tiny_port.dataset.queries
    plan = s.plan(SearchRequest(queries=q[:1], filter=spec))
    sess = s.round_session(plan)
    state = sess.init(q)
    while sess.active(state).any():
        state = sess.step(state)
    assert (sess.rounds(state) > 0).all()
    got = sess.complete(q, sess.finalize(state))
    want = s.search(SearchRequest(queries=q, filter=spec))
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.dists, want.dists)
    assert got.stats == want.stats and got.plan is want.plan


def test_state_helpers(tiny_port):
    """The slot-pool index ops: scatter writes the fresh lanes into the
    pool's own tensors in place (the Bloom bits are copied, never aliased)
    and leaves the other lanes alone, gather copies rows, quiet marks free
    lanes done."""
    s = Searcher.open(tiny_port)
    sess = s.round_session(s.plan(SearchRequest(
        queries=tiny_port.dataset.queries[:1])))
    a = sess.step(sess.init(tiny_port.dataset.queries[:4]))
    before = [f.clone() for f in (a.queries, a.adts, *a.lanes)]
    b = sess.init(tiny_port.dataset.queries[4:6])
    bits = a.lanes.bits.data_ptr()
    _scatter_rows(a, torch.tensor([2, 0]), b)
    assert a.lanes.bits.data_ptr() == bits != b.lanes.bits.data_ptr()
    for x, y, z in zip((a.queries, a.adts, *a.lanes),
                       (b.queries, b.adts, *b.lanes), before):
        assert torch.equal(x[2], y[0]) and torch.equal(x[0], y[1])
        assert torch.equal(x[[1, 3]], z[[1, 3]])
    g = _gather_rows(a, torch.tensor([2, 1]))
    assert torch.equal(g.queries, a.queries[[2, 1]])
    assert torch.equal(g.lanes.bits, a.lanes.bits[[2, 1]])
    assert g.lanes.bits.data_ptr() != bits
    q = _quiet_free_lanes(a, torch.tensor([True, True, False, False]))
    assert q.lanes.done[2:].all()
    assert torch.equal(q.lanes.done[:2], a.lanes.done[:2])


def test_port_leaves_caller_arrays_untouched(tiny_index):
    """The port never writes into its caller's arrays: init, step and the
    slot-pool scatter on queries taken straight from the reference fixture
    leave every reference array bit-identical, and so do a search, a
    filtered search and the engines over an index from
    ``index_from_arrays`` (which copies what it is given)."""
    ref_arrays = {
        "queries": tiny_index.dataset.queries, "base": tiny_index.dataset.base,
        "gt": tiny_index.dataset.gt, "adjacency": tiny_index.graph.adjacency,
        "degrees": tiny_index.graph.degrees, "codes": tiny_index.codes,
        "centroids": tiny_index.codebook.centroids,
        "perm": tiny_index.reordering.perm, "inv": tiny_index.reordering.inv,
    }
    before = {k: np.array(v, copy=True) for k, v in ref_arrays.items()}
    port = port_index(tiny_index)
    port_before = np.array(port.dataset.queries, copy=True)
    for src in (tiny_index.dataset.queries, port.dataset.queries):
        s = Searcher.open(port)
        sess = s.round_session(s.plan(SearchRequest(queries=src[:1])))
        pool = sess.step(sess.init(src[:4]))
        _scatter_rows(pool, torch.tensor([2, 0]), sess.init(src[4:6]))
        pool = sess.step(pool)
        s.search(SearchRequest(queries=src[:4]))
        for eng in (ServingEngine(port, batch_size=4),
                    ServingEngine(port, batch_size=4, continuous=True,
                                  slots=4)):
            for v in src[:6]:
                eng.submit(v)
            eng.drain()
    for k, v in ref_arrays.items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    np.testing.assert_array_equal(port.dataset.queries, port_before)
    assert not np.shares_memory(port.dataset.queries,
                                tiny_index.dataset.queries)


def test_unported_paths_raise_naming_their_items(tiny_port, tiny_store):
    """Merged plans still raise naming item 10.  Observability, SLOs and
    NAND billing (items 12 and 13) are ported: the engine takes them, and
    ``record_round`` appends one convergence record per lane."""
    from repro_torch.nand import NandConfig
    from repro_torch.obs import ConvergenceLog, SLOTarget

    with pytest.raises(TypeError, match="obs= takes"):
        ServingEngine(tiny_port, batch_size=4, obs=object())
    eng = ServingEngine(tiny_port, batch_size=4, continuous=True,
                        slo={None: SLOTarget(p99_latency_ms=1e9)},
                        nand=NandConfig(double_buffer=True), nand_queues=4)
    assert eng.nand.double_buffer and eng.nand_queues == 4
    assert eng.slo_status()[None]["latency_samples"] == 0
    s = Searcher.open(tiny_port, attributes=tiny_store)
    plan = s.plan(SearchRequest(queries=tiny_port.dataset.queries[:1]))
    merged = dataclasses.replace(plan, kind="merged")
    with pytest.raises(NotImplementedError, match="item 10"):
        s.round_session(merged)
    with pytest.raises(NotImplementedError, match="item 10"):
        s.execute(merged, tiny_port.dataset.queries[:1])
    # tiled plans run (item 11), through the batch path: no round session
    tiled = Searcher.open(tiny_port, num_tiles=2, attributes=tiny_store)
    tplan = tiled.plan(SearchRequest(queries=tiny_port.dataset.queries[:1]))
    assert tplan.kind == "tiled" and tiled.round_session(tplan) is None
    assert tiled.execute(tplan, tiny_port.dataset.queries[:3]).ids.shape \
        == (3, 10)
    sess, log = s.round_session(plan), ConvergenceLog(64)
    state = sess.step(sess.init(tiny_port.dataset.queries[:3]))
    sess.record_round(log, [7, 8], state, select=[0, 2])
    assert log.count == 2 and log.to_arrays()["qid"].tolist() == [7, 8]
    assert isinstance(s.round_session(plan), RoundSession)
    assert isinstance(plan, QueryPlan)
