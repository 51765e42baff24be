"""The port's plan layer and batch-flush engine against the reference on
``tiny_index`` (carried across with ``index_from_arrays``), on the CPU:
``Searcher.search`` returns the reference's ids and SearchStats, and
``ServingEngine`` in batch mode, fed the same submit order, completes every
request with the reference engine's ids."""
import dataclasses

import numpy as np
import pytest

from _torch_port import gloo_world_of_one, port_index, port_sharded
from repro.plan import Searcher as RefSearcher
from repro.plan import SearchRequest as RefRequest
from repro.serve.engine import ServingEngine as RefEngine
from repro.stream import MutableIndex as RefMutable
from repro_torch.configs.base import PlanConfig
from repro_torch.plan import Searcher, SearchRequest
from repro_torch.serve import ServingEngine
from repro_torch.stream import MutableIndex


@pytest.fixture(scope="module")
def tiny_port(tiny_index):
    return port_index(tiny_index)


@pytest.mark.parametrize("request_kw", [dict(), dict(k=5),
                                        dict(overrides={"beam_width": 4})])
def test_searcher_matches_reference(tiny_index, tiny_port, request_kw):
    q = tiny_index.dataset.queries
    want = RefSearcher.open(tiny_index).search(RefRequest(queries=q,
                                                          **request_kw))
    s = Searcher.open(tiny_port)
    got = s.search(SearchRequest(queries=q, **request_kw))
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5,
                               atol=1e-6 * np.abs(want.dists).max())
    assert got.stats.as_dict() == want.stats.as_dict()
    assert got.plan.kind == "flat" and got.plan.strategy == "none"
    # a repeated request is a plan-cache hit
    s.search(SearchRequest(queries=q[:2], **request_kw))
    assert s.plan_cache_stats() == {"plan_cache_hits": 1,
                                    "plan_cache_misses": 1}


def test_searcher_opens_a_corpus(tiny_port):
    q = tiny_port.dataset.queries
    a = Searcher.open(tiny_port.corpus(), cfg=tiny_port.config.search,
                      metric="l2").search(SearchRequest(queries=q))
    b = Searcher.open(tiny_port).search(SearchRequest(queries=q))
    np.testing.assert_array_equal(a.ids, b.ids)


@pytest.mark.parametrize("batch_size", [8, 16])
def test_engine_done_ids_match_reference(tiny_index, tiny_port, batch_size):
    """Same submit order, same batches (a full batch flushes on step, the
    remainder on drain into a smaller power-of-two bucket), same ids."""
    q = tiny_index.dataset.queries[:21]
    ref = RefEngine(tiny_index, batch_size=batch_size)
    eng = ServingEngine(tiny_port, batch_size=batch_size)
    for e in (ref, eng):
        for v in q:
            e.submit(v)
            e.step()
        e.drain()
    assert sorted(eng.done) == sorted(ref.done) == list(range(len(q)))
    for rid in ref.done:
        np.testing.assert_array_equal(eng.done[rid].ids, ref.done[rid].ids)
        assert eng.done[rid].latency_ms >= 0
    for f in ("batches", "queries", "pad_fraction"):
        assert eng.stats[f] == ref.stats[f], f
    assert eng._bucket(5) == ref._bucket(5) == 8


def test_engine_beam_width_and_plan_config(tiny_index, tiny_port):
    q = tiny_index.dataset.queries[:8]
    ref = RefEngine(tiny_index, batch_size=8, beam_width=4)
    eng = ServingEngine(tiny_port, batch_size=8,
                        plan=PlanConfig(beam_width=4))
    for e in (ref, eng):
        for v in q:
            e.submit(v)
        e.drain()
    for rid in ref.done:
        np.testing.assert_array_equal(eng.done[rid].ids, ref.done[rid].ids)


def test_unported_serving_modes_raise(tiny_index, tiny_port, tmp_path):
    """The mesh keywords (item 15) are ported: ``mesh=`` over a sharded
    corpus opens a distributed searcher, which serves the reference's
    ids; targets other than an index, a mutable index, a corpus, tiles or
    a sharded corpus raise.  Tiled plans (item 11) run: a tiled Searcher
    serves a request, and a flat one takes a request's probe_tiles as the
    plan's fan-in.  The batched fan-out (item 19) is ported: ``use_vmap=``
    is taken into the plan config.  Observability and NAND
    billing (items 12 and 13) are ported: ``obs=`` refuses what
    ``Observability.resolve`` refuses, with the reference's TypeError.
    Streaming (item 10) is ported: a merged plan over a static index has
    no round session, as in the reference; a frozen engine refuses updates
    with the reference's error, and an engine over a MutableIndex takes
    them and serves the reference's ids."""
    tiled = Searcher.open(tiny_port, PlanConfig(num_tiles=2))
    res = tiled.search(SearchRequest(queries=tiny_port.dataset.queries[:2]))
    assert res.plan.kind == "tiled" and res.ids.shape == (2, 10)
    res = Searcher.open(tiny_port).search(SearchRequest(
        queries=tiny_port.dataset.queries[:1], probe_tiles=2))
    assert res.plan.kind == "flat" and res.plan.probe_tiles == 2
    with pytest.raises(NotImplementedError):
        Searcher.open(dataclasses.replace(tiny_port.dataset))
    with pytest.raises(TypeError, match="obs= takes"):
        ServingEngine(tiny_port, batch_size=4, continuous=True, obs=object())
    assert Searcher.open(tiny_port, use_vmap=True).plan_cfg.use_vmap is True
    with gloo_world_of_one(tmp_path) as mesh:
        res = Searcher.open(port_sharded(tiny_index),
                            cfg=tiny_port.config.search, mesh=mesh).search(
            SearchRequest(queries=tiny_port.dataset.queries[:4]))
    want = RefSearcher.open(tiny_index).search(
        RefRequest(queries=tiny_index.dataset.queries[:4]))
    assert res.plan.kind == "distributed"
    np.testing.assert_array_equal(np.sort(res.ids, 1),
                                  np.sort(np.asarray(want.ids), 1))
    q = tiny_port.dataset.queries
    s, rs = Searcher.open(tiny_port), RefSearcher.open(tiny_index)
    plan = s.plan(SearchRequest(queries=q[:1]))
    ref_plan = rs.plan(RefRequest(queries=q[:1]))
    assert s.round_session(dataclasses.replace(plan, kind="merged")) is None
    assert rs.round_session(dataclasses.replace(ref_plan,
                                                kind="merged")) is None
    for frozen in (ServingEngine(tiny_port, batch_size=4),
                   RefEngine(tiny_index, batch_size=4)):
        with pytest.raises(RuntimeError, match="frozen index"):
            frozen.insert(q[0])
        with pytest.raises(RuntimeError, match="frozen index"):
            frozen.delete(0)
    engines = (ServingEngine(MutableIndex(tiny_port), batch_size=4),
               RefEngine(RefMutable(tiny_index), batch_size=4))
    for e in engines:
        ext = e.insert(q[0] + 1e-4)
        assert e.delete(int(tiny_index.dataset.gt[1, 0]))
        for v in q[:6]:
            e.submit(v)
        e.drain()
    got, want = engines
    assert got.done[0].ids[0] == want.done[0].ids[0] == ext
    for rid, r in want.done.items():
        np.testing.assert_array_equal(got.done[rid].ids, r.ids)
