"""The port's plan layer and batch-flush engine against the reference on
``tiny_index`` (carried across with ``index_from_arrays``), on the CPU:
``Searcher.search`` returns the reference's ids and SearchStats, and
``ServingEngine`` in batch mode, fed the same submit order, completes every
request with the reference engine's ids."""
import dataclasses

import numpy as np
import pytest

from _torch_port import port_index
from repro.plan import Searcher as RefSearcher
from repro.plan import SearchRequest as RefRequest
from repro.serve.engine import ServingEngine as RefEngine
from repro_torch.configs.base import PlanConfig
from repro_torch.plan import Searcher, SearchRequest
from repro_torch.serve import ServingEngine


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


def test_unported_serving_modes_raise(tiny_port):
    """What the port still refuses names its ROADMAP item: merged plans
    (item 10), the vmapped fan-out (item 19), the mesh keywords (item 15);
    targets other than an index, a corpus or tiles raise too.  Tiled plans
    (item 11) now run: a tiled Searcher serves a request, and a flat one
    takes a request's probe_tiles as the plan's fan-in.  Observability and
    NAND billing (items 12 and 13) are ported: ``obs=`` refuses what
    ``Observability.resolve`` refuses, with the reference's TypeError."""
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
    with pytest.raises(NotImplementedError, match="item 19"):
        Searcher.open(tiny_port, use_vmap=True)
    with pytest.raises(NotImplementedError, match="item 15"):
        Searcher.open(tiny_port, mesh=object())
    s = Searcher.open(tiny_port)
    plan = s.plan(SearchRequest(queries=tiny_port.dataset.queries[:1]))
    with pytest.raises(NotImplementedError, match="item 10"):
        s.round_session(dataclasses.replace(plan, kind="merged"))
