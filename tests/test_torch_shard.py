"""The port's shard layer against the reference on the CPU, on
``tiny_index`` (carried across with ``port_index``):

* ``partition_index`` for contiguous/hash/cluster at P=2 and 3 gives the
  reference's ``tile_of_cold`` and tile sizes (the assignment is the
  reference's numpy); the tile graphs are the port's device build;
* ``cross_tile_merge`` gives the reference's ids exactly and distances
  exactly on random candidates with duplicate ids, -1 ids and ties (the
  stable sort equals ``lax.top_k``'s tie order);
* on the reference's tiles carried across (``port_tiled``),
  ``sharded_search`` gives the reference's ids, per-tile counters and
  ``probed`` mask exactly, distances within the search bar (rtol 1e-5 plus
  1e-6 of the largest, tests/test_torch_core.py says why), with and without
  ``probe_tiles`` and with per-tile node masks;
* the batched fan-out (``use_vmap``, the default) against the reference's
  vmapped fan-out and against the port's unrolled one, full and routed;
  a masked fan-out stays unrolled under ``use_vmap=True``; the flat
  traversal is unchanged by the stacked-corpus path;
* the serving engine: the twin of ``tests/test_serve.py::
  test_engine_sharded_path`` and ids equal to the reference engine's with
  ``num_tiles=2`` (the port partitions and rebuilds the tiles itself).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import port_index, port_tiled
from repro.filter import FilterSpec as RefSpec
from repro.filter import random_attributes as ref_random_attributes
from repro.serve.engine import ServingEngine as RefEngine
from repro.shard import cross_tile_merge as ref_cross_tile_merge
from repro.shard import partition_index as ref_partition_index
from repro.shard import route_queries as ref_route_queries
from repro.shard import sharded_search_kernel as ref_sharded_search
from repro_torch.configs.base import SearchConfig
from repro_torch.filter import FilterSpec, random_attributes, tile_node_masks
from repro_torch.plan import Searcher, SearchRequest
from repro_torch.serve import ServingEngine
from repro_torch.shard import (
    cross_tile_merge, partition_index, route_queries, sharded_search,
)

COUNTERS = ("n_hops", "n_pq", "n_acc", "n_hot_hops", "n_free_pq", "rounds")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's tiny tensors: the suite runs
    in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_port(tiny_index):
    return port_index(tiny_index)


@pytest.fixture(scope="module")
def ref_tiles(tiny_index):
    """The reference's cluster tiles at P=3 and hash tiles at P=2."""
    return {(p, pol): ref_partition_index(tiny_index, p, pol)
            for p, pol in ((3, "cluster"), (2, "hash"))}


@pytest.mark.parametrize("num_tiles", [2, 3])
@pytest.mark.parametrize("policy", ["contiguous", "hash", "cluster"])
def test_partition_matches_reference(tiny_index, tiny_port, ref_tiles,
                                     policy, num_tiles):
    """tile_of_cold is the reference's: its partition_index's where the
    fixture built one, else its assignment (``assign_cold``, what its
    partition_index computes tile_of_cold with)."""
    from repro.shard.partition import assign_cold as ref_assign_cold
    from repro_torch.core.search import graph_search

    tiled, part = partition_index(tiny_port, num_tiles, policy)
    base = tiny_index._search_base()
    hot = tiny_index.hot_count
    want = ref_assign_cold(base[hot:], num_tiles, policy,
                           seed=tiny_index.config.dataset.seed)
    if (num_tiles, policy) in ref_tiles:
        ref_part = ref_tiles[num_tiles, policy][1]
        np.testing.assert_array_equal(ref_part.tile_of_cold, want)
        np.testing.assert_array_equal(part.tile_sizes, ref_part.tile_sizes)
    np.testing.assert_array_equal(part.tile_of_cold, want)
    sizes = hot + np.bincount(want, minlength=num_tiles)
    np.testing.assert_array_equal(part.tile_sizes, sizes)
    assert (part.hot_count, part.num_tiles, tiled.num_tiles) == \
        (hot, num_tiles, num_tiles)
    tid = tiled.tile_ids.numpy()
    for p in range(num_tiles):
        ids = tid[p][tid[p] >= 0]
        assert (ids[:hot] == np.arange(hot)).all()
        np.testing.assert_array_equal(np.sort(ids[hot:]),
                                      hot + np.nonzero(want == p)[0])
        # every tile's graph is a working local index
        corpus = type(tiny_port.corpus())(
            adjacency=tiled.adjacency[p], codes=tiled.codes[p],
            base=tiled.base[p], centroids=tiled.centroids,
            entry_point=int(tiled.entry_points[p]),
            hot_count=int(tiled.hot_counts[p]))
        res = graph_search(corpus, tiled.base[p][hot:hot + 4],
                           tiny_port.config.search)
        assert (res.ids[:, 0] == torch.arange(hot, hot + 4)).all()


@pytest.mark.parametrize("q,c,k", [(16, 20, 10), (7, 33, 5), (5, 64, 10)])
def test_cross_tile_merge_matches_reference(q, c, k):
    rng = np.random.default_rng(c)
    ids = rng.integers(0, c // 2, (q, c)).astype(np.int32)    # duplicates
    ids[rng.random((q, c)) < 0.2] = -1
    d = rng.integers(0, 6, (q, c)).astype(np.float32)         # ties
    d[ids < 0] = np.inf
    want_ids, want_d = ref_cross_tile_merge(ids, d, k)
    got_ids, got_d = cross_tile_merge(torch.tensor(ids), torch.tensor(d), k)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_route_queries_matches_reference(tiny_index, ref_tiles):
    ref, _ = ref_tiles[3, "cluster"]
    tiled, _ = port_tiled(ref)
    q = tiny_index.dataset.queries
    for probe in (1, 2):
        np.testing.assert_array_equal(
            route_queries(tiled, torch.tensor(q), probe).numpy(),
            np.asarray(ref_route_queries(ref, q, probe)))


def _assert_same_sharded(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.probed.numpy(), np.asarray(want.probed))
    for f in COUNTERS + ("ids",):
        np.testing.assert_array_equal(
            getattr(got.per_tile, f).numpy(),
            np.asarray(getattr(want.per_tile, f)), err_msg=f)
    wd = np.asarray(want.dists)
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(got.dists.numpy()), fin)
    np.testing.assert_allclose(got.dists.numpy()[fin], wd[fin], rtol=1e-5,
                               atol=1e-6 * np.abs(wd[fin]).max())


@pytest.mark.parametrize("case", ["full", "probe2", "masked", "masked_probe"])
def test_sharded_search_matches_reference(tiny_index, ref_tiles, case):
    ref, part = ref_tiles[3, "cluster"]
    tiled, tpart = port_tiled(ref, part)
    np.testing.assert_array_equal(tpart.tile_of_cold, part.tile_of_cold)
    cfg = tiny_index.config.search
    probe = 2 if "probe" in case else None
    masks = None
    if "masked" in case:
        mask = np.random.default_rng(9).random(
            tiny_index.dataset.num_base) < 0.4
        mask[np.asarray(ref.tile_ids)[0].clip(0)] = False   # a zero-pass tile
        masks = tile_node_masks(tiled.tile_ids, mask)
        assert not masks[0].any() and masks[1:].any()
    q = tiny_index.dataset.queries
    want = ref_sharded_search(ref, q, cfg, probe_tiles=probe,
                              node_masks=masks, use_vmap=False)
    got = sharded_search(tiled, q, SearchConfig(**dataclasses.asdict(cfg)),
                         probe_tiles=probe, node_masks=masks)
    _assert_same_sharded(got, want)
    if masks is not None:
        assert not got.probed[0].any()
        assert (got.per_tile.n_hops[0] == 0).all()


def _tensors(res):
    return [res.ids, res.dists, res.probed, *res.per_tile]


def _count_traversals(monkeypatch):
    """Spy on the fan-out's ``graph_search``: the lanes of each call."""
    from repro_torch.shard import search as shard_search

    lanes = []
    real = shard_search.graph_search

    def spy(corpus, queries, *a, **kw):
        res = real(corpus, queries, *a, **kw)
        lanes.append(res.ids.shape[0])
        return res

    monkeypatch.setattr(shard_search, "graph_search", spy)
    return lanes


@pytest.mark.parametrize("case", ["full", "probe2"])
def test_batched_fan_out_matches_reference_vmap(tiny_index, ref_tiles,
                                                monkeypatch, case):
    """``use_vmap=True`` (one traversal of P*Q lanes) gives the reference's
    vmapped fan-out's ids, ``probed`` and per-tile counters, and the port's
    unrolled fan-out's bit for bit; ``use_vmap=None`` is the batched one."""
    ref, part = ref_tiles[3, "cluster"]
    tiled, _ = port_tiled(ref, part)
    cfg = tiny_index.config.search
    pcfg = SearchConfig(**dataclasses.asdict(cfg))
    probe = 2 if case == "probe2" else None
    q = tiny_index.dataset.queries
    want = ref_sharded_search(ref, q, cfg, probe_tiles=probe, use_vmap=True)
    lanes = _count_traversals(monkeypatch)
    got = sharded_search(tiled, q, pcfg, use_vmap=True, probe_tiles=probe)
    assert lanes == [3 * len(q)]
    _assert_same_sharded(got, want)
    unrolled = sharded_search(tiled, q, pcfg, use_vmap=False,
                              probe_tiles=probe)
    assert lanes == [3 * len(q)] + [len(q)] * 3
    for x, y in zip(_tensors(got), _tensors(unrolled)):
        assert torch.equal(x, y)
    default = sharded_search(tiled, q, pcfg, probe_tiles=probe)
    assert lanes[-1] == 3 * len(q) and torch.equal(default.ids, got.ids)


def test_masked_fan_out_stays_unrolled(tiny_index, ref_tiles, monkeypatch):
    """Per-tile node masks take the unrolled loop under ``use_vmap=True``,
    as the reference's (the zero-pass tile is skipped, never traversed)."""
    ref, part = ref_tiles[3, "cluster"]
    tiled, _ = port_tiled(ref, part)
    mask = np.random.default_rng(9).random(tiny_index.dataset.num_base) < 0.4
    mask[np.asarray(ref.tile_ids)[0].clip(0)] = False
    masks = tile_node_masks(tiled.tile_ids, mask)
    cfg = tiny_index.config.search
    q = tiny_index.dataset.queries
    lanes = _count_traversals(monkeypatch)
    got = sharded_search(tiled, q, SearchConfig(**dataclasses.asdict(cfg)),
                         use_vmap=True, node_masks=masks)
    assert lanes == [len(q)] * 2
    _assert_same_sharded(got, ref_sharded_search(
        ref, q, cfg, node_masks=masks, use_vmap=True))


def test_flat_search_ignores_stacked_path(tiny_index, tiny_port):
    """A flat corpus has no lane offsets: ``graph_search`` gives the
    reference's ids and counters (the flat bar of tests/test_torch_core.py)
    and the same result as a one-tile stacked corpus of the same tables."""
    from repro.core.search import graph_search as ref_graph_search
    from repro_torch.core.search import graph_search
    from repro_torch.shard.search import _stacked_corpus
    from repro_torch.shard import TiledCorpus

    corpus = tiny_port.corpus()
    assert corpus.lane_offset is None
    q = tiny_index.dataset.queries
    cfg = tiny_port.config.search
    got = graph_search(corpus, q, cfg)
    want = ref_graph_search(tiny_index.corpus(), q, tiny_index.config.search)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    one = TiledCorpus(
        adjacency=corpus.adjacency[None], codes=corpus.codes[None],
        base=corpus.base[None], centroids=corpus.centroids,
        entry_points=torch.tensor([corpus.entry_point], dtype=torch.int32),
        hot_counts=torch.tensor([corpus.hot_count], dtype=torch.int32),
        tile_ids=torch.arange(corpus.base.shape[0],
                              dtype=torch.int32)[None],
        tile_centroids=corpus.base.mean(0, keepdim=True))
    stacked = graph_search(_stacked_corpus(one, len(q)), q, cfg)
    for a, b in zip(got, stacked):
        assert torch.equal(a, b)


def test_searcher_tiled_filtered_matches_reference(tiny_index, tiny_port,
                                                   ref_tiles):
    """A filtered request over carried-across tiles: the planner's tiled
    masked strategy (adapted config, per-tile node masks) and its stats."""
    from repro.plan import Searcher as RefSearcher
    from repro.plan import SearchRequest as RefRequest

    ref, _ = ref_tiles[3, "cluster"]
    tiled, _ = port_tiled(ref)
    n = tiny_index.dataset.num_base
    store = random_attributes(n, {"category": 8}, seed=3)
    ref_store = ref_random_attributes(n, {"category": 8}, seed=3)
    q = tiny_index.dataset.queries
    cfg = tiny_index.config.search
    want = RefSearcher.open(ref, cfg=cfg, attributes=ref_store).search(
        RefRequest(queries=q, filter=RefSpec.isin("category", [1, 2])))
    got = Searcher.open(tiled, cfg=SearchConfig(**dataclasses.asdict(cfg)),
                        attributes=store).search(
        SearchRequest(queries=q, filter=FilterSpec.isin("category", [1, 2])))
    assert (got.plan.kind, got.plan.strategy) == ("tiled", "masked")
    assert got.plan.cfg.list_size == want.plan.cfg.list_size
    np.testing.assert_array_equal(got.ids, want.ids)
    assert got.stats.as_dict() == pytest.approx(want.stats.as_dict())
    assert Searcher.open(tiled).round_session(got.plan) is None


def test_engine_sharded_path(tiny_index, tiny_port):
    """The port's twin of tests/test_serve.py::test_engine_sharded_path:
    num_tiles > 1 routes batches through the fan-out and serves results
    that overlap the single-tile search's by >= 0.7."""
    from repro_torch.core.search import graph_search

    eng = ServingEngine(tiny_port, batch_size=8, flush_us=0.0, num_tiles=2,
                        shard_policy="hash")
    assert eng.tiled is not None and eng.tiled.num_tiles == 2
    assert eng.num_tiles == 2 and eng.shard_policy == "hash"
    q = tiny_port.dataset.queries[:8]
    rids = [eng.submit(qq) for qq in q]
    eng.drain()
    got = np.stack([eng.done[r].ids for r in rids])
    direct = graph_search(tiny_port.corpus(), q, tiny_port.config.search,
                          tiny_port.dataset.metric).ids.numpy()
    overlap = np.mean([
        len(set(got[i].tolist()) & set(direct[i].tolist())) / direct.shape[1]
        for i in range(len(q))])
    assert overlap >= 0.7, f"sharded engine diverged: overlap {overlap}"


ENGINE_KW = dict(batch_size=8, num_tiles=2, shard_policy="cluster",
                 probe_tiles=1)


@pytest.fixture(scope="module")
def ref_engine_ids(tiny_index):
    ref = RefEngine(tiny_index, **ENGINE_KW)
    for v in tiny_index.dataset.queries:
        ref.submit(v)
    ref.drain()
    return {rid: r.ids for rid, r in ref.done.items()}


@pytest.mark.parametrize("continuous", [False, True])
def test_engine_ids_equal_reference_engine(tiny_port, ref_engine_ids,
                                           continuous):
    """ServingEngine(num_tiles=2, shard_policy="cluster", probe_tiles=1)
    against the reference engine: the same ids for every request; the
    continuous engine flushes tiled plans through the batch path."""
    eng = ServingEngine(tiny_port, continuous=continuous, slots=4,
                        **ENGINE_KW)
    assert eng.probe_tiles == 1
    for v in tiny_port.dataset.queries:
        eng.submit(v)
    eng.drain()
    assert sorted(eng.done) == sorted(ref_engine_ids)
    for rid, ids in ref_engine_ids.items():
        np.testing.assert_array_equal(eng.done[rid].ids, ids)
    if continuous:
        assert eng.stats["fallback_batches"] == eng.stats["batches"] > 0
