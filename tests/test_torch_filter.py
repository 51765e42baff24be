"""The port's filter subsystem against the reference on the CPU, on
``tiny_index`` (carried across with ``port_index``): spec and attribute
masks bit for bit, masked traversal against the reference jnp path at E=1/4
and l2/ip/angular, the all-pass bit-identity, the scan and empty strategies
with their counters, the beta=1.0 guard, the config adaptation, and
filtered requests through ``Searcher`` and the batch-flush engine.

Search bar (ROADMAP): equal ids and counters, distances within rtol 1e-5
plus 1e-6 of the batch's largest finite distance (tests/test_torch_core.py
says why).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import port_index
from repro.configs.base import FilterConfig as RefFilterConfig
from repro.core.search import graph_search as ref_graph_search
from repro.filter import FilterSpec as RefSpec
from repro.filter import adapt_search_cfg as ref_adapt
from repro.filter import random_attributes as ref_random_attributes
from repro.plan import Searcher as RefSearcher
from repro.plan import SearchRequest as RefRequest
from repro.plan.planner import flat_filtered_search as ref_flat_filtered
from repro_torch.configs.base import (
    FilterConfig, ProximaConfig, SearchConfig, upgrade_config,
)
from repro_torch.core.search import graph_search
from repro_torch.filter import (
    AttributeStore, FilterSpec, adapt_search_cfg, attach_attributes,
    bitmap_popcount, encode_categorical, pack_bitmap, random_attributes,
    unpack_bitmap,
)
from repro_torch.plan import Searcher, SearchRequest
from repro_torch.plan.planner import flat_filtered_search
from repro_torch.serve import ServingEngine

COUNTERS = ("n_hops", "n_pq", "n_acc", "n_hot_hops", "n_free_pq", "rounds")
SCHEMA = {"category": 8, "price": 1000}
# (field, lo, hi) ranges of tiny_store: ~10% and ~25% pass (masked), ~1.5%
# (scan), none (empty)
MASKED = {"p10": ("price", 0, 99), "p25": ("price", 0, 249)}


def _both(field, lo=None, hi=None):
    return FilterSpec.range(field, lo, hi), RefSpec.range(field, lo, hi)


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
    return random_attributes(tiny_index.dataset.num_base, SCHEMA, seed=5)


@pytest.fixture(scope="module")
def ref_store(tiny_index):
    return ref_random_attributes(tiny_index.dataset.num_base, SCHEMA, seed=5)


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def _assert_same(got, ref, counters=True):
    np.testing.assert_array_equal(_np(got.ids), np.asarray(ref.ids))
    rd, gd = np.asarray(ref.dists), _np(got.dists)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(rd))
    fin = np.isfinite(rd)
    if fin.any():
        np.testing.assert_allclose(gd[fin], rd[fin], rtol=1e-5,
                                   atol=1e-6 * np.abs(rd[fin]).max())
    if counters:
        for f in COUNTERS:
            np.testing.assert_array_equal(
                _np(getattr(got, f)), np.asarray(getattr(ref, f)), err_msg=f)


# ---------------------------------------------------------------------------
# Spec + store units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_args", [
    ("eq", "category", 3), ("isin", "category", [0, 1]),
    ("isin", "category", []), ("range", "price", 0, 99),
    ("range", "price", None, 14), ("range", "price", 1000, None),
    ("and",), ("all",),
])
def test_masks_equal_reference(tiny_store, ref_store, spec_args):
    """Same seed, same columns; every spec compiles to the reference's mask
    bit for bit, and so do the packed bitmaps."""
    np.testing.assert_array_equal(tiny_store.values, ref_store.values)
    kind, *args = spec_args
    if kind == "and":
        spec = FilterSpec.eq("category", 1) & FilterSpec.range("price", 500)
        ref = RefSpec.eq("category", 1) & RefSpec.range("price", 500)
    elif kind == "all":
        spec, ref = FilterSpec(), RefSpec()
    else:
        spec, ref = getattr(FilterSpec, kind)(*args), \
            getattr(RefSpec, kind)(*args)
    mask = tiny_store.mask(spec)
    np.testing.assert_array_equal(mask, ref_store.mask(ref))
    np.testing.assert_array_equal(tiny_store.bitmap(spec),
                                  ref_store.bitmap(ref))
    assert tiny_store.selectivity(spec) == ref_store.selectivity(ref)


def test_spec_compilation_and_composition():
    store = AttributeStore.from_columns({
        "cat": np.asarray([0, 1, 2, 1, 0]),
        "price": np.asarray([10, 20, 30, 40, 50]),
    })
    np.testing.assert_array_equal(
        store.mask(FilterSpec.eq("cat", 1)), [0, 1, 0, 1, 0])
    np.testing.assert_array_equal(
        store.mask(FilterSpec.range("price", 20, 40)), [0, 1, 1, 1, 0])
    np.testing.assert_array_equal(
        store.mask(FilterSpec.range("price", None, 30)), [1, 1, 1, 0, 0])
    np.testing.assert_array_equal(
        store.mask(FilterSpec.isin("cat", [0, 2])), [1, 0, 1, 0, 1])
    both = FilterSpec.eq("cat", 1) & FilterSpec.range("price", 30, None)
    np.testing.assert_array_equal(store.mask(both), [0, 0, 0, 1, 0])
    assert store.mask(FilterSpec()).all()
    assert not store.mask(FilterSpec.isin("cat", [])).any()
    assert store.selectivity(FilterSpec.eq("cat", 0)) == pytest.approx(0.4)
    with pytest.raises(KeyError):
        store.mask(FilterSpec.eq("nope", 1))
    assert hash(both) == hash(
        FilterSpec.eq("cat", 1) & FilterSpec.range("price", 30, None))


def test_bitmap_roundtrip_and_store_append():
    rng = np.random.default_rng(0)
    mask = rng.random(77) < 0.3
    bm = pack_bitmap(mask)
    assert bm.dtype == np.uint32
    np.testing.assert_array_equal(unpack_bitmap(bm, 77), mask)
    assert bitmap_popcount(bm) == int(mask.sum())
    store = AttributeStore.from_columns({"f": np.arange(3)})
    assert store.attr_bits == 32
    assert store.append({"f": 7}) == 3 and len(store) == 4
    assert store.append([9]) == 4
    np.testing.assert_array_equal(store.column("f"), [0, 1, 2, 7, 9])
    codes, vocab = encode_categorical(["shoes", "hats", "shoes"])
    np.testing.assert_array_equal(codes, [0, 1, 0])
    assert vocab == {"shoes": 0, "hats": 1}


def test_attach_attributes_validates(tiny_port):
    with pytest.raises(ValueError):
        attach_attributes(tiny_port, random_attributes(3))
    with pytest.raises(ValueError):     # the engine validates length too
        ServingEngine(tiny_port, batch_size=4, flush_us=0.0,
                      attributes=random_attributes(3))
    idx = dataclasses.replace(tiny_port)
    store = attach_attributes(idx, random_attributes(idx.dataset.num_base))
    assert idx.attributes is store and tiny_port.attributes is None
    assert Searcher.open(idx).attributes is store


@pytest.mark.parametrize("sel", [1e-4, 0.01, 0.1, 0.125, 0.13, 0.25, 0.3,
                                 0.5, 0.99, 1.0])
def test_adapt_search_cfg_matches_reference(tiny_index, tiny_port, sel):
    ref = ref_adapt(tiny_index.config.search, sel, RefFilterConfig())
    got = adapt_search_cfg(tiny_port.config.search, sel, FilterConfig())
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    if sel >= 1.0:
        assert got is tiny_port.config.search


def test_upgrade_config_fills_missing_fields():
    cfg = ProximaConfig(search=SearchConfig(k=7, list_size=96))
    old = object.__new__(ProximaConfig)
    for f in dataclasses.fields(ProximaConfig):
        if f.name != "filter":
            object.__setattr__(old, f.name, getattr(cfg, f.name))
    up = upgrade_config(old)
    assert up.filter == FilterConfig()
    assert up.search.k == 7 and up.search.list_size == 96


# ---------------------------------------------------------------------------
# Masked traversal against the reference jnp path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beam", [1, 4])
@pytest.mark.parametrize("metric", ["l2", "ip", "angular"])
@pytest.mark.parametrize("band", sorted(MASKED))
def test_masked_traversal_matches_reference(tiny_index, tiny_port, tiny_store,
                                            band, metric, beam):
    """The masked strategy's traversal (config adapted to the mask's
    selectivity, as the planner runs it) against the reference's."""
    spec, _ = _both(*MASKED[band])
    mask = tiny_store.mask(spec)
    sel = float(mask.mean())
    rcfg = ref_adapt(dataclasses.replace(tiny_index.config.search,
                                         beam_width=beam),
                     sel, RefFilterConfig())
    ref = ref_graph_search(tiny_index.corpus(), tiny_index.dataset.queries,
                           rcfg, metric, node_mask=mask)
    pcfg = adapt_search_cfg(dataclasses.replace(tiny_port.config.search,
                                                beam_width=beam),
                            sel, FilterConfig())
    got = graph_search(tiny_port.corpus(), tiny_port.dataset.queries, pcfg,
                       metric, node_mask=mask)
    _assert_same(got, ref)
    ids = got.ids.numpy()
    assert mask[ids[ids >= 0]].all()


@pytest.mark.parametrize("beam", [1, 4])
def test_allpass_filter_bit_identical(tiny_port, tiny_store, beam):
    """An all-pass mask goes through the masked traversal and returns ids
    and distances bit-identical to the unfiltered search."""
    cfg = dataclasses.replace(tiny_port.config.search, beam_width=beam)
    q = tiny_port.dataset.queries
    base = graph_search(tiny_port.corpus(), q, cfg)
    fres = flat_filtered_search(tiny_port.corpus(), q,
                                tiny_store.mask(FilterSpec()), cfg, "l2")
    assert fres.mode == "traversal" and fres.selectivity == 1.0
    assert fres.effective == cfg
    np.testing.assert_array_equal(base.ids.numpy(), fres.ids)
    np.testing.assert_array_equal(base.dists.numpy(), fres.dists)
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(base, f).numpy(),
                                      getattr(fres.result, f).numpy())


# ---------------------------------------------------------------------------
# Scan and empty strategies, the beta guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["l2", "ip", "angular", "no_rerank",
                                  "no_pq", "k5"])
def test_scan_matches_reference(tiny_index, tiny_port, tiny_store, case):
    """The bitmap PQ scan (ids, distances, counters) at ~1.5% selectivity;
    ``no_rerank`` and ``no_pq`` take the exact scan."""
    metric = case if case in ("l2", "ip", "angular") else "l2"
    over = {"no_rerank": dict(rerank=False), "no_pq": dict(use_pq=False),
            "k5": dict(k=5)}.get(case, {})
    spec, _ = _both("price", 0, 14)
    mask = tiny_store.mask(spec)
    ref = ref_flat_filtered(
        tiny_index.corpus(), tiny_index.dataset.queries, mask,
        dataclasses.replace(tiny_index.config.search, **over), metric)
    got = flat_filtered_search(
        tiny_port.corpus(), tiny_port.dataset.queries, mask,
        dataclasses.replace(tiny_port.config.search, **over), metric)
    assert got.mode == ref.mode == "scan"
    assert got.selectivity == ref.selectivity
    _assert_same(got, ref, counters=False)
    _assert_same(got.result, ref.result)
    assert mask[got.ids[got.ids >= 0]].all()


@pytest.mark.parametrize("lo", [1000, 5000])
def test_empty_filter_matches_reference(tiny_index, tiny_port, tiny_store,
                                        lo):
    spec, _ = _both("price", lo)
    mask = tiny_store.mask(spec)
    ref = ref_flat_filtered(tiny_index.corpus(), tiny_index.dataset.queries,
                            mask, tiny_index.config.search, "l2")
    got = flat_filtered_search(tiny_port.corpus(), tiny_port.dataset.queries,
                               mask, tiny_port.config.search, "l2")
    assert got.mode == ref.mode == "empty" and got.selectivity == 0.0
    assert (got.ids == -1).all() and np.isinf(got.dists).all()
    _assert_same(got.result, ref.result)


@pytest.mark.parametrize("beam", [1, 4])
def test_masked_search_beta_one_no_nan(tiny_index, tiny_port, tiny_store,
                                       beam):
    """beta=1.0 with fewer than T passing candidates: the margin anchor is
    +inf and the threshold must stay +inf, not NaN."""
    spec, _ = _both("price", 0, 39)                         # ~4% passing
    mask = tiny_store.mask(spec)
    over = dict(beta=1.0, beam_width=beam)
    ref = ref_graph_search(
        tiny_index.corpus(), tiny_index.dataset.queries[:6],
        dataclasses.replace(tiny_index.config.search, **over), "l2",
        node_mask=mask)
    got = graph_search(tiny_port.corpus(), tiny_port.dataset.queries[:6],
                       dataclasses.replace(tiny_port.config.search, **over),
                       "l2", node_mask=mask)
    _assert_same(got, ref)
    ids = got.ids.numpy()
    assert (ids[:, 0] >= 0).any() and not np.isnan(got.dists.numpy()).any()
    assert mask[ids[ids >= 0]].all()


# ---------------------------------------------------------------------------
# Plan layer and the batch-flush engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("band", [("price", 0, 99), ("price", 0, 249),
                                  ("price", 0, 14), ("price", 1000, None),
                                  ("price", None, None)])
def test_searcher_filtered_matches_reference(tiny_index, tiny_port,
                                             tiny_store, ref_store, band):
    """``Searcher.search`` with a ``FilterSpec``: the same strategy,
    effective config, ids, distances and SearchStats as the reference."""
    spec, rspec = _both(*band)
    q = tiny_index.dataset.queries
    want = RefSearcher.open(tiny_index, attributes=ref_store).search(
        RefRequest(queries=q, filter=rspec))
    s = Searcher.open(tiny_port, attributes=tiny_store)
    got = s.search(SearchRequest(queries=q, filter=spec))
    assert got.plan.strategy == want.plan.strategy
    assert dataclasses.asdict(got.plan.cfg) == dataclasses.asdict(
        want.plan.cfg)
    assert got.plan.selectivity == want.plan.selectivity
    assert got.plan.attr_bits == want.plan.attr_bits
    _assert_same(got, want, counters=False)
    assert got.stats.as_dict() == want.stats.as_dict()
    s.search(SearchRequest(queries=q[:2], filter=spec))
    assert s.plan_cache_stats()["plan_cache_hits"] == 1


def test_filtered_search_needs_a_store(tiny_port):
    with pytest.raises(RuntimeError, match="attribute store"):
        Searcher.open(tiny_port).search(SearchRequest(
            queries=tiny_port.dataset.queries[:2],
            filter=FilterSpec.eq("category", 1)))


def test_engine_filtered_requests(tiny_port, tiny_store):
    """Batch-flush engine: filtered requests batch by plan and equal the
    direct filtered search; unfiltered ones are untouched; an all-pass
    spec is the unfiltered batch; a filter without a store raises at
    flush."""
    idx = tiny_port
    eng = ServingEngine(idx, batch_size=8, flush_us=0.0,
                        attributes=tiny_store)
    q = idx.dataset.queries[:12]
    spec = FilterSpec.range("price", 0, 99)
    rids_f = [eng.submit(v, filter=spec) for v in q[:6]]
    rids_u = [eng.submit(v) for v in q[6:]]
    eng.drain()
    assert eng.stats["filtered_queries"] == 6
    direct = flat_filtered_search(idx.corpus(), q[:6],
                                  tiny_store.mask(spec), eng.cfg, "l2",
                                  eng.filter_cfg)
    np.testing.assert_array_equal(
        np.stack([eng.done[r].ids for r in rids_f]), direct.ids)
    base = graph_search(idx.corpus(), q[6:], eng.cfg)
    np.testing.assert_array_equal(
        np.stack([eng.done[r].ids for r in rids_u]), base.ids.numpy())
    rid = eng.submit(q[0], filter=FilterSpec())
    eng.drain()
    assert eng.done[rid].filter is None
    scan = FilterSpec.range("price", 0, 14)
    eng.submit(q[0], filter=scan)
    eng.drain()
    assert eng.stats["filter_scan_batches"] == 1
    bare = ServingEngine(idx, batch_size=4, flush_us=0.0)
    bare.submit(q[0], filter=spec)
    with pytest.raises(RuntimeError):
        bare.drain()
