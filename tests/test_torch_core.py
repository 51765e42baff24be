"""The port's core modules against the reference on the CPU: configs,
dataset, PQ, the Bloom visited set, and the search bar of ROADMAP.md — on
``tiny_index``, carried across with ``index_from_arrays``, at beam widths 1
and 4 and metrics l2/ip/angular, the port's ``graph_search`` returns the
reference jnp path's top-k ids and hops/pq/acc/hot/free/rounds counters
exactly, with distances within rtol 1e-5.

Distance tolerance: rtol 1e-5 plus an absolute 1e-6 of the batch's largest
distance.  The absolute part is float32 rounding of a dot product, which
scales with sum |q_i x_i| and not with the result: an ip distance that
nearly cancels keeps the rounding error of its much larger terms, summed
in another order by XLA than by torch (PERF.md).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import port_index
from repro.configs import base as ref_cfg
from repro.core import bloom as ref_bloom
from repro.core import pq as ref_pq
from repro.core.dataset import make_dataset as ref_make_dataset
from repro.core.search import graph_search as ref_graph_search
from repro_torch.configs import base as port_cfg
from repro_torch.core import bloom, pq
from repro_torch.core.dataset import make_dataset
from repro_torch.core.search import (
    finalize_search, graph_search, graph_search_step, graph_search_stepped,
    init_search_state, search_state_active,
)

COUNTERS = ("n_hops", "n_pq", "n_acc", "n_hot_hops", "n_free_pq", "rounds")
CONFIG_CLASSES = ("PQConfig", "GraphConfig", "SearchConfig", "DatasetConfig",
                  "StreamConfig", "BuildConfig", "ShardConfig", "FilterConfig",
                  "ObsConfig", "PlanConfig", "ProximaConfig")


@pytest.fixture(scope="module")
def tiny_port(tiny_index):
    return port_index(tiny_index)


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_fields_and_defaults_match_reference(name):
    ref, port = getattr(ref_cfg, name), getattr(port_cfg, name)
    fr = [(f.name, f.default) for f in dataclasses.fields(ref)]
    fp = [(f.name, f.default) for f in dataclasses.fields(port)]
    assert fr == fp
    assert dataclasses.asdict(ref()) == dataclasses.asdict(port())


@pytest.mark.parametrize("name,metric", [("sift-like", "l2"),
                                         ("glove-like", "angular"),
                                         ("deep-like", "ip")])
def test_make_dataset_bit_identical(name, metric):
    kw = dict(name=name, num_base=600, num_queries=12, dim=32,
              num_clusters=8, metric=metric)
    ref = ref_make_dataset(ref_cfg.DatasetConfig(**kw), k_gt=20)
    got = make_dataset(port_cfg.DatasetConfig(**kw), k_gt=20, device="cpu")
    assert got.metric == ref.metric
    for f in ("base", "queries", "gt"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_bloom_same_bits_as_reference():
    """One id stream, inserted in masked batches: the port's packed words
    equal the reference's uint32 bit array, and membership agrees."""
    rng = np.random.default_rng(1)
    num_bits, h = 1 << 12, 8
    ref_bits = ref_bloom.bloom_init(num_bits)
    bits = bloom.bloom_init(num_bits, 1, "cpu")
    for _ in range(6):
        ids = rng.integers(0, 1 << 20, 48).astype(np.int32)
        mask = rng.random(48) < 0.7
        ref_bits = ref_bloom.insert(ref_bits, jnp.asarray(ids),
                                    jnp.asarray(mask), h)
        bloom.insert(bits, torch.as_tensor(ids)[None],
                     torch.as_tensor(mask)[None], h)
    np.testing.assert_array_equal(
        bloom.packed_words(bits)[0].numpy(),
        np.asarray(ref_bits).astype(np.int64))
    probe = rng.integers(0, 1 << 20, 500).astype(np.int32)
    np.testing.assert_array_equal(
        bloom.contains(bits, torch.as_tensor(probe)[None], h)[0].numpy(),
        np.asarray(ref_bloom.contains(ref_bits, jnp.asarray(probe), h)))
    assert bloom.false_positive_rate(num_bits, h, 200) == \
        ref_bloom.false_positive_rate(num_bits, h, 200)


def test_empty_search_result_matches_reference():
    from repro.core.search import empty_search_result as ref_empty
    from repro_torch.core.search import empty_search_result

    got, want = empty_search_result(3, 5, device="cpu"), ref_empty(3, 5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.numpy().dtype == np.asarray(b).dtype


def test_compute_adt_pq_distance_encode_match_reference(tiny_index):
    """compute_adt and pq_distance at rtol/atol 1e-5 (same expanded form);
    encode's codes identical."""
    cents = tiny_index.codebook.centroids
    qs = tiny_index.dataset.queries
    for metric in ("l2", "ip"):
        got = pq.compute_adt(torch.tensor(qs), torch.tensor(cents), metric)
        for i in range(4):
            want = ref_pq.compute_adt(jnp.asarray(qs[i]), jnp.asarray(cents),
                                      metric)
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        codes = tiny_index.codes[:200]
        d = pq.pq_distance(torch.tensor(codes)[None].expand(2, -1, -1),
                           got[:2])
        for i in range(2):
            want = ref_pq.pq_distance(jnp.asarray(codes), jnp.asarray(got[i].numpy()))
            np.testing.assert_allclose(d[i].numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    base = tiny_index.dataset.base[:500]
    want = np.asarray(ref_pq.encode(jnp.asarray(base), jnp.asarray(cents)))
    got = pq.encode(torch.tensor(base), torch.tensor(cents)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pq.decode(got, cents), ref_pq.decode(want, cents))


def test_train_pq_matches_reference(tiny_proxima_cfg):
    """Same numpy init, same Lloyd steps: centroids allclose at atol 1e-4."""
    data = ref_make_dataset(tiny_proxima_cfg.dataset, k_gt=1).base
    want = ref_pq.train_pq(data, tiny_proxima_cfg.pq, "l2").centroids
    pcfg = port_cfg.PQConfig(**dataclasses.asdict(tiny_proxima_cfg.pq))
    got = pq.train_pq(data, pcfg, "l2", device="cpu").centroids
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _assert_same_result(got, ref):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    rd = np.asarray(ref.dists)
    np.testing.assert_allclose(got.dists.numpy(), rd, rtol=1e-5,
                               atol=1e-6 * np.abs(rd).max())


@pytest.mark.parametrize("beam", [1, 4])
@pytest.mark.parametrize("metric", ["l2", "ip", "angular"])
def test_search_bar_matches_reference_jnp_path(tiny_index, tiny_port, beam,
                                               metric):
    cfg = dataclasses.replace(tiny_index.config.search, beam_width=beam)
    ref = ref_graph_search(tiny_index.corpus(), tiny_index.dataset.queries,
                           cfg, metric)
    pcfg = dataclasses.replace(tiny_port.config.search, beam_width=beam)
    got = graph_search(tiny_port.corpus(), tiny_port.dataset.queries, pcfg,
                       metric)
    _assert_same_result(got, ref)
    assert got.ids.dtype == torch.int32


@pytest.mark.parametrize("variant", [
    dict(use_pq=False, early_termination=False),
    dict(rerank=False),
    dict(early_termination=False, beam_width=4),
])
def test_search_config_variants_match_reference(tiny_index, tiny_port, variant):
    cfg = dataclasses.replace(tiny_index.config.search, **variant)
    ref = ref_graph_search(tiny_index.corpus(), tiny_index.dataset.queries,
                           cfg, "l2")
    pcfg = dataclasses.replace(tiny_port.config.search, **variant)
    got = graph_search(tiny_port.corpus(), tiny_port.dataset.queries, pcfg)
    _assert_same_result(got, ref)


@pytest.mark.parametrize("beam", [1, 4])
def test_stepping_to_quiescence_equals_graph_search(tiny_port, beam):
    cfg = dataclasses.replace(tiny_port.config.search, beam_width=beam)
    corpus, q = tiny_port.corpus(), tiny_port.dataset.queries
    whole = graph_search(corpus, q, cfg)
    stepped = graph_search_stepped(corpus, q, cfg)
    state = init_search_state(corpus, q, cfg)
    while bool(search_state_active(state, cfg).any()):
        state = graph_search_step(corpus, state, cfg)
    for _ in range(3):                       # extra steps are no-ops
        state = graph_search_step(corpus, state, cfg)
    manual = finalize_search(corpus, state, cfg)
    for a, b, c in zip(whole, stepped, manual):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("beam", [1, 4])
def test_all_pass_node_mask_is_bit_identical(tiny_port, beam):
    """An all-true node mask takes the filtered traversal and finalize, and
    every selection reduces to the unfiltered arithmetic: ids, distances
    and counters bit for bit, through ``graph_search`` and
    ``graph_search_stepped``."""
    cfg = dataclasses.replace(tiny_port.config.search, beam_width=beam)
    corpus, q = tiny_port.corpus(), tiny_port.dataset.queries
    mask = np.ones(tiny_port.dataset.num_base, bool)
    whole = graph_search(corpus, q, cfg)
    for got in (graph_search(corpus, q, cfg, node_mask=mask),
                graph_search_stepped(corpus, q, cfg, node_mask=mask)):
        assert all(torch.equal(a, b) for a, b in zip(whole, got))
