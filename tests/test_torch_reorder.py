"""The port's hot-node reordering, its oracle and gap encoding against the
reference on the CPU, on ``tiny_index``'s graph arrays:

* ``search_reference`` returns the reference's ids, counters and ``trace``
  histogram exactly at E=1 and 4, for l2/ip/angular, with ``hot_count``,
  with a ``node_mask`` and without PQ; distances within rtol 1e-5 plus 1e-6
  of the largest (the search bar of ROADMAP.md, tests/test_torch_core.py
  says why);
* ``trace_visit_frequency`` and ``reorder_graph`` give the same histogram,
  ``perm``, ``inv`` and ``hot_count``; ``reorder_segment`` permutes every
  row-aligned array alike;
* ``gap_encode`` gives the same bits and width, ``gap_decode`` round-trips;
* ``calibrate_beta`` within rtol 1e-4 (the same numpy draws and accurate
  distances; the PQ sums add in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import gap_encoding as ref_gap
from repro.core import pq as ref_pq
from repro.core import reorder as ref_reorder
from repro.core.search import search_reference as ref_search_reference
from repro_torch.configs.base import SearchConfig
from repro_torch.core import gap_encoding as gap
from repro_torch.core import pq, reorder
from repro_torch.core.dataset import normalize
from repro_torch.core.graph import Graph
from repro_torch.core.search import search_reference


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's single-query tensors: the
    suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(index, metric):
    """The reference corpus's arrays (base unit-normalized for angular, as
    the reorder trace passes it), as copies."""
    base = np.array(index.dataset.base, np.float32)
    if metric == "angular":
        base = normalize(base).astype(np.float32)
    return (np.array(index.graph.adjacency), np.array(index.graph.degrees),
            np.array(index.codes), base,
            np.array(index.codebook.centroids))


def _port_cfg(cfg) -> SearchConfig:
    return SearchConfig(**dataclasses.asdict(cfg))


def _both(index, cfg, metric, node_mask=None, n=None):
    """Run both oracles over the fixture's queries; assert the bar."""
    adj, deg, codes, base, cents = _arrays(index, metric)
    n_v = adj.shape[0]
    tr_ref, tr = np.zeros(n_v, np.int64), np.zeros(n_v, np.int64)
    t_codes, t_base = torch.tensor(codes), torch.tensor(base)
    t_cents = torch.tensor(cents)
    for q in index.dataset.queries[:n]:
        want = ref_search_reference(
            adj, deg, codes, base, cents, index.graph.entry_point, q, cfg,
            metric, hot_count=index.hot_count, trace=tr_ref,
            node_mask=node_mask)
        got = search_reference(
            adj, deg, t_codes, t_base, t_cents, index.graph.entry_point, q,
            _port_cfg(cfg), metric, hot_count=index.hot_count, trace=tr,
            node_mask=node_mask)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[2] == want[2]
        fin = np.isfinite(want[1])
        np.testing.assert_array_equal(np.isfinite(got[1]), fin)
        np.testing.assert_allclose(
            got[1][fin], want[1][fin], rtol=1e-5,
            atol=1e-6 * np.abs(want[1][fin]).max(initial=0.0))
    np.testing.assert_array_equal(tr, tr_ref)
    assert tr.sum() > 0


@pytest.mark.parametrize("beam", [1, 4])
@pytest.mark.parametrize("metric", ["l2", "ip", "angular"])
def test_search_reference_matches_reference(tiny_index, beam, metric):
    cfg = dataclasses.replace(tiny_index.config.search, beam_width=beam)
    _both(tiny_index, cfg, metric)


@pytest.mark.parametrize("beam", [1, 4])
def test_search_reference_node_mask_matches_reference(tiny_index, beam):
    mask = np.random.default_rng(4).random(tiny_index.dataset.num_base) < 0.3
    cfg = dataclasses.replace(tiny_index.config.search, beam_width=beam)
    _both(tiny_index, cfg, "l2", node_mask=mask)


@pytest.mark.parametrize("variant", [
    dict(use_pq=False, early_termination=False),
    dict(rerank=False, beta=1.0),
])
def test_search_reference_variants_match_reference(tiny_index, variant):
    cfg = dataclasses.replace(tiny_index.config.search, **variant)
    _both(tiny_index, cfg, "l2", n=8)


def test_trace_and_reorder_match_reference(tiny_index):
    """The trace over sampled base vectors and the renumbering: the same
    histogram, perm, inv, hot_count, graph and permuted arrays."""
    adj, deg, codes, base, cents = _arrays(tiny_index, "l2")
    cfg = tiny_index.config.search
    ref_graph = type(tiny_index.graph)(adjacency=adj, degrees=deg,
                                       entry_point=tiny_index.graph.entry_point,
                                       metric="l2")
    graph = Graph(adjacency=adj.copy(), degrees=deg.copy(),
                  entry_point=tiny_index.graph.entry_point, metric="l2")
    want = ref_reorder.trace_visit_frequency(ref_graph, base, codes, cents,
                                             cfg, "l2", num_samples=24,
                                             seed=3)
    got = reorder.trace_visit_frequency(graph, base, codes, cents,
                                        _port_cfg(cfg), "l2", num_samples=24,
                                        seed=3, device="cpu")
    np.testing.assert_array_equal(got, want)
    g_ref, r_ref = ref_reorder.reorder_graph(ref_graph, want, 0.03)
    g, r = reorder.reorder_graph(graph, got, 0.03)
    for a, b in ((r.perm, r_ref.perm), (r.inv, r_ref.inv),
                 (g.adjacency, g_ref.adjacency), (g.degrees, g_ref.degrees)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (r.hot_count, g.entry_point) == (r_ref.hot_count, g_ref.entry_point)
    assert g.entry_point == 0 and r.hot_count == 45
    gt = tiny_index.dataset.gt
    np.testing.assert_array_equal(reorder.remap_ground_truth(r, gt),
                                  ref_reorder.remap_ground_truth(r_ref, gt))
    # the trace reads the encoder input; every row-aligned array follows
    out = reorder.reorder_segment(graph, base * 2, base, codes, cents,
                                  _port_cfg(cfg), "l2", 0.03, num_samples=24,
                                  seed=3, device="cpu")
    np.testing.assert_array_equal(out[4].perm, r.perm)
    np.testing.assert_array_equal(out[1], 2 * base[r.inv])
    np.testing.assert_array_equal(out[2], base[r.inv])
    np.testing.assert_array_equal(out[3], codes[r.inv])


@pytest.mark.parametrize("rows", ["index", "ragged"])
def test_gap_encode_matches_reference(tiny_index, rows):
    adj = np.array(tiny_index.graph.adjacency)
    if rows == "ragged":
        adj = np.random.default_rng(5).integers(0, 1 << 20, (37, 9),
                                                dtype=np.int64).astype(np.int32)
    got, want = gap.gap_encode(adj), ref_gap.gap_encode(adj)
    assert got.bit_width == want.bit_width
    assert got.bits.dtype == want.bits.dtype
    np.testing.assert_array_equal(got.bits, want.bits)
    np.testing.assert_array_equal(gap.gap_decode(got), np.sort(adj, axis=1))
    assert gap.gap_stats(adj) == ref_gap.gap_stats(adj)
    assert 0 < got.compression_ratio < 1


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_calibrate_beta_matches_reference(tiny_index, metric):
    cb = tiny_index.codebook
    codes = np.array(tiny_index.codes)
    base = np.array(tiny_index.dataset.base)
    want = ref_pq.calibrate_beta(ref_pq.PQCodebook(cb.centroids, metric),
                                 codes, base, np.random.default_rng(0),
                                 num_samples=64, num_targets=128)
    got = pq.calibrate_beta(pq.PQCodebook(np.array(cb.centroids), metric),
                            codes, base, np.random.default_rng(0),
                            num_samples=64, num_targets=128, device="cpu")
    assert got >= 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4)
