"""The port's index build against the reference's on the CPU.

The port computes the same rule with torch matrix products where the
reference uses numpy's, so a near-tie can resolve the other way.  The bar:
same entry point, >= 99% of adjacency rows identical, recall@10 within 0.01
(the share measured on this corpus is in PERF.md).  The numpy stages
(dataset, codebook init, medoid) are bit-identical.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import build_index as ref_build_index
from repro.core.dataset import pairwise_dist
from repro.core.graph import robust_prune as ref_robust_prune
from repro.core.search import graph_search as ref_graph_search
from repro_torch.core.dataset import recall_at_k
from repro_torch.core.graph import (
    build_knn_prune, medoid, pad_rows, robust_prune_batch,
)
from repro_torch.core.index import build_index, config_from_fields
from repro_torch.core.search import graph_search


@pytest.fixture(scope="module")
def flat_cfg(tiny_proxima_cfg):
    return dataclasses.replace(tiny_proxima_cfg, hot_node_fraction=0.0,
                               gap_encode=False)


@pytest.fixture(scope="module")
def both_indexes(flat_cfg):
    ref = ref_build_index(flat_cfg)
    port = build_index(config_from_fields(dataclasses.asdict(flat_cfg)),
                       device="cpu")
    return ref, port


@pytest.mark.parametrize("metric", ["l2", "ip", "angular"])
def test_robust_prune_batch_matches_reference(metric):
    rng = np.random.default_rng(3)
    base = rng.standard_normal((400, 16)).astype(np.float32)
    nodes = rng.choice(400, 40, replace=False)
    cands, dists = [], []
    for i in nodes:
        c = rng.choice(np.delete(np.arange(400), i), 60, replace=False)
        cands.append(c)
        dists.append(pairwise_dist(base[i : i + 1], base[c], metric)[0])
    cands, dists = np.stack(cands), np.stack(dists).astype(np.float32)
    cands[::7, 50:] = -1                       # ragged rows: -1 / +inf pad
    dists[::7, 50:] = np.inf
    got = robust_prune_batch(torch.as_tensor(cands), torch.as_tensor(dists),
                             torch.as_tensor(base), metric, 12, 1.2).numpy()
    for row, c, d in zip(got, cands, dists):
        valid = c >= 0
        want = ref_robust_prune(c[valid], d[valid], base, metric, 12, 1.2)
        assert row[row >= 0].tolist() == want


def test_pad_rows_matches_reference():
    from repro.core.graph import _pad_rows

    rows = [[3, 3, 0, 5, 2], [1], [], [4, 0, 4, 1, 2, 3], [0, 1, 2]]
    table = torch.full((5, 6), -1, dtype=torch.int64)
    for i, r in enumerate(rows):
        table[i, : len(r)] = torch.tensor(r, dtype=torch.int64)
    adj, deg = pad_rows(table, 3)
    want_adj, want_deg = _pad_rows(rows, 3, 5)
    np.testing.assert_array_equal(adj, want_adj)
    np.testing.assert_array_equal(deg, want_deg)


def test_build_knn_prune_matches_reference(both_indexes, flat_cfg):
    ref, _ = both_indexes
    base = ref.dataset.base
    got = build_knn_prune(base, flat_cfg.graph, "l2", device="cpu")
    want = ref.graph
    assert got.entry_point == want.entry_point == medoid(base, "l2")
    rows_same = (got.adjacency == want.adjacency).all(1).mean()
    print(f"adjacency rows identical to the reference: {rows_same:.4f}")
    assert rows_same >= 0.99, rows_same
    assert (got.degrees == want.degrees).mean() >= 0.99


def test_build_index_matches_reference(both_indexes, flat_cfg):
    """build_index(hot_node_fraction=0, gap_encode=False): same data, codebook
    at atol 1e-4, codes identical, graph as above, recall@10 within 0.01."""
    ref, port = both_indexes
    for f in ("base", "queries", "gt"):
        np.testing.assert_array_equal(getattr(port.dataset, f),
                                      getattr(ref.dataset, f))
    np.testing.assert_allclose(port.codebook.centroids,
                               ref.codebook.centroids, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(port.codes, ref.codes)
    assert port.graph.entry_point == ref.graph.entry_point
    assert (port.graph.adjacency == ref.graph.adjacency).all(1).mean() >= 0.99
    assert port.hot_count == ref.hot_count == 0
    rp = graph_search(port.corpus(), port.dataset.queries, port.config.search)
    rr = ref_graph_search(ref.corpus(), ref.dataset.queries, flat_cfg.search)
    rec_p = recall_at_k(rp.ids.numpy(), port.dataset.gt, 10)
    rec_r = recall_at_k(np.asarray(rr.ids), ref.dataset.gt, 10)
    assert abs(rec_p - rec_r) <= 0.01, (rec_p, rec_r)
    assert port.index_bytes()["pq_bytes"] == ref.index_bytes()["pq_bytes"]


def test_build_ensures_every_node_reachable(both_indexes):
    from repro_torch.core.graph import _reachable

    _, port = both_indexes
    rows = torch.as_tensor(port.graph.adjacency).long()
    assert bool(_reachable(rows, port.graph.entry_point).all())


@pytest.mark.parametrize("change,item", [
    (dict(hot_node_fraction=0.03), "reorder"),
    (dict(gap_encode=True), "gap"),
])
def test_unported_build_options_raise(flat_cfg, change, item):
    cfg = config_from_fields(dataclasses.asdict(
        dataclasses.replace(flat_cfg, **change)))
    with pytest.raises(NotImplementedError, match=item):
        build_index(cfg, device="cpu")
