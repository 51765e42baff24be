"""The port's index build against the reference's on the CPU.

The port computes the same rule with torch matrix products where the
reference uses numpy's, so a near-tie can resolve the other way.  The bar:
same entry point, >= 99% of adjacency rows identical, recall@10 within 0.01
(the share measured on this corpus is in PERF.md).  The numpy stages
(dataset, codebook init, medoid, reservoir) are bit-identical.

With the fixture's own config (hot nodes 3%, gap encoding on) the bar holds
through the reordering: the same hot count and entry point, adjacency rows
compared by original id through each build's ``inv``.  The segmented build
at three segments: the same reservoir sample, and recall@10 through
``to_flat()`` and through the tiles within 0.01 of the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import build_index as ref_build_index
from repro.core import build_segmented as ref_build_segmented
from repro.core.dataset import ArraySegmentSource as RefArraySource
from repro.core.dataset import SyntheticSegmentSource as RefSyntheticSource
from repro.core.segmented import reservoir_sample as ref_reservoir_sample
from repro.core.dataset import pairwise_dist
from repro.core.graph import robust_prune as ref_robust_prune
from repro.core.search import graph_search as ref_graph_search
from repro_torch.configs.base import DatasetConfig
from repro_torch.core.dataset import (
    ArraySegmentSource, Dataset, SyntheticSegmentSource, recall_at_k,
)
from repro_torch.core.graph import (
    build_knn_prune, medoid, pad_rows, robust_prune_batch,
)
from repro_torch.core.index import (
    build_index, build_index_monolithic, config_from_fields,
)
from repro_torch.core.search import graph_search
from repro_torch.core.segmented import build_segmented, reservoir_sample
from repro_torch.plan import Searcher, SearchRequest


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
    """The two options the first slices refused now build: hot nodes give
    a reordering with the hottest 3% first and the entry point at 0; gap
    encoding gives the adjacency's bits, which decode to its sorted rows."""
    from repro_torch.core.gap_encoding import gap_decode

    cfg = config_from_fields(dataclasses.asdict(
        dataclasses.replace(flat_cfg, **change)))
    idx = build_index(cfg, device="cpu", reorder_samples=8)
    if item == "reorder":
        assert idx.hot_count == 45 and idx.gap is None
        assert idx.graph.entry_point == 0
        np.testing.assert_array_equal(idx.reordering.perm[idx.reordering.inv],
                                      np.arange(idx.dataset.num_base))
    else:
        assert idx.reordering is None and idx.hot_count == 0
        np.testing.assert_array_equal(gap_decode(idx.gap),
                                      np.sort(idx.graph.adjacency, axis=1))
        b = idx.index_bytes()
        assert b["index_bytes_gap"] == idx.gap.encoded_bytes \
            < b["index_bytes_uncompressed"]


def _by_original_id(index) -> np.ndarray:
    """Adjacency rows and contents in the original (pre-reorder) ids."""
    inv = index.reordering.inv
    out = np.empty_like(index.graph.adjacency)
    out[inv] = inv[index.graph.adjacency]
    return out


@pytest.fixture(scope="module")
def default_port(tiny_proxima_cfg):
    return build_index(config_from_fields(dataclasses.asdict(
        tiny_proxima_cfg)), device="cpu", reorder_samples=24)


def test_build_index_default_config_matches_reference(tiny_index,
                                                      default_port):
    """hot 3%, gap on: the same hot count and entry point, >= 99% of rows
    identical by original id, recall@10 within 0.01; the gap encoding and
    the byte accounting are the port's own build's."""
    from repro_torch.core.gap_encoding import gap_encode

    ref, port = tiny_index, default_port
    assert port.hot_count == ref.hot_count == 45
    assert port.graph.entry_point == ref.graph.entry_point == 0
    same = (_by_original_id(port) == _by_original_id(ref)).all(1).mean()
    assert same >= 0.99, same
    np.testing.assert_array_equal(port.dataset.gt,
                                  port.reordering.perm[ref.reordering.inv[
                                      ref.dataset.gt]])
    rp = graph_search(port.corpus(), port.dataset.queries, port.config.search)
    rr = ref_graph_search(ref.corpus(), ref.dataset.queries, ref.config.search)
    rec_p = recall_at_k(rp.ids.numpy(), port.dataset.gt, 10)
    rec_r = recall_at_k(np.asarray(rr.ids), ref.dataset.gt, 10)
    assert abs(rec_p - rec_r) <= 0.01, (rec_p, rec_r)
    np.testing.assert_array_equal(port.gap.bits,
                                  gap_encode(port.graph.adjacency).bits)
    assert set(port.index_bytes()) == set(ref.index_bytes())
    assert port.index_bytes()["hot_repetition_bytes"] == \
        ref.index_bytes()["hot_repetition_bytes"]


def test_build_index_is_the_monolithic_pipeline(tiny_proxima_cfg,
                                                default_port):
    """build_index (the single-segment segmented build) equals the one-pass
    pipeline bit for bit, calibrated beta included."""
    cfg = config_from_fields(dataclasses.asdict(tiny_proxima_cfg))
    mono = build_index_monolithic(cfg, device="cpu", reorder_samples=24,
                                  calibrate=True)
    seg = build_index(cfg, device="cpu", reorder_samples=24, calibrate=True)
    for a, b in ((mono, seg), (mono, default_port)):
        np.testing.assert_array_equal(a.graph.adjacency, b.graph.adjacency)
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.reordering.perm, b.reordering.perm)
        np.testing.assert_array_equal(a.gap.bits, b.gap.bits)
        np.testing.assert_array_equal(a.dataset.gt, b.dataset.gt)
    assert mono.calibrated_beta == seg.calibrated_beta > 1.0


@pytest.fixture(scope="module")
def segmented_pair(tiny_index):
    """The reference's and the port's three-segment builds of the
    fixture's dataset."""
    from repro.core.dataset import make_dataset as ref_make_dataset

    cfg = tiny_index.config
    ref_ds = ref_make_dataset(cfg.dataset)
    pcfg = config_from_fields(dataclasses.asdict(cfg))
    port_ds = Dataset(base=ref_ds.base.copy(), queries=ref_ds.queries.copy(),
                      gt=ref_ds.gt.copy(), metric=ref_ds.metric,
                      config=pcfg.dataset)
    ref = ref_build_segmented(cfg, dataset=ref_ds, segment_size=500,
                              reorder_samples=24)
    port = build_segmented(pcfg, dataset=port_ds, segment_size=500,
                           reorder_samples=24, device="cpu")
    return ref, port


def test_reservoir_and_sources_match_reference(tiny_index):
    base = np.array(tiny_index.dataset.base)
    for seg in (500, 700):
        np.testing.assert_array_equal(
            reservoir_sample(ArraySegmentSource(base, seg), 300, 0),
            ref_reservoir_sample(RefArraySource(base, seg), 300, 0))
    kw = dict(name="sift-like", num_base=900, dim=16, num_clusters=8, seed=2)
    syn = SyntheticSegmentSource(DatasetConfig(**kw), 400)
    ref_syn = RefSyntheticSource(type(tiny_index.config.dataset)(**kw), 400)
    assert syn.num_segments == ref_syn.num_segments == 3
    for s in range(3):
        assert syn.bounds(s) == ref_syn.bounds(s)
        np.testing.assert_array_equal(syn.segment(s), ref_syn.segment(s))
    np.testing.assert_array_equal(
        reservoir_sample(syn, 200, 1), ref_reservoir_sample(ref_syn, 200, 1))


def test_build_segmented_three_segments_matches_reference(segmented_pair):
    """Three segments: recall@10 through to_flat() (the stitched graph) and
    through the tiles within 0.01 of the reference's; the per-segment hot
    counts, stitch accounting and byte totals are the reference's, and
    its NAND build trace carries its segment sizes and patched rows."""
    from repro.plan import Searcher as RefSearcher
    from repro.plan import SearchRequest as RefRequest

    ref, port = segmented_pair
    assert port.num_segments == ref.num_segments == 3
    assert [s.hot_count for s in port.segments] == \
        [s.hot_count for s in ref.segments]
    fr, fp = ref.to_flat(), port.to_flat()
    assert fp.hot_count == 0 and fp.graph.entry_point == fr.graph.entry_point
    q = fr.dataset.queries
    rec = {}
    for name, ids_r, ids_p, gt_r, gt_p in (
            ("flat", RefSearcher.open(fr).search(RefRequest(queries=q)).ids,
             Searcher.open(fp).search(SearchRequest(queries=q)).ids,
             fr.dataset.gt, fp.dataset.gt),
            ("tiles", RefSearcher.open(ref).search(RefRequest(queries=q)).ids,
             Searcher.open(port).search(SearchRequest(queries=q)).ids,
             ref.global_perm()[ref.dataset.gt],
             port.global_perm()[port.dataset.gt])):
        rec[name] = (recall_at_k(np.asarray(ids_p), gt_p, 10),
                     recall_at_k(np.asarray(ids_r), gt_r, 10))
        assert abs(rec[name][0] - rec[name][1]) <= 0.01, (name, rec)
    assert port.stitch.patched_rows > 0 and port.stitch.cross_edges > 0
    bp, br = port.index_bytes(), ref.index_bytes()
    assert bp["raw_bytes"] == br["raw_bytes"] and len(bp["per_segment"]) == 3
    assert port.segment_centroids().shape == ref.segment_centroids().shape
    bt, bt_ref = port.build_trace(), ref.build_trace()
    assert bt.segment_sizes == tuple(g.num_vertices for g in port.segments)
    assert bt.stitched_rows == port.stitch.patched_rows
    assert (bt.dim, bt.r_degree, bt.index_bits, bt.pq_bits) == (
        bt_ref.dim, bt_ref.r_degree, bt_ref.index_bits, bt_ref.pq_bits)
    assert bt.segment_sizes == bt_ref.segment_sizes


@pytest.mark.parametrize("metric", ["l2", "angular"])
def test_windowed_knn_prune_equals_whole_lists(flat_cfg, metric, monkeypatch):
    """A long build list (the segments' and tiles' compensated lists) takes
    the windowed kNN + prune, which must keep what the prune over the whole
    sorted lists keeps: the same graph (here fetches of 24, then 96, and
    windows of 16 over lists of 150)."""
    from repro_torch.core import graph as graph_mod

    base = np.random.default_rng(6).standard_normal((600, 16)).astype(
        np.float32)
    cfg = dataclasses.replace(flat_cfg.graph, max_degree=12,
                              build_list_size=150)
    whole = build_knn_prune(base, cfg, metric, device="cpu")
    monkeypatch.setattr(graph_mod, "_LONG_LIST", 16)
    monkeypatch.setattr(graph_mod, "_FETCH", 24)
    monkeypatch.setattr(graph_mod, "_WINDOW", 16)
    windowed = build_knn_prune(base, cfg, metric, device="cpu")
    np.testing.assert_array_equal(windowed.adjacency, whole.adjacency)
    np.testing.assert_array_equal(windowed.degrees, whole.degrees)
    assert windowed.entry_point == whole.entry_point
