"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the ``cuda``
fixture decides at run time).  On a machine with a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: ADT and lookup rtol/atol 1e-4 (tests/test_kernels.py; the
lookup's warp sums in a tree, the plain version left to right; the ADT's
kernel fuses multiply and add), rerank 1e-4/1e-3 (a warp's tree sum over D
against torch's order) with the masked entry's pass-through of acc exact,
the sort and the merge exact, with ties, +inf and -0.0/+0.0.  The search on CUDA is held
against the CPU search of the same index: identical ids on >= 95% of rows,
since the kernels' ADT rounds differently from the CPU's expanded form.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

RNG = np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a, dev):
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


@pytest.mark.parametrize("q,m,c,dsub", [(1, 8, 64, 2), (8, 16, 256, 4),
                                        (4, 32, 256, 3), (2, 25, 128, 4),
                                        (256, 32, 256, 4), (13, 30, 256, 4),
                                        (257, 25, 100, 2), (19, 7, 100, 3),
                                        (11, 9, 100, 4), (5, 6, 50, 4),
                                        (3, 5, 7, 3), (9, 3, 1100, 4)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pq_adt_kernel(cuda, q, m, c, dsub, metric):
    """The tile is 8 queries x (256 / ceil(C/4)) subspaces: Q not a multiple
    of 8, M not a multiple of the tile, C not a multiple of 4 (50, 7), dsub
    2 and 3 (scalar codebook loads) and C > 1024 (threads loop over the
    centroids) are all ragged edges of the one kernel."""
    qs = _t(RNG.standard_normal((q, m * dsub)).astype(np.float32), cuda)
    cents = _t(RNG.standard_normal((m, c, dsub)).astype(np.float32), cuda)
    got = ops.pq_adt(qs, cents, metric)
    torch.cuda.synchronize()
    want = ops.pq_adt_plain(qs, cents, metric)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,m,c", [(1, 8, 16), (37, 16, 64), (300, 32, 256),
                                   (50, 25, 128), (5000, 64, 256)])
def test_pq_lookup_kernel(cuda, n, m, c):
    codes = _t(RNG.integers(0, c, (n, m)).astype(np.uint8), cuda)
    adt = _t(RNG.standard_normal((m, c)).astype(np.float32), cuda)
    got = ops.pq_lookup(codes, adt)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ops.pq_lookup_plain(codes, adt),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("q,n,big_n,m,c", [(1, 1, 10, 8, 16),
                                           (5, 40, 700, 25, 64),
                                           (24, 96, 1500, 32, 128),
                                           (256, 64, 100000, 32, 256),
                                           (8, 256, 5000, 64, 256)])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_pq_lookup_gather_kernel(cuda, q, n, big_n, m, c, masked):
    ids = _t(RNG.integers(0, big_n, (q, n)).astype(np.int32), cuda)
    codes = _t(RNG.integers(0, c, (big_n, m)).astype(np.uint8), cuda)
    adts = _t(RNG.standard_normal((q, m, c)).astype(np.float32), cuda)
    mask = _t(RNG.random((q, n)) < 0.5, cuda) if masked else None
    got = ops.pq_lookup_gather(ids, codes, adts, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, ops.pq_lookup_gather_plain(ids, codes, adts, mask), rtol=1e-4,
        atol=1e-4)


def _signed(keys):
    """Flip the sign of about half the keys: negative keys, and -0.0 beside
    +0.0 (equal keys, so they keep their input order)."""
    return np.where(RNG.random(keys.shape) < 0.5, -keys, keys).astype(
        np.float32)


@pytest.mark.parametrize("q,l", [(1, 2), (3, 8), (1, 32), (5, 64), (16, 256),
                                 (256, 256), (9, 512), (4, 1024), (3, 4096),
                                 (2, 16384)])
def test_bitonic_kernel_exact_with_ties(cuda, q, l):
    # few distinct keys: many ties, -0.0 and +0.0, plus +inf padding like
    # the merge's; rows up to 1024 take the warp path, longer the block path
    keys = _signed(RNG.integers(0, 8, (q, l)).astype(np.float32))
    keys[:, l // 2:] = np.where(RNG.random((q, l - l // 2)) < 0.5, np.inf,
                                keys[:, l // 2:])
    vals = RNG.integers(0, 1 << 20, (q, l)).astype(np.int32)
    gk, gv = ops.bitonic_sort_pairs(_t(keys, cuda), _t(vals, cuda))
    torch.cuda.synchronize()
    wk, wv = ops.bitonic_sort_pairs_plain(_t(keys, cuda), _t(vals, cuda))
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


@pytest.mark.parametrize("q,k,d", [(1, 16, 32), (6, 64, 128), (3, 128, 96),
                                   (256, 128, 128)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_l2_rerank_kernels(cuda, q, k, d, metric):
    qs = _t(RNG.standard_normal((q, d)).astype(np.float32), cuda)
    cands = _t(RNG.standard_normal((q, k, d)).astype(np.float32), cuda)
    got = ops.l2_rerank(qs, cands, metric)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ops.l2_rerank_plain(qs, cands, metric),
                               rtol=1e-4, atol=1e-3)
    # the masked entry asked for every row
    base = _t(RNG.standard_normal((5000, d)).astype(np.float32), cuda)
    ids = _t(RNG.integers(0, 5000, (q, k)).astype(np.int32), cuda)
    acc = torch.zeros((q, k), device=cuda)
    mask = torch.ones((q, k), dtype=torch.bool, device=cuda)
    got = ops.l2_rerank_masked(qs, ids, base, acc, mask, metric)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, ops.l2_rerank_masked_plain(qs, ids, base, acc, mask, metric),
        rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("q,k,d", [(256, 128, 128), (7, 128, 96),
                                   (5, 45, 36), (3, 100, 21), (4, 70, 130),
                                   (2, 33, 300)])
@pytest.mark.parametrize("density", [0.0, 0.05, 1.0],
                         ids=["none", "sparse", "all"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_l2_rerank_masked_kernel(cuda, q, k, d, density, metric):
    """The masked entry against its plain version: the direct form where
    the mask holds (rtol 1e-4 / atol 1e-3, the warp sums in a tree), acc
    bit for bit elsewhere, -1 padding outside the mask never read.  D=128,
    96 and 36 hold the query in registers as float4; 21 and 130 take scalar
    loads; 300 loops over 128-wide chunks."""
    big_n = 20000
    qs = _t(RNG.standard_normal((q, d)).astype(np.float32), cuda)
    base_np = RNG.standard_normal((big_n, d)).astype(np.float32)
    mask_np = RNG.random((q, k)) < density
    ids_np = RNG.integers(0, big_n, (q, k)).astype(np.int32)
    ids_np[~mask_np & (RNG.random((q, k)) < 0.5)] = -1
    acc_np = np.where(RNG.random((q, k)) < 0.5, np.inf,
                      RNG.standard_normal((q, k))).astype(np.float32)
    args = [_t(a, cuda) for a in (ids_np, base_np, acc_np, mask_np)]
    got = ops.l2_rerank_masked(qs, *args, metric)
    torch.cuda.synchronize()
    want = ops.l2_rerank_masked_plain(qs, *args, metric)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    keep = ~args[3]
    assert torch.equal(got[keep], args[2][keep])


_RERANK_TRAP_CHILD = """
import sys, torch
from repro_torch.kernels import l2_rerank
q, k, d, n = 4, 64, 128, 1000
ids = torch.randint(0, n, (q, k), dtype=torch.int32, device="cuda")
mask = torch.zeros((q, k), dtype=torch.bool, device="cuda")
mask[1, 5] = True
ids[2, 7] = n + 3                       # out of range, but not asked for
if sys.argv[1] == "masked_bad_id":
    ids[1, 5] = n
l2_rerank.l2_rerank_masked_cuda(
    torch.zeros((q, d), device="cuda"), ids, torch.zeros((n, d), device="cuda"),
    torch.zeros((q, k), device="cuda"), mask)
torch.cuda.synchronize()
print("reranked")
"""


@pytest.mark.parametrize("case", ["unmasked_bad_id", "masked_bad_id"])
def test_l2_rerank_masked_kernel_traps_on_masked_bad_id(cuda, case):
    """An id outside [0, N) that the mask asks for traps; one the mask does
    not ask for is never read.  A trap ends the CUDA context, so the call
    runs in a child process."""
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    r = subprocess.run([sys.executable, "-c", _RERANK_TRAP_CHILD, case],
                       capture_output=True, text=True, env=env, timeout=300)
    ran = r.returncode == 0 and "reranked" in r.stdout
    assert ran == (case == "unmasked_bad_id"), r.stderr[-2000:]


def _merge_inputs(q, l, n):
    """A lane's list: sorted prefix, +inf tail with -1 ids; fresh
    candidates, some +inf (not fresh).  Few distinct keys, -0.0 among them,
    so ties within and across the two parts are common."""
    d = np.sort(_signed(RNG.integers(0, 6, (q, l)).astype(np.float32)), 1)
    tail = np.arange(l)[None, :] >= RNG.integers(1, l + 1, q)[:, None]
    d[tail] = np.inf
    ids = np.where(tail, -1, RNG.integers(0, 10**6, (q, l))).astype(np.int32)
    acc = np.where(RNG.random((q, l)) < 0.3, RNG.random((q, l)),
                   np.inf).astype(np.float32)
    ev = RNG.random((q, l)) < 0.5
    nd = _signed(RNG.integers(0, 6, (q, n)).astype(np.float32))
    stale = RNG.random((q, n)) < 0.3
    nd[stale] = np.inf
    n_ids = np.where(stale, -1, RNG.integers(0, 10**6, (q, n))).astype(
        np.int32)
    return ids, d, acc, ev, n_ids, nd


@pytest.mark.parametrize("q,l,n", [(3, 16, 8), (7, 64, 24), (9, 100, 60),
                                   (256, 128, 64), (256, 128, 256),
                                   (3, 600, 64), (5, 600, 300),
                                   (5, 512, 1000), (256, 512, 64),
                                   (256, 1024, 64)])
def test_bitonic_merge_kernel_exact(cuda, q, l, n):
    """The merge entry against its plain version, all four columns bit for
    bit.  Up to 1024 the warp merges fresh keys into the sorted list;
    (600, 300), (512, 1000) and the masked search's (1024, 64) exceed it and
    take the block path; (512, 64) is the masked search at ~25%."""
    cols = [_t(a, cuda) for a in _merge_inputs(q, l, n)]
    got = ops.bitonic_merge_topl(*cols)
    torch.cuda.synchronize()
    want = ops.bitonic_merge_topl_plain(*cols)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
        if g.is_floating_point():   # -0.0 is copied through, not rebuilt
            assert torch.equal(torch.signbit(g), torch.signbit(w))


_TRAP_CHILD = """
import sys, torch
from repro_torch.kernels import bitonic_topk
q, l, n = 4, 64, 24
d = torch.arange(l, dtype=torch.float32, device="cuda").repeat(q, 1)
if sys.argv[1] == "unsorted":
    d[2, 10], d[2, 11] = 50.0, 3.0
bitonic_topk.bitonic_merge_topl_cuda(
    torch.zeros((q, l), dtype=torch.int32, device="cuda"), d,
    torch.full((q, l), float("inf"), device="cuda"),
    torch.zeros((q, l), dtype=torch.bool, device="cuda"),
    torch.zeros((q, n), dtype=torch.int32, device="cuda"),
    torch.ones((q, n), device="cuda"))
torch.cuda.synchronize()
print("merged")
"""


@pytest.mark.parametrize("case", ["sorted", "unsorted"])
def test_bitonic_merge_kernel_traps_on_unsorted_list(cuda, case):
    """The warp merge sorts only the fresh keys and merges them into the
    list, so it checks that the list is sorted (a warp vote) and traps if
    not.  A trap ends the process's CUDA context: the call runs in a child
    process, once on a sorted list and once on an unsorted one."""
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    r = subprocess.run([sys.executable, "-c", _TRAP_CHILD, case],
                       capture_output=True, text=True, env=env, timeout=300)
    merged = r.returncode == 0 and "merged" in r.stdout
    assert merged == (case == "sorted"), r.stderr[-2000:]


def test_empty_search_result_defaults_to_cuda(cuda):
    from repro_torch.core.search import empty_search_result

    res = empty_search_result(3, 5)
    assert all(t.is_cuda for t in res)
    assert res.ids.shape == (3, 5) and bool((res.ids == -1).all())


def test_kernel_wrappers_count_and_check(cuda):
    from repro_torch.kernels import loader

    loader.reset_launch_counts()
    x = _t(np.ones((4, 8), np.float32), cuda)
    ops.bitonic_sort_pairs(x, _t(np.zeros((4, 8), np.int32), cuda))
    assert loader.LAUNCHES["bitonic_sort_pairs"] == 1
    with pytest.raises(ValueError):                 # not a power of two
        ops.bitonic_sort_pairs(x[:, :6].contiguous(),
                               _t(np.zeros((4, 6), np.int32), cuda))
    with pytest.raises(TypeError):                  # int64 payload
        ops.bitonic_sort_pairs(x, _t(np.zeros((4, 8), np.int64), cuda))
    assert loader.LAUNCHES["bitonic_sort_pairs"] == 1
    cols = [_t(a, cuda) for a in _merge_inputs(4, 8, 8)]
    ops.bitonic_merge_topl(*cols)                   # counts as the sort
    assert loader.LAUNCHES["bitonic_sort_pairs"] == 2


def test_cuda_search_matches_cpu_search(cuda):
    """The whole port on the card (kernels) against the port on the CPU
    (plain versions) over one small built index."""
    from repro_torch.configs.base import (
        DatasetConfig, GraphConfig, PQConfig, ProximaConfig, SearchConfig,
    )
    from repro_torch.core.index import build_index
    from repro_torch.core.search import graph_search, graph_search_stepped

    cfg = ProximaConfig(
        dataset=DatasetConfig(name="sift-like", num_base=1500, num_queries=24,
                              dim=64, num_clusters=12, cluster_std=0.3),
        pq=PQConfig(num_subvectors=32, num_centroids=128, kmeans_iters=8),
        graph=GraphConfig(max_degree=24, build_list_size=48, alpha=1.2),
        search=SearchConfig(k=10, list_size=64, t_init=16, t_step=8,
                            repetition_rate=3, beta=1.06),
        hot_node_fraction=0.0, gap_encode=False,
    )
    idx = build_index(cfg, device="cuda")
    for e in (1, 4):
        scfg = dataclasses.replace(cfg.search, beam_width=e)
        gpu = graph_search(idx.corpus(), idx.dataset.queries, scfg)
        cpu_idx = dataclasses.replace(idx, device="cpu")
        cpu = graph_search(cpu_idx.corpus(), idx.dataset.queries, scfg)
        same = (gpu.ids.cpu() == cpu.ids).all(1).float().mean().item()
        assert same >= 0.95, same
        stepped = graph_search_stepped(idx.corpus(), idx.dataset.queries, scfg)
        assert all(torch.equal(a, b) for a, b in zip(gpu, stepped))


def _small_cuda_index():
    from repro_torch.configs.base import (
        DatasetConfig, GraphConfig, PQConfig, ProximaConfig, SearchConfig,
    )
    from repro_torch.core.index import build_index

    cfg = ProximaConfig(
        dataset=DatasetConfig(name="sift-like", num_base=1500, num_queries=24,
                              dim=64, num_clusters=12, cluster_std=0.3),
        pq=PQConfig(num_subvectors=32, num_centroids=128, kmeans_iters=8),
        graph=GraphConfig(max_degree=24, build_list_size=48, alpha=1.2),
        search=SearchConfig(k=10, list_size=64, t_init=16, t_step=8,
                            repetition_rate=3, beta=1.06),
        hot_node_fraction=0.0, gap_encode=False,
    )
    return build_index(cfg, device="cuda")


_FILTERS = (("category", [0, 1]), ("category", [3]), ("price", range(15)),
            ("price", []))


def test_cuda_filtered_search_matches_cpu_search(cuda):
    """Filtered search through ``Searcher`` on the card (kernels) against
    the CPU port (plain versions) on one small index: the masked (~25%,
    ~12.5%), scan (~1.5%) and empty strategies.  Same bar as the unfiltered
    cross-device test (>= 95% identical rows: the kernels' ADT rounds
    differently from the CPU's expanded form); every id passes."""
    from repro_torch.filter import FilterSpec, random_attributes
    from repro_torch.plan import Searcher, SearchRequest

    idx = _small_cuda_index()
    store = random_attributes(idx.dataset.num_base,
                              {"category": 8, "price": 1000}, seed=5)
    gpu = Searcher.open(idx, attributes=store)
    cpu = Searcher.open(dataclasses.replace(idx, device="cpu"),
                        attributes=store)
    q = idx.dataset.queries
    strategies = []
    for field, values in _FILTERS:
        spec = FilterSpec.isin(field, values)
        a = gpu.search(SearchRequest(queries=q, filter=spec))
        b = cpu.search(SearchRequest(queries=q, filter=spec))
        strategies.append(a.plan.strategy)
        assert (a.ids == b.ids).all(1).mean() >= 0.95
        mask = store.mask(spec)
        assert mask[a.ids[a.ids >= 0]].all()
    assert strategies == ["masked", "masked", "scan", "empty"]


def test_cuda_continuous_engine_equals_batch_engine(cuda):
    """The continuous engine on the card returns, bit for bit, the batch
    engine's ids and distances, unfiltered and filtered requests mixed."""
    from repro_torch.filter import FilterSpec, random_attributes
    from repro_torch.serve import ServingEngine

    idx = _small_cuda_index()
    store = random_attributes(idx.dataset.num_base,
                              {"category": 8, "price": 1000}, seed=5)
    specs = [None] + [FilterSpec.isin(f, v) for f, v in _FILTERS]
    engines = [ServingEngine(idx, batch_size=8, attributes=store,
                             continuous=c, slots=6, flush_us=0.0)
               for c in (True, False)]
    for e in engines:
        for i, v in enumerate(np.tile(idx.dataset.queries, (2, 1))):
            e.submit(v, filter=specs[i % len(specs)])
        e.drain()
    cont, batch = engines
    assert cont.stats["retired"] > 0 and cont.stats["fallback_batches"] > 0
    assert sorted(cont.done) == sorted(batch.done)
    for rid, r in batch.done.items():
        np.testing.assert_array_equal(cont.done[rid].ids, r.ids)
        np.testing.assert_array_equal(cont.done[rid].dists, r.dists)


@pytest.mark.parametrize("q,c,k", [(16, 20, 10), (256, 40, 10), (7, 33, 5),
                                   (5, 100, 10)])
def test_cross_tile_merge_kernel_equals_plain(cuda, q, c, k):
    """The cross-tile merge on the card (one sort-entry launch) equals its
    CPU run (the plain sort) bit for bit, with duplicate ids, -1 ids and
    ties."""
    from repro_torch.kernels import loader
    from repro_torch.shard import cross_tile_merge

    rng = np.random.default_rng(c)
    ids = rng.integers(0, c // 2, (q, c)).astype(np.int32)
    ids[rng.random((q, c)) < 0.2] = -1
    d = rng.integers(0, 6, (q, c)).astype(np.float32)
    loader.reset_launch_counts()
    got = cross_tile_merge(_t(ids, cuda), _t(d, cuda), k)
    torch.cuda.synchronize()
    assert loader.ENTRY_LAUNCHES == {"bitonic_sort_launch": 1}
    want = cross_tile_merge(torch.tensor(ids), torch.tensor(d), k)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def _default_cuda_index():
    """The small index with the paper's defaults: hot nodes 3%, gap on."""
    idx = _small_cuda_index()
    from repro_torch.core.index import build_index

    cfg = dataclasses.replace(idx.config, hot_node_fraction=0.03,
                              gap_encode=True)
    return build_index(cfg, device="cuda", reorder_samples=24,
                       calibrate=True)


def test_cuda_default_index_matches_cpu(cuda):
    """The default index built on the card (the reorder trace and
    calibrate_beta on the kernels): 45 hot nodes, the entry point at 0, gap
    bits that decode to the rows; its search and search_reference on the
    card against the CPU port over the same arrays (>= 95% identical rows,
    as the other cross-device tests)."""
    from repro_torch.core.gap_encoding import gap_decode
    from repro_torch.core.search import graph_search, search_reference
    from repro_torch.kernels import loader

    idx = _default_cuda_index()
    assert idx.hot_count == 45 and idx.graph.entry_point == 0
    assert idx.calibrated_beta > 1.0
    np.testing.assert_array_equal(gap_decode(idx.gap),
                                  np.sort(idx.graph.adjacency, axis=1))
    q = idx.dataset.queries
    gpu = graph_search(idx.corpus(), q, idx.config.search)
    cpu_idx = dataclasses.replace(idx, device="cpu")
    cpu = graph_search(cpu_idx.corpus(), q, idx.config.search)
    assert (gpu.ids.cpu() == cpu.ids).all(1).float().mean().item() >= 0.95
    assert int(gpu.n_hot_hops.sum()) > 0
    gc, cc = idx.corpus(), cpu_idx.corpus()
    same = []
    loader.reset_launch_counts()
    for v in q:
        a = search_reference(idx.graph.adjacency, idx.graph.degrees, gc.codes,
                             gc.base, gc.centroids, 0, v, idx.config.search,
                             hot_count=idx.hot_count)
        b = search_reference(idx.graph.adjacency, idx.graph.degrees, cc.codes,
                             cc.base, cc.centroids, 0, v, idx.config.search,
                             hot_count=idx.hot_count)
        same.append(bool((a[0] == b[0]).all()))
    assert np.mean(same) >= 0.95
    assert loader.LAUNCHES["pq_adt"] == len(q)
    assert loader.LAUNCHES["pq_lookup"] > len(q)
    assert loader.LAUNCHES["l2_rerank"] > len(q)


def test_cuda_tiled_and_segmented_serving_match_cpu(cuda):
    """Tiled serving on the card (per-tile graphs rebuilt on the card,
    cluster policy, full fan-out and routed) and a three-segment build
    (tiled through its segments, flat through the stitched graph): the
    engine's ids equal ``Searcher.search``'s, one cross-tile merge a batch,
    and >= 95% of rows equal the CPU port's over the same tiles."""
    from repro_torch.core.segmented import build_segmented
    from repro_torch.kernels import loader
    from repro_torch.plan import Searcher, SearchRequest
    from repro_torch.serve import ServingEngine
    from repro_torch.shard import TiledCorpus

    idx = _default_cuda_index()
    q = idx.dataset.queries
    seg = build_segmented(idx.config, dataset=dataclasses.replace(
        idx.dataset), segment_size=500, reorder_samples=24, device="cuda")
    targets = [(idx, dict(num_tiles=2, shard_policy="cluster")),
               (idx, dict(num_tiles=2, shard_policy="cluster",
                          probe_tiles=1)),
               (seg, {})]
    for target, kw in targets:
        eng = ServingEngine(target, batch_size=8, **kw)
        loader.reset_launch_counts()
        rids = [eng.submit(v) for v in q]
        eng.drain()
        assert loader.ENTRY_LAUNCHES["bitonic_sort_launch"] \
            == eng.stats["batches"]
        got = np.stack([eng.done[r].ids for r in rids])
        s = Searcher.open(target, **kw)
        np.testing.assert_array_equal(
            s.search(SearchRequest(queries=q)).ids, got)
        cpu = Searcher.open(TiledCorpus(*(t.cpu() for t in s.tiled)),
                            cfg=s.cfg, probe_tiles=s.probe_tiles)
        ids = cpu.search(SearchRequest(queries=q)).ids
        assert (ids == got).all(1).mean() >= 0.95
    flat = seg.to_flat()
    gpu = Searcher.open(flat).search(SearchRequest(queries=q)).ids
    cpu = Searcher.open(dataclasses.replace(flat, device="cpu")).search(
        SearchRequest(queries=q)).ids
    assert (gpu == cpu).all(1).mean() >= 0.95


def test_windowed_knn_prune_equals_whole_lists_on_the_card(cuda, monkeypatch):
    """On the card, the windowed kNN + prune (long build lists: segments and
    tiles) keeps what the prune over the whole sorted lists keeps, on a
    clustered corpus with a 512-long build list: >= 99% of rows identical
    (the two compute pair distances in different products, so a near-tie
    may resolve the other way)."""
    from repro_torch.configs.base import GraphConfig
    from repro_torch.core import graph as graph_mod

    rng = np.random.default_rng(3)
    cents = rng.standard_normal((100, 128))
    base = (cents[rng.integers(0, 100, 6000)]
            + 0.5 * rng.standard_normal((6000, 128))).astype(np.float32)
    cfg = GraphConfig(max_degree=64, build_list_size=512)
    monkeypatch.setattr(graph_mod, "_LONG_LIST", 4096)
    whole = graph_mod.build_knn_prune(base, cfg, "l2", device="cuda")
    monkeypatch.setattr(graph_mod, "_LONG_LIST", 256)
    windowed = graph_mod.build_knn_prune(base, cfg, "l2", device="cuda")
    same = (windowed.adjacency == whole.adjacency).all(1).mean()
    assert same >= 0.99, same
    assert windowed.entry_point == whole.entry_point


def _serve_small(idx, store, obs=None, **kw):
    """Serve the small index's queries twice over, every third request
    filtered (~25%, masked); returns the engine."""
    from repro_torch.filter import FilterSpec
    from repro_torch.serve import ServingEngine

    eng = ServingEngine(idx, batch_size=8, flush_us=0.0, slots=6,
                        attributes=store, obs=obs, **kw)
    spec = FilterSpec.isin("category", [0, 1])
    for i, v in enumerate(np.tile(idx.dataset.queries, (2, 1))):
        eng.submit(v, filter=spec if i % 3 == 0 and "num_tiles" not in kw
                   else None)
    eng.drain()
    return eng


@pytest.mark.parametrize("kw", [dict(), dict(continuous=True),
                                dict(num_tiles=2, shard_policy="cluster")],
                         ids=["batch", "continuous", "tiled"])
def test_cuda_obs_on_leaves_ids_bit_equal(cuda, kw):
    """Observability on (quality at rate 1.0, convergence, NAND billing,
    the kernel hooks) changes no id or distance on the card, bills every
    query and meets no shadow error."""
    from repro_torch.filter import random_attributes
    from repro_torch.obs import NULL_OBS, Observability

    idx = _small_cuda_index()
    store = random_attributes(idx.dataset.num_base,
                              {"category": 8, "price": 1000}, seed=5)
    obs = Observability.on(quality=True, quality_sample_rate=1.0,
                           convergence=True)
    try:
        on = _serve_small(idx, store, obs, **kw)
    finally:
        NULL_OBS.install_kernel_hooks()
    off = _serve_small(idx, store, **kw)
    assert sorted(on.done) == sorted(off.done)
    for rid, r in off.done.items():
        np.testing.assert_array_equal(on.done[rid].ids, r.ids)
        np.testing.assert_array_equal(on.done[rid].dists, r.dists)
    m = obs.metrics
    assert m.counter_total("nand_billed_queries") == len(off.done)
    assert m.counter_total("shadow_errors") == 0
    assert m.counter_total("shadow_samples") == len(off.done)


def test_cuda_kernel_hook_times_every_kernel(cuda):
    """With the hook set, every kernel of the search has in-search
    ``kernel_wall_ms`` samples (CUDA event pairs), and ``kernel_calls``
    and ``kernel_launches`` equal the loader's launch counts over the same
    window."""
    from repro_torch.kernels import loader
    from repro_torch.obs import NULL_OBS, Observability

    idx = _small_cuda_index()
    obs = Observability.on(tracing=False)
    try:
        eng = _serve_small(idx, None, obs, num_tiles=2,
                           shard_policy="cluster")
        m = obs.metrics
        before = {k: m.counter_value("kernel_calls", kernel=k)
                  for k in loader.LAUNCHES}
        launched = {e: m.counter_value("kernel_launches", entry=e)
                    for e in loader.ENTRY_LAUNCHES}
        loader.reset_launch_counts()
        for v in idx.dataset.queries:
            eng.submit(v)
        eng.drain()
        assert not loader.TIMING           # every pair read after the ids
        for k, n in loader.LAUNCHES.items():
            assert n > 0, k
            assert m.counter_value("kernel_calls", kernel=k) - before[k] \
                == n, k
            h = m.histogram("kernel_wall_ms", kernel=k)
            assert h is not None and h.count > 0 and h.vmin > 0, k
        for e, n in loader.ENTRY_LAUNCHES.items():
            assert m.counter_value("kernel_launches", entry=e) \
                - launched.get(e, 0) == n, e
    finally:
        NULL_OBS.install_kernel_hooks()


def test_cuda_kernel_hook_off_creates_no_events(cuda, monkeypatch):
    """With observability off the launch path creates no CUDA event."""
    from repro_torch.kernels import loader
    from repro_torch.obs import NULL_OBS
    from repro_torch.plan import Searcher, SearchRequest

    NULL_OBS.install_kernel_hooks()
    idx = _small_cuda_index()
    s = Searcher.open(idx)
    s.search(SearchRequest(queries=idx.dataset.queries))   # build, warm up
    made = []
    real = torch.cuda.Event

    def event(*a, **kw):
        made.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(torch.cuda, "Event", event)
    loader.reset_launch_counts()
    s.search(SearchRequest(queries=idx.dataset.queries))
    assert min(loader.LAUNCHES.values()) > 0 and not made
    assert loader.TIMING is None
