"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the ``cuda``
fixture decides at run time).  On a machine with a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: ADT and lookup rtol/atol 1e-4 (tests/test_kernels.py), rerank
1e-4/1e-3, the sort exact, ties included.  The search on CUDA is held
against the CPU search of the same index: identical ids on >= 95% of rows,
since the kernels' ADT rounds differently from the CPU's expanded form.
"""
import dataclasses

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
                                        (256, 32, 256, 4)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pq_adt_kernel(cuda, q, m, c, dsub, metric):
    qs = _t(RNG.standard_normal((q, m * dsub)).astype(np.float32), cuda)
    cents = _t(RNG.standard_normal((m, c, dsub)).astype(np.float32), cuda)
    got = ops.pq_adt(qs, cents, metric)
    torch.cuda.synchronize()
    want = ops.pq_adt_plain(qs, cents, metric)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,m,c", [(1, 8, 16), (37, 16, 64), (300, 32, 256),
                                   (5000, 64, 256)])
def test_pq_lookup_kernel(cuda, n, m, c):
    codes = _t(RNG.integers(0, c, (n, m)).astype(np.uint8), cuda)
    adt = _t(RNG.standard_normal((m, c)).astype(np.float32), cuda)
    got = ops.pq_lookup(codes, adt)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ops.pq_lookup_plain(codes, adt),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("q,n,big_n,m,c", [(1, 1, 10, 8, 16),
                                           (24, 96, 1500, 32, 128),
                                           (256, 64, 100000, 32, 256)])
def test_pq_lookup_gather_kernel(cuda, q, n, big_n, m, c):
    ids = _t(RNG.integers(0, big_n, (q, n)).astype(np.int32), cuda)
    codes = _t(RNG.integers(0, c, (big_n, m)).astype(np.uint8), cuda)
    adts = _t(RNG.standard_normal((q, m, c)).astype(np.float32), cuda)
    got = ops.pq_lookup_gather(ids, codes, adts)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, ops.pq_lookup_gather_plain(ids, codes, adts), rtol=1e-4,
        atol=1e-4)


@pytest.mark.parametrize("q,l", [(1, 2), (1, 32), (5, 64), (16, 256),
                                 (256, 256), (3, 4096), (2, 16384)])
def test_bitonic_kernel_exact_with_ties(cuda, q, l):
    # few distinct keys: many ties, plus +inf padding like the merge's
    keys = RNG.integers(0, 8, (q, l)).astype(np.float32)
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
    base = _t(RNG.standard_normal((5000, d)).astype(np.float32), cuda)
    ids = _t(RNG.integers(0, 5000, (q, k)).astype(np.int32), cuda)
    got = ops.l2_rerank_gather(qs, ids, base, metric)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, ops.l2_rerank_gather_plain(qs, ids, base, metric), rtol=1e-4,
        atol=1e-3)


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
