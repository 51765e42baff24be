"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the ``cuda``
fixture decides at run time).  On a machine with a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: ADT and lookup rtol/atol 1e-4 (tests/test_kernels.py; the
lookup's warp sums in a tree, the plain version left to right; the ADT's
kernel fuses multiply and add), rerank 1e-4/1e-3 (a warp's tree sum over D
against torch's order) with the masked entry's pass-through of acc exact,
the sort and the merge exact, with ties, +inf and -0.0/+0.0, the selective
scan within 1e-5 of max |y| and of max |h_last| (its sum over the states
fused into multiply-adds 4 states a lane, then a tree over the lanes;
Mamba-1's decay ``ex2.approx`` of the rate prescaled by log2 e; measured
<= 4.6e-7 from a zero state, <= 7.7e-6 of max |h_last| with a carried
one, where the approximate decays' error compounds), its backward each
gradient within 1e-5 of its own max |g| (the
same, and the sums over lanes, channels and rows in another order;
measured <= 2.2e-6 at full width); the Mamba-2 SSD kernels to the same
bars (products in three TF32 passes, float32 accumulation; measured
~5e-7 of the largest |y|).  The search on CUDA is held
against the CPU search of the same index: identical ids on >= 95% of rows,
since the kernels' ADT rounds differently from the CPU's expanded form.
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import loader, ops

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
                                        (3, 5, 7, 3), (9, 3, 1100, 4),
                                        (256, 32, 256, 8), (256, 32, 256, 16),
                                        (256, 32, 256, 64), (37, 5, 70, 64),
                                        (33, 3, 130, 16), (2, 2, 9, 40),
                                        (3, 1, 64, 100)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pq_adt_kernel(cuda, q, m, c, dsub, metric):
    """dsub=4 takes the 8 queries x (256 / ceil(C/4)) subspaces tile: Q not
    a multiple of 8, M not a multiple of the tile, C not a multiple of 4
    (50, 7) and C > 1024 (threads loop over the centroids) are its ragged
    edges.  Every other dsub takes the wide kernel's 32 x 64 tile, staged 32
    values of dsub at a time: dsub 2 and 3 (scalar staging), 8, 16 and 64
    (the image retriever's (256, 32, 256, 64)), 40 and 100 (a ragged last
    chunk), with Q and C not multiples of the tile."""
    qs = _t(RNG.standard_normal((q, m * dsub)).astype(np.float32), cuda)
    cents = _t(RNG.standard_normal((m, c, dsub)).astype(np.float32), cuda)
    got = ops.pq_adt(qs, cents, metric)
    torch.cuda.synchronize()
    want = ops.pq_adt_plain(qs, cents, metric)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("q,m,c,dsub", [(256, 32, 256, 4), (19, 7, 100, 4),
                                        (256, 32, 256, 64), (5, 3, 50, 16)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pq_adt_kernel_misaligned_codebook(cuda, q, m, c, dsub, metric):
    """A codebook offset by one float from a 16-byte boundary (and queries
    likewise) is staged with scalar loads by the wide kernel, dsub=4
    included."""
    qbuf = _t(RNG.standard_normal(q * m * dsub + 1).astype(np.float32), cuda)
    cbuf = _t(RNG.standard_normal(m * c * dsub + 1).astype(np.float32), cuda)
    qs = qbuf[1:].view(q, m * dsub)
    cents = cbuf[1:].view(m, c, dsub)
    assert cents.data_ptr() % 16 and qs.data_ptr() % 16
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


@pytest.mark.parametrize("q,p,nlist,max_len,m,c", [(5, 3, 6, 300, 16, 64),
                                                  (8, 4, 8, 9000, 32, 256),
                                                  (3, 2, 4, 70, 7, 50),
                                                  (2, 2, 3, 33, 64, 256)])
@pytest.mark.parametrize("shared", [False, True],
                         ids=["adt_per_probe", "adt_per_query"])
def test_pq_lookup_lists_kernel(cuda, q, p, nlist, max_len, m, c, shared):
    """Ragged list lengths (an empty list, a one-row list, a full one) with
    one ADT a probe and one a query: the kernel against its plain version
    (rtol/atol 1e-4) and +inf exactly where the list has ended.  9,000
    rows span three 4,096-row tiles; M = 7 reads code bytes one by one;
    (64, 256) ADTs take 64 KB of shared memory."""
    lengths = RNG.integers(0, max_len + 1, nlist).astype(np.int32)
    lengths[:3] = 0, 1, max_len
    probes = RNG.integers(0, nlist, (q, p)).astype(np.int32)
    probes.flat[:3] = 0, 1, 2
    adts = RNG.random((q if shared else q * p, m, c)).astype(np.float32)
    args = [_t(a, cuda) for a in (
        probes, lengths,
        RNG.integers(0, c, (nlist, max_len, m)).astype(np.uint8), adts)]
    got = ops.pq_lookup_lists(*args)
    torch.cuda.synchronize()
    want = ops.pq_lookup_lists_plain(*args)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    ended = torch.arange(max_len, device=cuda) >= args[1][
        args[0].long()][..., None]
    assert torch.equal(torch.isinf(got), ended)


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
                                   (2, 33, 300), (6, 64, 1024), (5, 64, 2048),
                                   (3, 40, 2049), (2, 70, 4100)])
@pytest.mark.parametrize("density", [0.0, 0.05, 1.0],
                         ids=["none", "sparse", "all"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_l2_rerank_masked_kernel(cuda, q, k, d, density, metric):
    """The masked entry against its plain version: the direct form where
    the mask holds (rtol 1e-4 / atol 1e-3, the warp sums in a tree), acc
    bit for bit elsewhere, -1 padding outside the mask never read, two
    runs bit-equal.  D=128, 96 and 36 hold the query in registers as
    float4; 21 and 130 take scalar loads; D > 128 takes the wide kernel (a
    block a window, 4 elements a thread and 2,048-wide pass): 300, 1,024
    and 2,048 in one pass of float4 loads, 2,049 of scalar ones in two,
    4,100 in three."""
    big_n = 20000 if d <= 300 else 4000
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
    assert torch.equal(got, ops.l2_rerank_masked(qs, *args, metric))


_RERANK_TRAP_CHILD = """
import sys, torch
from repro_torch.kernels import l2_rerank
q, k, n = 4, 64, 1000
d = 2048 if sys.argv[1].endswith("wide") else 128
ids = torch.randint(0, n, (q, k), dtype=torch.int32, device="cuda")
mask = torch.zeros((q, k), dtype=torch.bool, device="cuda")
mask[1, 5] = True
ids[2, 7] = n + 3                       # out of range, but not asked for
if sys.argv[1].startswith("masked_bad_id"):
    ids[1, 5] = n
l2_rerank.l2_rerank_masked_cuda(
    torch.zeros((q, d), device="cuda"), ids, torch.zeros((n, d), device="cuda"),
    torch.zeros((q, k), device="cuda"), mask)
torch.cuda.synchronize()
print("reranked")
"""


@pytest.mark.parametrize("case", ["unmasked_bad_id", "masked_bad_id",
                                  "unmasked_bad_id_wide",
                                  "masked_bad_id_wide"])
def test_l2_rerank_masked_kernel_traps_on_masked_bad_id(cuda, case):
    """An id outside [0, N) that the mask asks for traps; one the mask does
    not ask for is never read (D=128 and the wide kernel's 2,048).  A trap
    ends the CUDA context, so the call runs in a child process."""
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    r = subprocess.run([sys.executable, "-c", _RERANK_TRAP_CHILD, case],
                       capture_output=True, text=True, env=env, timeout=300)
    ran = r.returncode == 0 and "reranked" in r.stdout
    assert ran == case.startswith("unmasked"), r.stderr[-2000:]


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
    bit.  Lists shorter than 256 whose row fits a warp's 1024 elements take
    the warp merge, which merges fresh keys into the sorted list; the
    others (600, 512 and the masked search's 1024; (512, 64) is the masked
    search at ~25%) take the rank merge."""
    cols = [_t(a, cuda) for a in _merge_inputs(q, l, n)]
    got = ops.bitonic_merge_topl(*cols)
    torch.cuda.synchronize()
    want = ops.bitonic_merge_topl_plain(*cols)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
        if g.is_floating_point():   # -0.0 is copied through, not rebuilt
            assert torch.equal(torch.signbit(g), torch.signbit(w))


@pytest.mark.parametrize("q,l,n", [(256, 1024, 64), (256, 1024, 256),
                                   (256, 2048, 64), (256, 961, 64),
                                   (3, 2000, 3000), (4, 16, 2100),
                                   (2, 14000, 2384)])
def test_rank_merge_kernel_exact(cuda, q, l, n):
    """Rows longer than a warp (L + fresh slots > 1024) take the rank
    merge (``merge_kernel`` names it; the profiler sees it): all four
    columns bit for bit against the plain version, at the masked search's
    (1024, 64), beam 4's n = 256, L = 2048, the boundary's (961, 64), and
    fresh words in several runs of 1024 up to L + n = MAX_ROW."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.bitonic_topk import merge_kernel

    assert merge_kernel(l, n) == "rank_merge_kernel"
    cols = [_t(a, cuda) for a in _merge_inputs(q, l, n)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = ops.bitonic_merge_topl(*cols)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("rank_merge_kernel" in x for x in names), names
    want = ops.bitonic_merge_topl_plain(*cols)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
        if g.is_floating_point():
            assert torch.equal(torch.signbit(g), torch.signbit(w))


_TRAP_CHILD = """
import sys, torch
from repro_torch.kernels import bitonic_topk
q, l, n = 4, int(sys.argv[2]), int(sys.argv[3])
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


@pytest.mark.parametrize("l,n", [(64, 24), (1024, 64)],
                         ids=["warp", "rank"])
@pytest.mark.parametrize("case", ["sorted", "unsorted"])
def test_bitonic_merge_kernel_traps_on_unsorted_list(cuda, case, l, n):
    """The warp merge sorts only the fresh keys and merges them into the
    list, and the rank merge ranks each run in the other, so both check
    that the list is sorted (a warp vote; each word against its successor)
    and trap if not.  A trap ends the process's CUDA context: the call runs
    in a child process, once on a sorted list and once on an unsorted
    one."""
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    r = subprocess.run([sys.executable, "-c", _TRAP_CHILD, case, str(l),
                        str(n)],
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


@pytest.mark.parametrize("q,c,k", [(256, 52, 10), (16, 26, 10), (7, 10, 10),
                                   (5, 100, 20), (3, 1, 1)])
def test_merge_order_on_the_sort_entry_equals_plain(cuda, q, c, k):
    """The base/delta merge's sort (``stream.searcher.merge_order``): one
    sort-entry launch on the card, bit-equal to its plain version on the
    CPU, with ties, +inf keys, -0.0 beside +0.0, and widths that are not a
    power of two (one column: padded to the network's least width, 2)."""
    from repro_torch.kernels import loader
    from repro_torch.stream.searcher import merge_order

    rng = np.random.default_rng(c)
    keys = rng.integers(-3, 4, (q, c)).astype(np.float32)
    keys[rng.random((q, c)) < 0.3] = np.inf
    keys[keys == 0] = np.where(rng.random(int((keys == 0).sum())) < 0.5,
                               -0.0, 0.0)
    loader.reset_launch_counts()
    got = merge_order(keys, k, cuda)
    assert loader.ENTRY_LAUNCHES == {"bitonic_sort_launch": 1}
    np.testing.assert_array_equal(got, merge_order(keys, k, "cpu"))


def _stream_pair():
    """The stream tests' 900 x 32 corpus built on the card, a MutableIndex
    over it and one over the same arrays on the CPU, after the same
    inserts (two exact copies of base vectors among them) and deletes."""
    from repro_torch.configs.base import (
        DatasetConfig, GraphConfig, PQConfig, ProximaConfig, SearchConfig,
        StreamConfig,
    )
    from repro_torch.core.index import build_index
    from repro_torch.stream import MutableIndex

    cfg = ProximaConfig(
        dataset=DatasetConfig(name="sift-like", num_base=900, num_queries=24,
                              dim=32, num_clusters=10, cluster_std=0.25,
                              seed=3),
        pq=PQConfig(num_subvectors=8, num_centroids=64, kmeans_iters=6),
        graph=GraphConfig(max_degree=16, build_list_size=32, alpha=1.2),
        search=SearchConfig(k=10, list_size=64, t_init=16, t_step=8,
                            repetition_rate=3, beta=1.06),
        stream=StreamConfig(delta_capacity=512, consolidate_fraction=0.6,
                            delta_list_size=32, brute_force_below=32,
                            base_overfetch=16),
        hot_node_fraction=0.03,
    )
    idx = build_index(cfg, device="cuda", reorder_samples=16)
    gpu = MutableIndex(idx)
    cpu = MutableIndex(dataclasses.replace(idx, device="cpu"))
    rng = np.random.default_rng(7)
    base = idx.dataset.base
    picks = base[rng.choice(900, 60)]
    vecs = (picks + 0.1 * rng.standard_normal(picks.shape)).astype(np.float32)
    vecs[:2] = base[:2]
    for m in (gpu, cpu):
        for v in vecs:
            m.insert(v)
        for e in np.random.default_rng(8).choice(960, 45, replace=False):
            m.delete(int(e))
    return idx, gpu, cpu


def test_cuda_merged_search_matches_cpu(cuda):
    """``merged_search_kernel`` on the card: one sort-entry launch a call;
    fused from the same base result, the card's merge equals the CPU's bit
    for bit (-1 ids where tombstones were, ties); end to end its ids equal
    the CPU port's on >= 95% of rows (the cross-device bar above) and its
    delta candidates exactly."""
    from repro_torch.core.search import graph_search
    from repro_torch.kernels import loader
    from repro_torch.stream import merged_search_kernel
    from repro_torch.stream.searcher import _merge_base_delta

    idx, gpu, cpu = _stream_pair()
    q = idx.dataset.queries
    cfg = dataclasses.replace(idx.config.search, k=26)
    base = graph_search(gpu.corpus(), q, cfg)
    loader.reset_launch_counts()
    got = _merge_base_delta(gpu, q, base.ids, base.dists, None, 10)
    assert loader.ENTRY_LAUNCHES == {"bitonic_sort_launch": 1}
    want = _merge_base_delta(cpu, q, base.ids.cpu(), base.dists.cpu(), None,
                             10)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    loader.reset_launch_counts()
    g = merged_search_kernel(gpu, q)
    assert loader.ENTRY_LAUNCHES["bitonic_sort_launch"] == 1
    c = merged_search_kernel(cpu, q)
    assert (g.ids == c.ids).all(1).mean() >= 0.95
    np.testing.assert_array_equal(g.delta_candidates, c.delta_candidates)
    assert not np.isin(g.ids, list(gpu.tombstones)).any()


def _tensors(res):
    return [res.ids, res.dists, res.probed, *res.per_tile]


def test_cuda_batched_fan_out_equals_unrolled(cuda):
    """The batched tile fan-out (one traversal of P x Q lanes over the
    stacked tiles) against the unrolled one on the card, full and routed:
    ids, distances, ``probed`` and every per-tile counter bit for bit, one
    ``pq_adt`` launch instead of P and fewer launches of the round's
    kernels."""
    from repro_torch.shard import partition_index
    from repro_torch.shard.search import sharded_search_kernel

    idx = _small_cuda_index()
    tiled, _ = partition_index(idx, 3, "cluster")
    q = idx.dataset.queries
    for probe in (None, 2):
        loader.reset_launch_counts()
        batched = sharded_search_kernel(tiled, q, idx.config.search,
                                        use_vmap=True, probe_tiles=probe)
        b_launches = dict(loader.LAUNCHES)
        loader.reset_launch_counts()
        unrolled = sharded_search_kernel(tiled, q, idx.config.search,
                                         use_vmap=False, probe_tiles=probe)
        u_launches = dict(loader.LAUNCHES)
        for x, y in zip(_tensors(batched), _tensors(unrolled)):
            assert torch.equal(x, y)
        assert (b_launches["pq_adt"], u_launches["pq_adt"]) == (1, 3)
        for kernel in ("pq_lookup", "l2_rerank"):
            assert b_launches[kernel] < u_launches[kernel], kernel


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "raw"])
def test_ivf_lookup_kernel_ragged(cuda, monkeypatch, residual):
    """``search_ivf``'s one lookup launch, over a (Q, nprobe) chunk of
    probed lists of ragged lengths, one empty, -1 padded, with one ADT a
    probe (raw: one a query): the kernel against its plain version on the
    same inputs (rtol/atol 1e-4, +inf exactly past each list's length), the
    scanned counts exact and the ids of the search equal to the CPU's on
    >= 95% of rows."""
    from repro_torch.core.ivf import ivf_from_arrays, search_ivf

    rng = np.random.default_rng(3)
    nlist, max_len, m, c, d, q, nprobe = 8, 300, 16, 64, 64, 37, 3
    lengths = rng.integers(1, max_len + 1, nlist)
    lengths[2], lengths[5] = 0, max_len
    lists = np.full((nlist, max_len), -1, np.int32)
    lists[np.arange(max_len) < lengths[:, None]] = rng.permutation(
        int(lengths.sum())).astype(np.int32)
    arrays = dict(
        coarse_centroids=rng.standard_normal((nlist, d)).astype(np.float32),
        lists=lists, list_codes=rng.integers(0, c, (nlist, max_len, m),
                                             dtype=np.uint8),
        centroids=rng.standard_normal((m, c, d // m)).astype(np.float32),
        residual=residual, metric="l2")
    queries = rng.standard_normal((q, d)).astype(np.float32)
    calls = []
    real = ops.pq_lookup_lists

    def spy(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(ops, "pq_lookup_lists", spy)
    loader.reset_launch_counts()
    ids, _, scanned = search_ivf(ivf_from_arrays(**arrays, device="cuda"),
                                 queries, 10, nprobe)
    assert loader.LAUNCHES["pq_adt"] == loader.LAUNCHES["pq_lookup"] == 1
    (probes, lens, list_codes, adts), out = calls[0]
    assert probes.shape == (q, nprobe) and out.shape == (q, nprobe, max_len)
    assert adts.shape[0] == (q * nprobe if residual else q)
    want = ops.pq_lookup_lists_plain(probes, lens, list_codes, adts)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    ended = torch.arange(max_len, device=cuda) >= lens[probes.long()][
        ..., None]
    assert torch.equal(torch.isinf(out), ended) and ended.any()
    cpu_ids, _, cpu_scanned = search_ivf(
        ivf_from_arrays(**arrays, device="cpu"), queries, 10, nprobe)
    np.testing.assert_array_equal(scanned, cpu_scanned)
    assert (ids == cpu_ids).all(1).mean() >= 0.95


@functools.lru_cache(maxsize=1)
def _hot_cuda_index():
    """A small index with the paper's 3% hot nodes, built on the card."""
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
        hot_node_fraction=0.03,
    )
    return build_index(cfg, device="cuda", reorder_samples=24)


def _shard_args(idx):
    return (idx.graph.adjacency, idx.codes, idx._search_base(),
            idx.codebook.centroids, int(idx.graph.entry_point),
            idx.hot_count)


def _nccl_world_of_one(directory):
    import datetime

    import torch.distributed as dist

    directory.mkdir(parents=True, exist_ok=True)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(directory / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))


def test_cuda_distributed_world_one_equals_flat(cuda, tmp_path):
    """World size 1 over NCCL on a 1x1 mesh: in both modes at E = 1 and 4
    the card's ids and distances equal the card's flat ``graph_search``
    bit for bit (the same kernels on the same rows; a value plus zeros is
    exact), every round launches the lookup, the merge and the masked
    rerank, each batch ``pq_adt`` once; against the CPU's distributed run
    (gloo, plain versions) identical ids on >= 95% of rows."""
    import torch.distributed as dist

    from _torch_port import gloo_world_of_one
    from repro_torch.core.distributed import (
        TRAFFIC, distributed_search_kernel, shard_corpus,
    )
    from repro_torch.core.search import graph_search
    from repro_torch.launch.mesh import make_mesh

    idx = _hot_cuda_index()
    q = idx.dataset.queries
    runs = [(mode, beam) for mode in ("nsp", "fetch") for beam in (1, 4)]
    cpu = {}
    (tmp_path / "gloo").mkdir()
    with gloo_world_of_one(tmp_path / "gloo") as mesh:
        sc = shard_corpus(*_shard_args(idx), 1, device="cpu")
        for mode, beam in runs:
            c = dataclasses.replace(idx.config.search, beam_width=beam)
            cpu[mode, beam] = distributed_search_kernel(
                sc, q, c, mode=mode, mesh=mesh)[0]
    _nccl_world_of_one(tmp_path / "nccl")
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        sc = shard_corpus(*_shard_args(idx), 1, shard=0, device="cuda")
        for mode, beam in runs:
            c = dataclasses.replace(idx.config.search, beam_width=beam)
            flat = graph_search(idx.corpus(), q, c)
            loader.reset_launch_counts()
            TRAFFIC.clear()
            ids, d = distributed_search_kernel(sc, q, c, mode=mode,
                                               mesh=mesh)
            assert torch.equal(ids, flat.ids) and torch.equal(d, flat.dists)
            rounds, n = TRAFFIC["rounds"], loader.LAUNCHES
            lookups = 2 if mode == "nsp" else 1
            assert n["pq_adt"] == 1
            assert n["pq_lookup"] == lookups * (rounds + 1), (mode, n)
            assert n["bitonic_sort_pairs"] == rounds
            assert n["l2_rerank"] == 2 * (rounds + 1)
            same = (ids.cpu() == cpu[mode, beam]).all(1).float().mean()
            assert same >= 0.95, (mode, beam, same)
    finally:
        dist.destroy_process_group()


_CARD_RANK = r"""
import datetime, json, sys
import numpy as np
import torch, torch.distributed as dist
from repro_torch.configs.base import SearchConfig
from repro_torch.core.distributed import (
    ShardedCorpus, distributed_search_kernel)
from repro_torch.launch.mesh import make_mesh

rank, where = int(sys.argv[1]), sys.argv[2]
dist.init_process_group(
    "gloo", store=dist.FileStore(where + "/store", 4), rank=rank,
    world_size=4, timeout=datetime.timedelta(seconds=120))
mesh = make_mesh((2, 2), ("data", "model"))
s = mesh.get_local_rank("data")
a = {k: torch.from_numpy(v).cuda()
     for k, v in np.load(where + "/rep.npz").items()}
sc = ShardedCorpus(
    *(torch.from_numpy(np.load(f"{where}/{f}{s}.npy")).cuda()
      for f in ("adjacency", "codes", "base")),
    a["centroids"], a["hot_adjacency"], a["hot_codes"], a["hot_base"],
    int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]), 2, s)
q = np.load(where + "/queries.npy")
cfg = SearchConfig(**json.loads(sys.argv[6]))
out = {m: distributed_search_kernel(sc, q, cfg, mode=m,
                                    mesh=mesh)[0].cpu().numpy()
       for m in ("nsp", "fetch")}
np.savez(where + f"/out{rank}.npz", **out)
dist.destroy_process_group()
"""


def test_cuda_distributed_gloo_ranks_on_one_card(cuda, tmp_path):
    """A (2, 2) mesh of 4 gloo processes on the one card (collectives
    staged through host memory), each rank holding only its own data shard
    from ``.npy``: in both modes every rank's ids equal the card's flat
    ``graph_search`` ids."""
    from repro_torch.core.distributed import shard_corpus
    from repro_torch.core.search import graph_search

    idx = _hot_cuda_index()
    loader.build_all()
    args = _shard_args(idx)
    for s in (0, 1):
        sc = shard_corpus(*args, 2, shard=s, device="cpu")
        for f in ("adjacency", "codes", "base"):
            np.save(tmp_path / f"{f}{s}.npy", getattr(sc, f).numpy())
    np.savez(tmp_path / "rep.npz", **{f: getattr(sc, f).numpy() for f in (
        "centroids", "hot_adjacency", "hot_codes", "hot_base")})
    np.save(tmp_path / "queries.npy", idx.dataset.queries)
    want = graph_search(idx.corpus(), idx.dataset.queries,
                        idx.config.search).ids.cpu().numpy()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(
        pathlib.Path(__file__).resolve().parent.parent / "src"))
    cfg = json.dumps(dataclasses.asdict(idx.config.search))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CARD_RANK, str(r), str(tmp_path),
         str(sc.entry_point), str(sc.hot_count), str(sc.num_vertices), cfg],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    for r in range(4):
        out = np.load(tmp_path / f"out{r}.npz")
        for mode in ("nsp", "fetch"):
            np.testing.assert_array_equal(out[mode], want,
                                          err_msg=f"rank {r} {mode}")


# ---- the training half ------------------------------------------------------

def _train_step_grads(model, batch):
    """(loss, the gradients the optimizer is handed) of one
    ``make_train_step`` step with 2 microbatches."""
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamW

    seen = {}

    class Spy(AdamW):
        def apply(self, grads, state, params):
            seen.update(grads)
            return super().apply(grads, state, params)

    opt = Spy(lr=1e-3, warmup_steps=5, total_steps=20)
    state, _ = init_train_state(model, opt)
    _, m = make_train_step(model, opt, microbatches=2)[0](state, batch)
    return float(m["loss"]), seen


def test_cuda_train_step_matches_cpu(cuda):
    """stablelm-1.6b's smoke config in f32 (TF32 off): the card's step
    against the CPU's on the same weights and batch, the loss within 1e-5
    relative and each gradient within 1e-4 of its leaf's largest |g|."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.train.data import DataConfig, batch_for_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"),
                              dtype="float32")
    cpu = build_model(cfg, device="cpu", q_chunk=64)
    card = build_model(cfg, device=cuda, q_chunk=64)
    card.load_state_dict(cpu.state_dict())
    batch = batch_for_step(DataConfig(vocab_size=cfg.vocab_size, seq_len=33,
                                      global_batch=4, copy_period=8), 0)
    l_card, g_card = _train_step_grads(card, batch)
    l_cpu, g_cpu = _train_step_grads(cpu, batch)
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for k, g in g_cpu.items():
        assert g_card[k].is_cuda
        torch.testing.assert_close(g_card[k].cpu(), g, rtol=1e-4,
                                   atol=1e-4 * float(g.abs().max()))


def test_cuda_checkpoint_roundtrip(cuda, tmp_path):
    """A train state on the card saved asynchronously (host copies made
    before the next step writes the parameters in place) and restored onto
    the card bit for bit."""
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.train.data import DataConfig, batch_for_step
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamW

    cfg = get_smoke_config("stablelm-1.6b")
    model = build_model(cfg, device=cuda, q_chunk=64)
    opt = AdamW(lr=1e-3, warmup_steps=5, total_steps=20)
    state, _ = init_train_state(model, opt)
    ts, _ = make_train_step(model, opt)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=33, global_batch=4,
                      copy_period=8)
    state, _ = ts(state, batch_for_step(dcfg, 0))
    want = {k: v.detach().clone() for k, v in state.params.items()}
    t = ck.save_checkpoint(str(tmp_path), 1, state, async_mode=True)
    state, _ = ts(state, batch_for_step(dcfg, 1))     # writes in place
    t.join(timeout=120)
    assert not t.is_alive()
    back, step, _ = ck.restore_checkpoint(str(tmp_path), state,
                                          validate_digests=True)
    assert step == 1 and int(back.opt.step) == 1
    for k, v in want.items():
        assert back.params[k].is_cuda and torch.equal(back.params[k], v), k


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-34b",
                                  "granite-moe-3b-a800m", "paligemma-3b",
                                  "zamba2-1.2b", "seamless-m4t-medium",
                                  "falcon-mamba-7b"])
def test_cuda_sharded_step_on_one_rank_mesh(cuda, tmp_path, arch):
    """The sharded step (``shard_state``, ``param_shardings``) on a (1, 1)
    NCCL mesh against the unsharded step on the card: two steps of the
    smoke config (bf16, 2 microbatches), the same losses and parameters
    bit for bit (every collective is over an axis of size 1)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.train.data import DataConfig, batch_for_step
    from repro_torch.train.loop import (
        init_train_state, local_shards, make_train_step, shard_state,
        state_shardings)
    from repro_torch.train.optimizer import AdamW

    cfg = get_smoke_config(arch)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=33, global_batch=4,
                      copy_period=8, family=cfg.family,
                      frontend_tokens=cfg.frontend_tokens,
                      frontend_dim=cfg.frontend_dim)
    out = []
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        for sharded in (False, True):
            model = build_model(cfg, device=cuda, q_chunk=64, ssm_chunk=8)
            opt = AdamW(lr=1e-3, warmup_steps=5, total_steps=20)
            state, specs = init_train_state(model, opt)
            if sharded:
                sh = state_shardings(specs, state, mesh)
                state = shard_state(state, specs, mesh)
                ts, _ = make_train_step(model, opt, mesh, 2,
                                        param_shardings=sh.params)
            else:
                ts, _ = make_train_step(model, opt, microbatches=2)
            losses = []
            for step in range(2):
                state, m = ts(state, batch_for_step(dcfg, step))
                losses.append(float(m["loss"]))
            out.append((losses, {k: t.detach().clone() for k, t in
                                 local_shards(state.params).items()}))
    finally:
        dist.destroy_process_group()
    (l0, p0), (l1, p1) = out
    assert l0 == l1
    for k, v in p0.items():
        assert torch.equal(p1[k], v), k


SCAN_TOL = 1e-5     # of max |y| (max |h_last|): the sum over ds reordered
                    # into fused multiply-adds, expf within ulps of torch's


def _scan_inputs(dev, bsz, s, di, ds, nh=None, carried=True, seed=0):
    """(dt, a, x, b, c, h0) on ``dev``: Mamba-1's (B, S, di) dt and (di,
    ds) decay, or with ``nh`` Mamba-2's (B, S, nh) dt and (nh,) decay."""
    rng = np.random.default_rng(seed)
    width = di if nh is None else nh
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, width)) - 1.0))
    a = -np.exp(rng.standard_normal((di, ds) if nh is None else (nh,)))
    x, b, c = (rng.standard_normal(sh) for sh in ((bsz, s, di), (bsz, s, ds),
                                                 (bsz, s, ds)))
    h0 = (rng.standard_normal((bsz, di, ds)) if carried
          else np.zeros((bsz, di, ds)))
    return [_t(np.asarray(t, np.float32), dev)
            for t in (dt, a, x, b, c, h0)]


def _scan_close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        err = float((g - w).abs().max())
        assert err <= SCAN_TOL * float(w.abs().max()), err


def _scan_route(heads, s, di, ds, nh, bwd=False):
    """(counter, C entry) of the kernel a call of these shapes launches: the
    SSD kernels for the Mamba-2 shapes ``ssd_route`` takes, else the step
    kernels."""
    from repro_torch.kernels.selective_scan import ssd_route

    if heads and ssd_route(s, di // nh, ds, bwd=bwd):
        return (("selective_scan_ssd_bwd", "selective_scan_ssd_bwd_launch")
                if bwd else ("selective_scan_ssd", "selective_scan_ssd_launch"))
    if bwd:
        return "selective_scan_bwd", "selective_scan_bwd_launch"
    return ("selective_scan", "selective_scan_heads_launch" if heads
            else "selective_scan_launch")


def _scan_launches() -> dict:
    """The scan kernels' nonzero launch counts."""
    return {k: v for k, v in loader.MODEL_LAUNCHES.items() if v}


@pytest.mark.parametrize("bsz,s,di,ds,nh", [
    (2, 1, 64, 16, None), (2, 37, 130, 16, None), (3, 300, 256, 8, None),
    (1, 513, 64, 64, None), (2, 40, 96, 12, None), (1, 17, 32, 3, None),
    (1, 9, 40, 128, None),
    (2, 1, 256, 64, 4), (2, 300, 512, 64, 8), (1, 37, 192, 16, 3),
    (2, 33, 128, 64, 4), (1, 20, 96, 5, 32)])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_selective_scan_kernel(cuda, bsz, s, di, ds, nh, carried):
    """Both entries against their plain versions: S = 1 (decode), S not a
    multiple of the 16-step tile or of 256, di not a multiple of the
    128-channel block (and Mamba-2 heads split across blocks: di 192 of
    head width 64; head width 32 and 3), ds padded (3, 5, 12) and at the
    kernel's 128; one launch a call, of the kernel the shapes pick (the
    Mamba-2 calls with widths multiples of 8 and S > 1: the SSD kernel)."""
    from repro_torch.kernels.selective_scan import (
        selective_scan_heads_plain, selective_scan_plain)

    args = _scan_inputs(cuda, bsz, s, di, ds, nh, carried)
    heads = nh is not None
    loader.reset_launch_counts()
    got = (ops.selective_scan_heads if heads else ops.selective_scan)(
        *args, 256)
    torch.cuda.synchronize()
    counter, entry = _scan_route(heads, s, di, ds, nh)
    assert _scan_launches() == {counter: 1}
    assert loader.ENTRY_LAUNCHES == {entry: 1}
    want = (selective_scan_heads_plain if heads else selective_scan_plain)(
        *args, 256)
    _scan_close(got, want)


@pytest.mark.parametrize("bsz,s,di,ds,nh", [
    (8, 1, 4096, 64, 64), (2, 1, 8192, 16, None), (2, 2048, 8192, 16, None),
    (8, 300, 8192, 16, None), (3, 70, 256, 128, None), (2, 40, 512, 128, 4),
    (2, 1, 96, 128, None)],
    ids=["zamba2_decode", "falcon_decode", "falcon_prefill", "falcon_8x300",
         "mamba1_ds128", "mamba2_ds128", "decode_ds128"])
def test_selective_scan_step_route_at_model_shapes(cuda, bsz, s, di, ds, nh):
    """The step forward at the shapes its route serves: zamba2-1.2B's and
    falcon-mamba-7b's decode steps, falcon-mamba's prefill (2, 2,048) and
    (8, 300), and the widest state (128, both entries): within the bar of
    the plain version, carried state, and two runs bit-equal."""
    from repro_torch.kernels.selective_scan import (
        selective_scan_heads_plain, selective_scan_plain)

    args = _scan_inputs(cuda, bsz, s, di, ds, nh, carried=True)
    heads = nh is not None
    op = ops.selective_scan_heads if heads else ops.selective_scan
    loader.reset_launch_counts()
    got = op(*args, 256)
    again = op(*args, 256)
    torch.cuda.synchronize()
    assert _scan_launches() == {"selective_scan": 2}
    for g, h in zip(got, again):
        assert torch.equal(g, h)
    want = (selective_scan_heads_plain if heads else selective_scan_plain)(
        *args, 256)
    _scan_close(got, want)


def test_selective_scan_kernel_takes_strided_inputs(cuda):
    """Slices of a wider projection (an f32 model's b and c) are copied to
    contiguous before the launch, with the same result."""
    dt, a, x, b, c, h0 = _scan_inputs(cuda, 2, 50, 128, 16)
    proj = torch.cat([b, c], -1)
    got = ops.selective_scan(dt, a, x, proj[..., :16], proj[..., 16:], h0)
    _scan_close(got, ops.selective_scan(dt, a, x, b, c, h0))


def test_selective_scan_kernel_raises_on_bad_inputs(cuda):
    from repro_torch.kernels.selective_scan import (
        selective_scan_cuda, selective_scan_heads_cuda)

    dt, a, x, b, c, h0 = _scan_inputs(cuda, 2, 8, 64, 16)
    with pytest.raises(ValueError):                  # a's (di, ds) wrong
        selective_scan_cuda(dt, a[:, :8], x, b, c, h0)
    with pytest.raises(ValueError):                  # h0's batch wrong
        selective_scan_cuda(dt, a, x, b, c, h0[:1])
    with pytest.raises(TypeError):
        selective_scan_cuda(dt.bfloat16(), a, x, b, c, h0)
    with pytest.raises(ValueError):                  # a CPU tensor
        selective_scan_cuda(dt, a.cpu(), x, b, c, h0)
    with pytest.raises(ValueError):                  # nh does not divide di
        selective_scan_heads_cuda(dt[..., :3], a[:3, 0].contiguous(), x, b,
                                  c, h0)
    wide = _scan_inputs(cuda, 1, 4, 32, 129)
    with pytest.raises(ValueError):                  # past the register state
        selective_scan_cuda(*wide)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_ssm_models_launch_the_scan_on_the_card(cuda, arch):
    """The smoke config in f32 (TF32 off) on the card against the CPU
    (plain scan): a prefill and a decode step, each launching a kernel once
    a mamba layer (zamba2's prefill the SSD kernel), logits within 1e-3."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    cpu = build_model(cfg, device="cpu", ssm_chunk=8)
    card = build_model(cfg, device=cuda, ssm_chunk=8)
    card.load_state_dict(cpu.state_dict())
    n_ssm = sum(k in ("mamba1", "mamba2") for k in cfg.block_pattern())
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 21))
    # zamba2's prefill (head width 64, ds 16) runs the SSD kernel, its
    # decode step and falcon-mamba's calls the step kernel
    prefill_kernel = ("selective_scan_ssd" if arch == "zamba2-1.2b"
                      else "selective_scan")
    out = []
    for model in (card, cpu):
        loader.reset_launch_counts()
        lg, cache = model.prefill({"tokens": _t(tokens, model.device)},
                                  max_len=24)
        launched = [_scan_launches()]
        lg2, _ = model.decode_step(cache, lg.argmax(-1))
        launched.append(_scan_launches())
        out.append((lg.cpu(), lg2.cpu(), launched))
    after_decode = {prefill_kernel: n_ssm}
    after_decode["selective_scan"] = after_decode.get("selective_scan",
                                                      0) + n_ssm
    assert out[0][2] == [{prefill_kernel: n_ssm}, after_decode]
    assert out[1][2] == [{}, {}]
    for got, want in zip(out[0][:2], out[1][:2]):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


# ---- the selective scan's backward -----------------------------------------

def _scan_bwd(heads):
    from repro_torch.kernels import selective_scan as ss

    return ((ss.scan_heads_bwd_op, ss.selective_scan_heads_bwd_plain)
            if heads else (ss.scan_bwd_op, ss.selective_scan_bwd_plain))


def _cotangents(dev, bsz, s, di, ds, seed=1):
    rng = np.random.default_rng(seed)
    return [_t(rng.standard_normal(sh).astype(np.float32), dev)
            for sh in ((bsz, s, di), (bsz, di, ds))]


@pytest.mark.parametrize("s", [1, 7, 15, 16, 17, 33, 128, 3 * 128 + 5])
@pytest.mark.parametrize("ds", [4, 16, 48, 64, 128])
@pytest.mark.parametrize("heads", [False, True], ids=["mamba1", "mamba2"])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_selective_scan_bwd_kernel(cuda, heads, ds, s, carried):
    """Both entries' backward kernel against the plain backward: S = 1, 7;
    15, 16, 17 and 33 at the edges of Mamba-1's 8-step register tile and
    its chunk of 8 (ds 4), 16 (ds 8) or 32 steps; Mamba-2's 128-step chunk
    and three chunks and a ragged tile; ds padded (48) and at the kernels'
    128; di 80 (Mamba-1, no multiple of a block's channels) and 4 heads of
    48 (Mamba-2, heads split across blocks); each gradient within SCAN_TOL
    of its largest magnitude; one launch a call, of the kernel the shapes
    pick (Mamba-2 at ds 16, 48 and 64 and S >= SSD_BWD_MIN_STEPS: the SSD
    kernels; Mamba-1: the tiled kernel)."""
    di, nh = (192, 4) if heads else (80, None)
    args = _scan_inputs(cuda, 2, s, di, ds, nh, carried)
    gy, gh = _cotangents(cuda, 2, s, di, ds)
    op, plain = _scan_bwd(heads)
    loader.reset_launch_counts()
    got = op(*args, gy, gh, 256)
    torch.cuda.synchronize()
    counter, entry = _scan_route(heads, s, di, ds, nh, bwd=True)
    assert _scan_launches() == {counter: 1}
    assert loader.ENTRY_LAUNCHES == {entry: 1}
    _scan_close(got, plain(*args, gy, gh, 256))


def test_selective_scan_bwd_kernel_bit_equal_runs_and_strides(cuda):
    """Two runs give the same bits (ordered sums, no atomics); slices of a
    wider projection and a transposed cotangent are copied to contiguous,
    with the same result."""
    for heads, di, nh in ((False, 130, None), (True, 256, 4)):
        op, _ = _scan_bwd(heads)
        args = _scan_inputs(cuda, 3, 300, di, 64, nh)
        gy, gh = _cotangents(cuda, 3, 300, di, 64)
        first, second = op(*args, gy, gh, 256), op(*args, gy, gh, 256)
        assert all(torch.equal(p, q) for p, q in zip(first, second))
        dt, a, x, b, c, h0 = args
        proj = torch.cat([b, c], -1)
        gh_t = gh.transpose(1, 2).contiguous().transpose(1, 2)
        got = op(dt, a, x, proj[..., :64], proj[..., 64:], h0, gy, gh_t, 256)
        assert all(torch.equal(p, q) for p, q in zip(got, first))


def test_selective_scan_bwd_kernel_raises_on_bad_inputs(cuda):
    from repro_torch.kernels.selective_scan import (
        selective_scan_bwd_cuda, selective_scan_heads_bwd_cuda)

    dt, a, x, b, c, h0 = _scan_inputs(cuda, 2, 8, 64, 16)
    gy, gh = _cotangents(cuda, 2, 8, 64, 16)
    with pytest.raises(ValueError):                  # gy's shape wrong
        selective_scan_bwd_cuda(dt, a, x, b, c, h0, gy[:, :4], gh)
    with pytest.raises(ValueError):                  # gh's shape wrong
        selective_scan_bwd_cuda(dt, a, x, b, c, h0, gy, gh[:1])
    with pytest.raises(TypeError):
        selective_scan_bwd_cuda(dt, a, x, b, c, h0, gy.double(), gh)
    with pytest.raises(TypeError):
        selective_scan_bwd_cuda(dt, a.bfloat16(), x, b, c, h0, gy, gh)
    with pytest.raises(ValueError):                  # a CPU tensor
        selective_scan_bwd_cuda(dt, a, x, b, c, h0, gy, gh.cpu())
    with pytest.raises(ValueError):                  # nh does not divide di
        selective_scan_heads_bwd_cuda(dt[..., :3], a[:3, 0].contiguous(), x,
                                      b, c, h0, gy, gh)
    wide = _scan_inputs(cuda, 1, 4, 32, 129)
    with pytest.raises(ValueError):                  # past the kernel's 128
        selective_scan_bwd_cuda(*wide, *_cotangents(cuda, 1, 4, 32, 129))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_ssm_train_step_launches_the_backward_on_the_card(cuda, arch):
    """The smoke config in f32 (TF32 off): one ``make_train_step`` step of
    2 microbatches on the card against the CPU's (plain backward): the
    backward kernel launched once a mamba layer a microbatch (zamba2's the
    SSD kernels, falcon-mamba's the step kernel), the loss
    within 1e-5 relative and each gradient within 1e-3 of its leaf's
    largest |g| (the train phase's SSM bar)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.train.data import DataConfig, batch_for_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    cpu = build_model(cfg, device="cpu", ssm_chunk=8)
    card = build_model(cfg, device=cuda, ssm_chunk=8)
    card.load_state_dict(cpu.state_dict())
    n_ssm = sum(k in ("mamba1", "mamba2") for k in cfg.block_pattern())
    batch = batch_for_step(DataConfig(vocab_size=cfg.vocab_size, seq_len=33,
                                      global_batch=4, copy_period=8,
                                      family=cfg.family), 0)
    loader.reset_launch_counts()
    l_card, g_card = _train_step_grads(card, batch)
    bwd = ("selective_scan_ssd_bwd" if arch == "zamba2-1.2b"
           else "selective_scan_bwd")
    assert {k: v for k, v in _scan_launches().items()
            if k.endswith("_bwd")} == {bwd: 2 * n_ssm}
    l_cpu, g_cpu = _train_step_grads(cpu, batch)
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for k, g in g_cpu.items():
        torch.testing.assert_close(g_card[k].cpu(), g, rtol=1e-3,
                                   atol=1e-3 * float(g.abs().max()))


# ---- the Mamba-2 scan's SSD kernels ----------------------------------------

@pytest.mark.parametrize("bsz,s,nh,hd,ds", [
    (2, 300, 8, 64, 64), (1, 37, 3, 64, 16), (2, 128, 10, 32, 64),
    (1, 2, 2, 8, 8), (3, 200, 4, 64, 32), (1, 1024, 64, 64, 64)],
    ids=["ragged", "S<Q", "10-heads", "smallest", "ds32", "zamba2-width"])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_selective_scan_ssd_kernels(cuda, bsz, s, nh, hd, ds, carried):
    """The SSD forward and backward against the plain loop (the op's CPU
    version) and their own blueprint (``selective_scan_ssd_plain`` in three
    TF32 passes): a ragged last chunk (300 = 4 x 64 + 44), S below the
    64-step chunk, two whole chunks with 10 heads (the backward's blocks of
    8 heads split 8 + 2), the smallest widths, ds 32 and zamba2's widths;
    each output and gradient within SCAN_TOL of its largest magnitude; one
    SSD launch a forward and none of the step kernels; the backward op one
    launch of the kernel ``ssd_route`` picks (the step kernel below
    SSD_BWD_MIN_STEPS), and the SSD backward at every shape, two of its
    runs bit-equal."""
    from repro_torch.kernels import selective_scan as ss

    args = _scan_inputs(cuda, bsz, s, nh * hd, ds, nh, carried)
    gy, gh = _cotangents(cuda, bsz, s, nh * hd, ds)
    loader.reset_launch_counts()
    got = ops.selective_scan_heads(*args, 256)
    torch.cuda.synchronize()
    assert _scan_launches() == {"selective_scan_ssd": 1}
    assert loader.ENTRY_LAUNCHES == {"selective_scan_ssd_launch": 1}
    _scan_close(got, ss.selective_scan_heads_plain(*args, 256))
    _scan_close(got, ss.selective_scan_ssd_plain(*args, tf32="3pass"))
    loader.reset_launch_counts()
    grads = ss.scan_heads_bwd_op(*args, gy, gh, 256)
    torch.cuda.synchronize()
    counter, entry = _scan_route(True, s, nh * hd, ds, nh, bwd=True)
    assert _scan_launches() == {counter: 1}
    assert loader.ENTRY_LAUNCHES == {entry: 1}
    runs = [ss._ssd_bwd_cuda(*ss._bwd_operands(
        "selective_scan_heads_bwd", *args, gy, gh, heads=True))
        for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(*runs))
    want = ss.selective_scan_heads_bwd_plain(*args, gy, gh, 256)
    _scan_close(grads, want)
    _scan_close(runs[0], want)


def test_selective_scan_ssd_takes_unaligned_inputs(cuda):
    """Operands at an address that is not 16-byte aligned (a view one float
    into a buffer) are copied before the SSD kernels' 16-byte tile copies,
    with the same bits as aligned ones."""
    from repro_torch.kernels import selective_scan as ss

    dt, a, x, b, c, h0 = _scan_inputs(cuda, 2, 100, 128, 16, 2)
    gy, gh = _cotangents(cuda, 2, 100, 128, 16)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v

    moved = [shifted(t) for t in (x, b, c, h0)]
    assert all(t.data_ptr() % 16 for t in moved)
    want = ops.selective_scan_heads(dt, a, x, b, c, h0, 256)
    got = ops.selective_scan_heads(dt, a, *moved, 256)
    assert all(torch.equal(p, q) for p, q in zip(got, want))
    want = ss.scan_heads_bwd_op(dt, a, x, b, c, h0, gy, gh, 256)
    got = ss.scan_heads_bwd_op(dt, a, *moved, shifted(gy), shifted(gh), 256)
    assert all(torch.equal(p, q) for p, q in zip(got, want))
