"""Dispatch layer for the hand-written kernels — port of
``src/repro/kernels/ops.py:72-105``.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
PyTorch version.  Nothing catches a failed build or launch and carries on.
The build-and-load step and the launch counters live in
``repro_torch.kernels.loader`` and are re-exported here.
"""
from __future__ import annotations

from repro_torch.kernels.bitonic_topk import (
    bitonic_merge_topl_cuda, bitonic_merge_topl_plain, bitonic_sort_pairs_cuda,
    bitonic_sort_pairs_plain,
)
from repro_torch.kernels.l2_rerank import (
    l2_rerank_cuda, l2_rerank_masked_cuda, l2_rerank_masked_plain,
    l2_rerank_plain,
)
from repro_torch.kernels.loader import (  # noqa: F401  (re-exports)
    LAUNCHES, build_all, reset_launch_counts,
)
from repro_torch.kernels.pq_adt import pq_adt_cuda, pq_adt_plain
from repro_torch.kernels.pq_lookup import (
    pq_lookup_cuda, pq_lookup_gather_cuda, pq_lookup_gather_plain,
    pq_lookup_plain,
)


def _check_ids(ids, mask=None) -> None:
    """CPU path: the kernels trap on a negative id they read (with a mask,
    one the mask asks for), so the plain versions refuse one too instead of
    wrapping it."""
    neg = ids < 0 if mask is None else (ids < 0) & mask
    if bool(neg.any()):
        raise ValueError("negative id passed to a gather: clamp -1 padding "
                         "first")


def pq_adt(queries, centroids, metric="l2"):
    if queries.is_cuda:
        return pq_adt_cuda(queries, centroids, metric)
    return pq_adt_plain(queries, centroids, metric)


def pq_lookup(codes, adt):
    if codes.is_cuda:
        return pq_lookup_cuda(codes, adt)
    return pq_lookup_plain(codes, adt)


def pq_lookup_gather(ids, codes, adts, mask=None):
    if ids.is_cuda:
        return pq_lookup_gather_cuda(ids, codes, adts, mask)
    _check_ids(ids)
    return pq_lookup_gather_plain(ids, codes, adts, mask)


def bitonic_sort_pairs(keys, vals):
    if keys.is_cuda:
        return bitonic_sort_pairs_cuda(keys, vals)
    return bitonic_sort_pairs_plain(keys, vals)


def bitonic_merge_topl(ids, dists, acc, evaluated, n_ids, n_dists):
    if ids.is_cuda:
        return bitonic_merge_topl_cuda(ids, dists, acc, evaluated, n_ids,
                                       n_dists)
    return bitonic_merge_topl_plain(ids, dists, acc, evaluated, n_ids, n_dists)


def l2_rerank(queries, candidates, metric="l2"):
    if queries.is_cuda:
        return l2_rerank_cuda(queries, candidates, metric)
    return l2_rerank_plain(queries, candidates, metric)


def l2_rerank_masked(queries, ids, base, acc, mask, metric="l2"):
    if queries.is_cuda:
        return l2_rerank_masked_cuda(queries, ids, base, acc, mask, metric)
    _check_ids(ids, mask)
    return l2_rerank_masked_plain(queries, ids, base, acc, mask, metric)

