"""Selectivity-adaptive filtered search kernels — port of
``src/repro/filter/traversal.py`` (``FilteredSearchResult``,
``adapt_search_cfg``, ``scan_search`` / ``_scan_kernel``).

The regime DECISION lives in ``repro_torch.plan.QueryPlanner`` (the
masked / scan / empty strategy of a ``QueryPlan``); this module keeps what
it composes:

  * **masked traversal** runs ``core.search.graph_search(node_mask=...)``
    with the config ``adapt_search_cfg`` returns: ``list_size`` inflated by
    ~1/selectivity (pow2-quantized, capped at ``inflate_cap``), ``t_step``
    scaled to match, early termination relaxed by ``relax_repetition``.  An
    all-pass filter leaves the config untouched.
  * **scan** (``scan_search``) is a brute-force PQ pass over the passing
    subset, padded to the next power of two: the ADTs (``ops.pq_adt`` on
    CUDA), one lookup of every passing row's codes (``ops.pq_lookup_gather``
    over (Q, S) ids, the padding masked off), a stable selection of the
    ``scan_rerank * k`` best (the reference's ``lax.top_k``, ties to the
    lower position), their exact distances (``ops.l2_rerank_masked``, only
    rows with a finite PQ distance read), then the top-k.

``tile_node_masks`` slices a global pass mask into the shard layer's
per-tile masks (numpy, the reference's).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import FilterConfig, SearchConfig
from repro_torch.core.dataset import l2_normalize
from repro_torch.core.search import (
    INF, Corpus, SearchResult, _build_adts, _queries_on, _stable_order,
    next_pow2,
)
from repro_torch.kernels import ops


class FilteredSearchResult(NamedTuple):
    ids: np.ndarray             # (Q, k) int32 passing ids only, -1 padded
    dists: np.ndarray           # (Q, k) f32 accurate distances, +inf padded
    result: SearchResult        # counters (scan mode: synthesized — hops=0,
                                # pq = passing-subset size, rounds=1)
    mode: str                   # "traversal" | "scan" | "empty"
    selectivity: float          # exact passing fraction of the mask
    effective: SearchConfig     # the adapted config actually executed


def adapt_search_cfg(cfg: SearchConfig, selectivity: float,
                     filter_cfg: FilterConfig) -> SearchConfig:
    """Masked-traversal config for a given selectivity: the candidate list
    must hold ~1/selectivity non-passing entries per admitted one, so the
    frontier inflates accordingly (pow2-quantized) and termination is
    relaxed.  selectivity >= 1 returns ``cfg`` unchanged (the all-pass
    bit-identity guarantee)."""
    if selectivity >= 1.0:
        return cfg
    want = min(1.0 / max(selectivity, 1e-9), float(filter_cfg.inflate_cap))
    inflate = next_pow2(int(np.ceil(want)))
    return dataclasses.replace(
        cfg,
        list_size=cfg.list_size * inflate,
        t_step=cfg.t_step * inflate,
        repetition_rate=cfg.repetition_rate + filter_cfg.relax_repetition,
    )


def tile_node_masks(tile_ids, mask: np.ndarray) -> np.ndarray:
    """Slice a global pass mask into per-tile local masks: (P, Nt) bool over
    ``TiledCorpus.tile_ids`` (a tensor or array; padding rows never pass) —
    the per-channel bitmap slices of the shard layer; a tile whose slice is
    all-False skips the query (zero-pass tile skipping)."""
    tid = tile_ids.cpu().numpy() if isinstance(tile_ids, torch.Tensor) \
        else np.asarray(tile_ids)
    m = np.asarray(mask, bool)
    return (tid >= 0) & m[np.clip(tid, 0, None)]


# ---------------------------------------------------------------------------
# Brute-force PQ scan over the passing subset
# ---------------------------------------------------------------------------

def _scan_kernel(corpus: Corpus, queries, cfg: SearchConfig,
                 sel_ids: torch.Tensor, sel_valid: torch.Tensor, k: int,
                 m_rerank: int, metric: str, use_pq: bool):
    """One batched pass over the gathered passing rows.  sel_ids (S,) int32
    (pow2-padded with id 0), sel_valid (S,) bool.  Returns (ids, dists,
    n_acc_each), tensors on the corpus's device."""
    q = _queries_on(corpus, queries)
    if metric == "angular":
        q = l2_normalize(q)
    nq, s = q.shape[0], sel_ids.shape[0]
    ids = sel_ids[None, :].expand(nq, s).contiguous()          # (Q, S)
    valid = sel_valid[None, :].expand(nq, s).contiguous()
    if use_pq:
        adts = _build_adts(corpus, q, cfg, metric)
        d = ops.pq_lookup_gather(ids, corpus.codes, adts, valid)  # +inf pads
        m = min(m_rerank, s)
        order = _stable_order(d, m)                            # (Q, m)
        cand = sel_ids[order.long()]
        finite = ~torch.isinf(d.gather(1, order))              # padded: inf
        acc = ops.l2_rerank_masked(q, cand, corpus.base,
                                   torch.full_like(d[:, :m], INF), finite,
                                   metric)
        idx2 = _stable_order(acc, min(k, m))
        out_ids = cand.gather(1, idx2)
        n_acc_each = finite.sum(1, dtype=torch.int32)
    else:
        acc = ops.l2_rerank_masked(q, ids, corpus.base,
                                   torch.full(ids.shape, INF, device=q.device),
                                   valid, metric)
        idx2 = _stable_order(acc, min(k, s))
        out_ids = sel_ids[idx2.long()]
        n_acc_each = sel_valid.sum(dtype=torch.int32).repeat(nq)
    out_d = acc.gather(1, idx2)
    out_ids = torch.where(torch.isinf(out_d), -1, out_ids)
    return out_ids, out_d, n_acc_each


def _pad_topk(ids: np.ndarray, dists: np.ndarray, k: int):
    got = ids.shape[1]
    if got >= k:
        return ids[:, :k], dists[:, :k]
    q = ids.shape[0]
    pid = np.full((q, k), -1, np.int32)
    pd = np.full((q, k), np.inf, np.float32)
    pid[:, :got] = ids
    pd[:, :got] = dists
    return pid, pd


def scan_search(corpus: Corpus, queries, mask: np.ndarray,
                cfg: SearchConfig, metric: str, fcfg: FilterConfig,
                selectivity: float) -> FilteredSearchResult:
    """Bitmap-driven brute-force PQ scan over the passing subset — the
    ``scan`` strategy of a ``repro_torch.plan.QueryPlan``."""
    dev = corpus.base.device
    pass_ids = np.nonzero(mask)[0].astype(np.int32)
    pot = next_pow2(len(pass_ids))
    sel_ids = torch.zeros((pot,), dtype=torch.int32, device=dev)
    sel_ids[: len(pass_ids)] = torch.as_tensor(pass_ids, device=dev)
    sel_valid = torch.arange(pot, device=dev) < len(pass_ids)
    m_rerank = next_pow2(max(fcfg.scan_rerank * cfg.k, cfg.k))
    use_pq = cfg.use_pq and cfg.rerank  # rank-by-PQ degenerates to exact scan
    ids, dists, n_acc = _scan_kernel(corpus, queries, cfg, sel_ids, sel_valid,
                                     cfg.k, m_rerank, metric, use_pq)
    nq = ids.shape[0]
    ids, dists = _pad_topk(ids.cpu().numpy(), dists.cpu().numpy(), cfg.k)
    z = torch.zeros((nq,), dtype=torch.int32, device=dev)
    res = SearchResult(
        ids=torch.as_tensor(ids, device=dev),
        dists=torch.as_tensor(dists, device=dev),
        n_hops=z, n_hot_hops=z, n_free_pq=z,
        n_pq=torch.full_like(z, len(pass_ids) if use_pq else 0),
        n_acc=n_acc if use_pq else torch.full_like(z, len(pass_ids)),
        rounds=torch.ones_like(z),
    )
    return FilteredSearchResult(ids=ids, dists=dists, result=res,
                                mode="scan", selectivity=selectivity,
                                effective=cfg)
