"""Merged search over base index + delta segment with tombstone filtering —
port of ``src/repro/stream/searcher.py``.

The base runs the port's search on the base's device, unchanged, over-fetched
by ``StreamConfig.base_overfetch`` candidates so tombstoned hits can be
dropped without losing recall, in one of the reference's three regimes:
flat ``graph_search``; ``flat_filtered_search`` under the combined
filter ∧ ¬tombstone admission mask (masked traversal, bitmap scan or the
empty short-circuit); or, with ``num_tiles > 1``, the tiled fan-out
``shard.sharded_search_kernel`` over per-tile mask slices.  The delta
segment is searched on the host in one batched call for the whole query
batch (it is DRAM-resident and small by construction; see ``stream.delta``),
and the two candidate streams are fused by accurate distance: ids mapped to
external ids and the tombstone (and filter) mask applied on the host, then
one stable row sort of the (Q, k_base + k_delta) keys — base columns first,
so ties go to the base, as the reference's ``np.argsort(kind="stable")``
gives them.  The sort is ``ops.bitonic_sort_pairs`` on the base's device:
one launch of the CUDA sort entry on the card (the keys padded with +inf to
a power of two, the payload each column's position), its plain version on
the CPU.  The delta's distances are the host's float32, merged as they are.
Result ids are int32 external ids, -1 where the distance is not finite.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import SearchConfig, upgrade_config
from repro_torch.core.search import SearchResult, graph_search, next_pow2
from repro_torch.kernels import ops


class MergedResult(NamedTuple):
    ids: np.ndarray             # (Q, k) int32 external ids, -1 padded
    dists: np.ndarray           # (Q, k) accurate distances, +inf padded
    base: Union[SearchResult, object]  # raw base result on the device; with
                                # a tiled base a shard.ShardedSearchResult
                                # (its .per_tile counters feed the NAND model)
    delta_candidates: np.ndarray  # (Q,) delta candidates considered
    selectivity: float = 1.0    # base admission-mask passing fraction
                                # (1.0 unfiltered) — the plan layer's
                                # billing input for merged executions
    base_mode: str = "none"     # realized base filter regime: none |
                                # traversal | scan | empty — scan's
                                # candidate stream is the passing subset
                                # itself, which the NAND pushdown billing
                                # must not discount


def merged_search_kernel(
    mutable,
    queries: np.ndarray,
    cfg: Optional[SearchConfig] = None,
    probe_tiles: Optional[int] = None,
    filter_spec=None,
) -> MergedResult:
    """Base + delta merge — the ``merged`` execution spine of a
    ``plan.QueryPlan`` (the admission mask depends on the live tombstone
    set, so the filter regime is decided here on every call)."""
    full_cfg = upgrade_config(mutable.base.config)
    cfg = cfg or full_cfg.search
    k = cfg.k
    k_base = min(cfg.list_size, k + mutable.stream_cfg.base_overfetch)
    base_cfg = dataclasses.replace(cfg, k=k_base) if k_base != k else cfg

    base_mask = ext_mask = None
    if filter_spec is not None and not getattr(filter_spec, "is_all", False):
        base_mask, ext_mask = mutable.filter_masks(filter_spec)
    fcfg = full_cfg.filter

    q = np.atleast_2d(np.asarray(queries, np.float32))
    base_mode = "none" if base_mask is None else "traversal"
    if getattr(mutable, "num_tiles", 1) > 1:
        from repro_torch.shard.search import sharded_search_kernel

        # tiled base: per-tile ids come back in the base index's global
        # (reordered-internal) id space, so the external-id and tombstone
        # plumbing below is the single-tile path's
        node_masks = None
        tiled = mutable.tiled_corpus()
        tiled_cfg = base_cfg
        if base_mask is not None:
            from repro_torch.filter.traversal import (
                adapt_search_cfg, tile_node_masks,
            )

            node_masks = tile_node_masks(tiled.tile_ids, base_mask)
            tiled_cfg = adapt_search_cfg(base_cfg, float(base_mask.mean()),
                                         fcfg)
        res = sharded_search_kernel(tiled, q, tiled_cfg, mutable.metric,
                                    use_vmap=None, probe_tiles=probe_tiles,
                                    node_masks=node_masks)
    elif base_mask is not None:
        from repro_torch.plan.planner import flat_filtered_search

        # selectivity-adaptive base path (masked traversal / bitmap scan /
        # empty) through the plan layer's regime-decision point
        fres = flat_filtered_search(mutable.corpus(), q, base_mask, base_cfg,
                                    mutable.metric, filter_cfg=fcfg)
        base_mode, res = fres.mode, fres.result
    else:
        res = graph_search(mutable.corpus(), q, base_cfg, mutable.metric)
    out_ids, out_d, n_delta = _merge_base_delta(
        mutable, q, res.ids, res.dists, ext_mask, k)
    return MergedResult(
        ids=out_ids, dists=out_d, base=res, delta_candidates=n_delta,
        selectivity=1.0 if base_mask is None else float(base_mask.mean()),
        base_mode=base_mode,
    )


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def merge_order(cand_d: np.ndarray, k: int, device) -> np.ndarray:
    """(Q, k) column positions of each row's k smallest keys (k <= the
    row's width), ties to the lower position: one ``ops.bitonic_sort_pairs``
    of the rows padded with +inf keys to a power of two, on ``device``."""
    nq, c = cand_d.shape
    pot = max(next_pow2(c), 2)
    keys = torch.nn.functional.pad(
        torch.as_tensor(cand_d, dtype=torch.float32, device=device),
        (0, pot - c), value=float("inf"))
    pos = torch.arange(pot, dtype=torch.int32, device=device)
    _, order = ops.bitonic_sort_pairs(keys, pos.expand(nq, pot).contiguous())
    return order[:, :k].cpu().numpy()


def _merge_base_delta(
    mutable,
    q: np.ndarray,
    base_ids,
    base_d,
    ext_mask,
    k: int,
):
    """Cross-segment fusion half of the merged kernel: map base-internal ids
    (a tensor or array) to external ids, drop tombstoned / non-passing hits,
    search the delta segment once for the batch, and top-k merge the two
    candidate streams by accurate distance.  Shared with the continuous
    engine's retire path (``plan.rounds.RoundSession.complete``), which
    fuses retired lanes against the live delta and tombstones.  Returns
    ``(ids, dists, delta_candidates)``."""
    base_ids, base_d = _host(base_ids), _host(base_d)
    valid = (base_ids >= 0) & np.isfinite(base_d)
    ext = mutable.ext_base[np.clip(base_ids, 0, None)]  # (Q, k_base)
    dead = mutable.tombstone_mask(ext)
    keep = valid & ~dead
    if ext_mask is not None:
        # the traversal already admitted only passing nodes; the combined
        # filter ∧ tombstone mask is re-applied on external ids so the
        # merge invariant holds by construction
        keep &= ext_mask[np.clip(ext, 0, None)]
    base_d = np.where(keep, base_d, np.inf)
    ext = np.where(keep, ext, -1)

    nq = q.shape[0]
    delta = mutable.delta
    cand_ids, cand_d = ext, base_d                    # (Q, k_base)
    n_delta = np.zeros((nq,), np.int32)
    if len(delta):
        # one batched delta search for the whole query batch, with the same
        # tombstone slack as the base path: deleted delta vectors must not
        # crowd live ones out of the candidate set
        dl_ids, dl_d = delta.search_batch(
            q, k + mutable.stream_cfg.base_overfetch
        )                                             # (Q, k_delta)
        delta_ext = np.asarray(mutable.delta_ext, np.int64)
        dl_ext = np.where(
            dl_ids >= 0, delta_ext[np.clip(dl_ids, 0, None)], -1
        )
        alive = (dl_ids >= 0) & ~mutable.tombstone_mask(dl_ext)
        if ext_mask is not None:
            # the same combined mask on the delta stream
            alive &= ext_mask[np.clip(dl_ext, 0, None)]
        n_delta = (dl_ids >= 0).sum(1).astype(np.int32)
        cand_ids = np.concatenate(
            [cand_ids, np.where(alive, dl_ext, -1)], axis=1
        )
        cand_d = np.concatenate(
            [cand_d, np.where(alive, dl_d, np.inf)], axis=1
        )
    # the cross-segment merge: one row-wise stable sort, top-k
    if cand_d.shape[1] < k:                   # degenerate list_size < k
        pad = k - cand_d.shape[1]
        cand_ids = np.pad(cand_ids, ((0, 0), (0, pad)), constant_values=-1)
        cand_d = np.pad(cand_d, ((0, 0), (0, pad)), constant_values=np.inf)
    cand_d = cand_d.astype(np.float32)
    order = merge_order(cand_d, k, mutable.device)
    out_d = np.take_along_axis(cand_d, order, 1)
    out_ids = np.take_along_axis(cand_ids, order, 1).astype(np.int32)
    out_ids = np.where(np.isfinite(out_d), out_ids, np.int32(-1))
    return out_ids, out_d, n_delta


def search_merged(
    mutable,
    queries: np.ndarray,
    cfg: Optional[SearchConfig] = None,
    probe_tiles: Optional[int] = None,
    filter_spec=None,
) -> MergedResult:
    """Entry point over a mutable index (deprecated in the reference): a
    ``plan.SearchRequest`` through the ``Searcher`` facade, which calls
    ``merged_search_kernel`` with the same arguments."""
    from repro_torch.plan import Searcher, SearchRequest

    # probe_tiles=None meant "no routing" here — pin 0 to keep that
    s = Searcher.open(mutable, cfg=cfg,
                      probe_tiles=0 if probe_tiles is None else probe_tiles)
    return s.search(SearchRequest(queries=queries, filter=filter_spec)).raw
