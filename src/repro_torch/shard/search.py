"""Per-tile search fan-out + cross-tile top-k merge — port of
``src/repro/shard/search.py`` (``cross_tile_merge``, ``_fan_out``,
``route_queries``, ``sharded_search_kernel``, ``sharded_search``).

A query batch is broadcast to every tile; each tile runs the unmodified
Algorithm-1 traversal (``core.search.graph_search``, on the four kernels on
CUDA) against its local graph/codes/base, in one of the reference's two
fan-outs:

* **batched** (the reference's vmap over the tile axis, its default on the
  jnp path): ONE traversal of P*Q lanes over the stacked tile tables viewed
  as (P*Nt, ...), lane p*Q + q searching query q in tile p with tile-local
  ids (``core.search.Corpus.lane_offset``).  A batch pays one round's
  launches, not P, and runs until its slowest lane is done;
* **unrolled**: one traversal per tile, one tile after another, so tiles
  early-terminate independently.  A masked fan-out (``node_masks``) is
  always unrolled: that makes the zero-pass tile skip a host decision.

Both give the same ids, distances and counters: every lane's arithmetic is
its own.
Tile-local result ids are mapped to global ids through ``tile_ids`` and the
P*k candidate streams are fused per query by accurate distance in
``cross_tile_merge``: the candidates padded to the next power of two and
sorted by the ``bitonic_sort_pairs`` kernel on CUDA (the ASIC's shared
Bitonic Sorter doing one extra merge pass), its plain version on the CPU.
That sort is stable on (key, position), so ties resolve as the reference's
``lax.top_k`` does: the lower position first.

Replicated hot nodes surface from several tiles with identical distances;
the merge masks those duplicates before ranking.  Per-tile traversal
counters keep their tile axis in ``ShardedSearchResult.per_tile``.  The
channel-observability hook (``set_observability``) records the tile load
imbalance and the served and skipped lanes of every fan-out, from one host
read, and only when it is installed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import SearchConfig
from repro_torch.core.dataset import l2_normalize
from repro_torch.core.search import (
    INF, Corpus, SearchResult, _stable_order, empty_search_result,
    graph_search, next_pow2, queries_to,
)
from repro_torch.kernels import ops
from repro_torch.shard.partition import TiledCorpus

_COUNTERS = ("n_hops", "n_pq", "n_acc", "n_hot_hops", "n_free_pq", "rounds")

_obs = None     # Observability bundle (repro_torch.obs) or None


def set_observability(obs) -> None:
    """Install (or clear) the channel-observability sink — per-flush tile
    load imbalance and skipped-lane counts (``Observability.
    install_kernel_hooks`` wires this alongside the kernel hooks)."""
    global _obs
    _obs = obs if obs is not None and getattr(obs, "enabled", False) \
        else None


def _record_channel_stats(res: "ShardedSearchResult") -> None:
    """Per-tile work distribution into the registry (straggler accounting —
    the host-side twin of ``nand.simulate_sharded``'s load_imbalance).  The
    per-tile hop totals and the served-lane count come to the host in one
    copy, queued behind the merge (the caller reads the ids right after)."""
    per_tile_hops = res.per_tile.n_hops.to(torch.int64).sum(1)   # (P,)
    served = res.probed.sum().reshape(1)
    host = torch.cat([per_tile_hops, served]).cpu().numpy()
    per_tile = host[:-1].astype(float)       # total work per channel
    mean = per_tile.mean()
    m = _obs.metrics
    m.gauge("tile_load_imbalance",
            float(per_tile.max() / mean) if mean > 0 else 1.0)
    served = float(host[-1])
    m.counter("tile_lanes_skipped", float(res.probed.numel()) - served)
    m.counter("tile_lanes_served", served)


class ShardedSearchResult(NamedTuple):
    ids: torch.Tensor           # (Q, k) int32 GLOBAL ids, -1 padded
    dists: torch.Tensor         # (Q, k) f32 accurate distances, +inf padded
    per_tile: SearchResult      # every field with a leading (P, ...) axis
    probed: torch.Tensor        # (P, Q) bool — which tiles served which
                                # query (all True under full fan-out)

    @property
    def num_tiles(self) -> int:
        return self.per_tile.ids.shape[0]


def cross_tile_merge(ids: torch.Tensor, dists: torch.Tensor, k: int):
    """Fuse per-tile candidate streams, (Q, C) global ids (-1 invalid) and
    accurate distances, into a global top-k per query.  Duplicate ids
    (hot-node replicas found by several tiles) keep only their first
    occurrence; invalid and duplicate slots rank as +inf and come back as
    id -1.  The sort is one ``bitonic_sort_pairs`` launch on CUDA."""
    q, c = ids.shape
    eq = ids[:, :, None] == ids[:, None, :]
    lower = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                  device=ids.device), diagonal=-1)
    dup = (eq & lower[None]).any(-1)
    key = torch.where(dup | (ids < 0), INF, dists)
    pot = next_pow2(c)
    keys = torch.nn.functional.pad(key, (0, pot - c), value=INF)
    pos = torch.nn.functional.pad(
        torch.arange(c, dtype=torch.int32, device=ids.device), (0, pot - c))
    sk, sp = ops.bitonic_sort_pairs(keys, pos.expand(q, pot).contiguous())
    out_d, perm = sk[:, :k], sp[:, :k]
    out_ids = ids.gather(1, perm.long())
    out_ids = torch.where(torch.isinf(out_d), -1, out_ids)
    return out_ids, out_d


def _tile_corpus(tiled: TiledCorpus, p: int, entries, hots) -> Corpus:
    return Corpus(adjacency=tiled.adjacency[p], codes=tiled.codes[p],
                  base=tiled.base[p], centroids=tiled.centroids,
                  entry_point=entries[p], hot_count=hots[p])


def _stacked_corpus(tiled: TiledCorpus, nq: int) -> Corpus:
    """The P tiles as one corpus of P*nq lanes: the stacked tables viewed
    as (P*Nt, ...), and lane p*nq + q given tile p's entry point, hot count
    and row offset p*Nt."""
    p, nt = tiled.adjacency.shape[:2]
    dev = tiled.adjacency.device

    def per_lane(t):
        return t.to(torch.int32).repeat_interleave(nq)

    return Corpus(
        adjacency=tiled.adjacency.reshape(p * nt, -1),
        codes=tiled.codes.reshape(p * nt, -1),
        base=tiled.base.reshape(p * nt, -1), centroids=tiled.centroids,
        entry_point=per_lane(tiled.entry_points),
        hot_count=per_lane(tiled.hot_counts)[:, None],
        lane_offset=per_lane(torch.arange(p, device=dev) * nt)[:, None])


def _fan_out(tiled: TiledCorpus, queries: torch.Tensor, cfg: SearchConfig,
             metric: str, use_vmap: bool, node_masks=None) -> SearchResult:
    """``graph_search`` on every tile; results get a leading (P,) axis.
    ``use_vmap`` without ``node_masks``: one traversal of the stacked tiles'
    P*Q lanes.  Otherwise the tiles in turn; ``node_masks`` (P, Nt) bool —
    per-tile slices of a pass mask: each tile admits only its passing
    vertices, and a tile whose slice is all-False is skipped outright
    (zero-pass tile skipping)."""
    if use_vmap and node_masks is None:
        nq = queries.shape[0]
        res = graph_search(_stacked_corpus(tiled, nq), queries, cfg, metric)
        return SearchResult(*(x.reshape(tiled.num_tiles, nq, *x.shape[1:])
                              for x in res))
    entries = tiled.entry_points.tolist()
    hots = tiled.hot_counts.tolist()
    live = [True] * tiled.num_tiles if node_masks is None \
        else node_masks.any(1).tolist()
    per = []
    for p in range(tiled.num_tiles):
        if not live[p]:
            per.append(empty_search_result(queries.shape[0], cfg.k,
                                           device=queries.device))
            continue
        per.append(graph_search(
            _tile_corpus(tiled, p, entries, hots), queries, cfg, metric,
            node_mask=None if node_masks is None else node_masks[p]))
    return SearchResult(*(torch.stack(xs) for xs in zip(*per)))


def route_queries(tiled: TiledCorpus, queries, probe_tiles: int,
                  metric: str = "l2") -> torch.Tensor:
    """(P, Q) bool — the ``probe_tiles`` tiles whose centroid is nearest
    each query (ties to the lower tile, as ``lax.top_k``): the coarse router
    in front of the channels (IVF-style nprobe); meaningful with
    geometry-aware allocation (``policy="cluster"``)."""
    cents = tiled.tile_centroids
    q = torch.as_tensor(queries, dtype=torch.float32, device=cents.device)
    if metric == "angular":
        d = -(l2_normalize(q) @ l2_normalize(cents).T)      # (Q, P)
    elif metric == "ip":
        d = -(q @ cents.T)
    else:
        diff = q[:, None, :] - cents[None]
        d = (diff * diff).sum(-1)
    p = cents.shape[0]
    nprobe = max(1, min(int(probe_tiles), p))
    idx = _stable_order(d, nprobe)                          # (Q, nprobe)
    mask = torch.zeros((q.shape[0], p), dtype=torch.bool, device=q.device)
    mask.scatter_(1, idx, True)
    return mask.T.contiguous()


def sharded_search_kernel(tiled: TiledCorpus, queries, cfg: SearchConfig,
                          metric: str = "l2", use_vmap=None,
                          probe_tiles=None,
                          node_masks=None) -> ShardedSearchResult:
    """Channel-parallel Proxima search: fan out over tiles, merge top-k —
    the ``tiled`` execution spine of a ``plan.QueryPlan``.

    ``use_vmap`` selects the fan-out: True the batched one, False the
    unrolled loop; None resolves as the reference does, to ``not
    cfg.use_pallas``, so the default is the batched fan-out and a config
    with ``use_pallas=True`` gets the unrolled one (the port's kernels run
    either; pass ``use_vmap=True`` to keep the batched one).  A masked
    fan-out is unrolled whatever ``use_vmap`` says.

    ``probe_tiles`` enables the coarse query router: each query is served
    by its nearest tiles only; the others' candidates are masked from the
    merge and their counters zeroed for that query.  As in the reference,
    every tile still runs every query; routing changes the result, not the
    work.  ``node_masks`` (P, Nt) bool (numpy or tensor): filtered search
    over per-tile mask slices (``filter.tile_node_masks``); tiles with no
    passing vertex are skipped and excluded from the merge."""
    dev = tiled.base.device
    q = queries_to(queries, dev, tiled.base.shape[2])
    if node_masks is not None:
        node_masks = torch.as_tensor(node_masks, dtype=torch.bool,
                                     device=dev)
    if use_vmap is None:
        use_vmap = not cfg.use_pallas
    per = _fan_out(tiled, q, cfg, metric, use_vmap, node_masks)
    nt = tiled.num_tiles
    # probe_tiles in {None, 0} -> full fan-out
    if probe_tiles and probe_tiles < nt:
        probed = route_queries(tiled, q, probe_tiles, metric)
        # a skipped (tile, query) lane did no billed work: zero its counters
        per = per._replace(**{f: torch.where(probed, getattr(per, f), 0)
                              for f in _COUNTERS})
    else:
        probed = torch.ones((nt, q.shape[0]), dtype=torch.bool, device=dev)
    if node_masks is not None:
        # zero-pass tiles served nothing: mark them unprobed for the merge
        probed = probed & node_masks.any(1)[:, None]

    # tile-local -> global ids (pads and invalid lanes -> -1)
    p, nq, k = per.ids.shape
    local = per.ids.clamp(0, tiled.tile_ids.shape[1] - 1).reshape(p, -1)
    gids = tiled.tile_ids.gather(1, local.long()).reshape(p, nq, k)
    gids = torch.where((per.ids >= 0) & probed[:, :, None], gids, -1)
    cand_ids = gids.permute(1, 0, 2).reshape(nq, p * k)
    cand_d = per.dists.permute(1, 0, 2).reshape(nq, p * k)
    cand_d = torch.where(cand_ids >= 0, cand_d, INF)
    out_ids, out_d = cross_tile_merge(cand_ids, cand_d, cfg.k)
    res = ShardedSearchResult(ids=out_ids, dists=out_d, per_tile=per,
                              probed=probed)
    if _obs is not None:
        _record_channel_stats(res)
    return res


def sharded_search(tiled: TiledCorpus, queries, cfg: SearchConfig,
                   metric: str = "l2", use_vmap=None, probe_tiles=None,
                   node_masks=None) -> ShardedSearchResult:
    """Entry point over a tiled target: a ``plan.SearchRequest`` through
    the ``Searcher`` facade, which calls ``sharded_search_kernel`` with the
    same arguments.  ``node_masks`` apply verbatim (no config
    adaptation)."""
    from repro_torch.plan import Searcher, SearchRequest

    s = Searcher.open(tiled, cfg=cfg, metric=metric, use_vmap=use_vmap,
                      probe_tiles=probe_tiles)
    return s.search(SearchRequest(queries=queries, node_mask=node_masks)).raw
