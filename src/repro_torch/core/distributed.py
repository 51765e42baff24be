"""Distributed Proxima search — port of ``src/repro/core/distributed.py``
(``ShardedCorpus`` … ``distributed_search``, lines 52-388): the paper's
NAND-core / search-engine split over a ``torch.distributed`` device mesh
(``launch.mesh.make_mesh``).

Mapping, as in the reference:
  * mesh axis ``data`` = NAND cores: the corpus (adjacency, PQ codes, raw
    vectors) is sharded round-robin — vertex i lives on shard ``i % P`` at
    local row ``i // P``;
  * mesh axis ``model`` = search queues: the query batch goes to the ranks
    of this axis in contiguous blocks (the reference's ``P(queue_axis,
    None)``); the ranks that share a ``model`` coordinate form one data
    group, which runs one search engine over its block;
  * hot nodes (ids < hot_count) are replicated on every shard, so their
    rows are read locally.

Two dataflow modes (``mode``):
  * ``fetch`` — the engine gathers the frontier's PQ codes from the owning
    shards (shipped as int32, the reference's psum dtype, and cast back to
    uint8) and scores them itself: (Qb, E*R, M) codes a round;
  * ``nsp`` — each shard scores the frontier ids it owns and only the
    (Qb, E*R) float32 distances are summed: compute moves to the data.

The reference's ``psum(x, data_axis)`` is ``dist.all_reduce(SUM)`` over the
rank's data group, and the output's gather over ``queue_axis`` is an
all-gather into one tensor over its queue group.  A shard that does not own
an id contributes 0, never +inf (``pq_lookup_gather`` returns +inf where its
mask is False, and +inf would survive the sum); a value plus zeros is
exact, so both modes return the single-device ids bit for bit.  On a gloo
group, tensors on the card go through host memory (chosen by the group's
backend); NCCL takes them where they are.

Kernels, launched through ``kernels.ops`` like every other call site:
  * the ADTs of the rank's query block, ``pq_adt`` once a batch (on the CPU
    ``core.pq.compute_adt``'s expanded form, as ``graph_search`` builds it);
  * traversal distances on ``pq_lookup_gather``: in ``nsp`` one launch over
    the shard's codes at local ids ``id // P``, masked by "fresh and owned
    and not hot", and one over the hot replica, masked by "fresh and hot";
    in ``fetch`` one launch over the fetched (Qb*E*R, M) code table with
    ids ``q*E*R + j``, masked by "fresh";
  * the round's merge on ``bitonic_merge_topl``;
  * exact distances on ``l2_rerank_masked`` — the round's new top-T, the
    beta margin and the accurate traversal (``use_pq=False``): over the
    shard's base at local ids, masked by "needed and owned and not hot"
    with 0 elsewhere, summed, then over the hot replica ("needed and hot").
    The reference's ``fetch_base`` computes all L entries every round and
    keeps ``need & all_eval``; the masked entry computes only those: the
    same result for far less work.

Loop control: the rounds of one data group run on all its ranks in lock
step, each collective entered the same number of times by each.  The "any
lane active" flag is read every ``DONE_CHECK_EVERY`` rounds on CUDA (every
round on the CPU), reduced with MAX over the data group first, so no rank
leaves the loop alone.  Done lanes keep their state, so extra rounds are
no-ops and the rounds equal the reference's.  The final top-k is a stable
sort on (key, position), the lowest position winning ties, as
``lax.top_k`` does.

``TRAFFIC`` counts, on this rank, the bytes handed to the collectives by
purpose, the collectives and the rounds run (the smoke's bytes a round).
"""
from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import SearchConfig, upgrade_config
from repro_torch.core import bloom
from repro_torch.core.dataset import l2_normalize
from repro_torch.core.pq import compute_adt
from repro_torch.core.search import (
    DONE_CHECK_EVERY, INF, _dedup_round, _stable_order, _topk_ids_by,
    queries_to,
)
from repro_torch.kernels import ops

TRAFFIC: collections.Counter = collections.Counter()
# torch 2.13 names it all_gather_single and deprecates the old name, which
# older releases have alone
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


class ShardedCorpus(NamedTuple):
    """Round-robin-sharded corpus tensors, on one device.

    Sharded tables have a leading shard axis: adjacency (P, N/P, R), codes
    (P, N/P, M), base (P, N/P, D) — or, on a rank, only its own shard's
    slice, (1, N/P, ...), with ``shard`` its index.  Replicated: centroids
    and the hot-node replicas hot_* (the first max(hot_count, 1) rows)."""
    adjacency: torch.Tensor
    codes: torch.Tensor
    base: torch.Tensor
    centroids: torch.Tensor
    hot_adjacency: torch.Tensor     # (H, R)
    hot_codes: torch.Tensor         # (H, M)
    hot_base: torch.Tensor          # (H, D)
    entry_point: int
    hot_count: int
    num_vertices: int
    num_shards: int
    shard: Optional[int] = None     # the one shard held, or None: all P


def shard_corpus(adjacency, codes, base, centroids, entry_point: int,
                 hot_count: int, num_shards: int, *,
                 shard: Optional[int] = None,
                 device="cuda") -> ShardedCorpus:
    """Round-robin partition: vertex i -> (shard i % P, local row i // P),
    padding rows zero, the hot rows [:max(hot_count, 1)] replicated.  From
    the same numpy arrays the tables equal the reference's bit for bit.
    ``shard=i`` keeps only shard i's slice — what one rank holds — so the
    (P, N/P, ...) stack never reaches ``device`` at once."""
    p = int(num_shards)
    h = max(int(hot_count), 1)
    n = adjacency.shape[0]
    order = np.arange(n + (-n) % p).reshape(-1, p).T       # (P, N/P)
    if shard is not None:
        order = order[shard:shard + 1]
    pad = order >= n

    def stack(a):
        rows = np.asarray(a)[np.minimum(order, n - 1)]     # a new array
        rows[pad] = 0
        return torch.from_numpy(rows).to(device)

    def rep(a):
        return torch.tensor(np.asarray(a)[:h], device=device)

    return ShardedCorpus(
        adjacency=stack(adjacency), codes=stack(codes), base=stack(base),
        centroids=torch.tensor(np.asarray(centroids), device=device),
        hot_adjacency=rep(adjacency), hot_codes=rep(codes),
        hot_base=rep(base), entry_point=int(entry_point),
        hot_count=int(hot_count), num_vertices=int(n), num_shards=p,
        shard=shard)


class _Lanes(NamedTuple):
    """Per-lane traversal state of a rank's query block, lane axis first."""
    ids: torch.Tensor           # (Qb, L) int32, -1 padding
    dists: torch.Tensor         # (Qb, L) f32 traversal distances
    acc: torch.Tensor           # (Qb, L) f32 exact distances, +inf unknown
    evaluated: torch.Tensor     # (Qb, L) bool
    bits: torch.Tensor          # Bloom filter, updated in place
    t: torch.Tensor             # (Qb,) int32 dynamic list size
    prev: torch.Tensor          # (Qb, k) int32 last reranked top-k
    stable: torch.Tensor        # (Qb,) int32
    done: torch.Tensor          # (Qb,) bool
    rounds: torch.Tensor        # (Qb,) int32


class _Group:
    """One mesh axis's process group as seen from this rank."""

    def __init__(self, mesh, axis: str):
        self.group = mesh.get_group(axis)
        self.size = dist.get_world_size(self.group)
        self.index = mesh.get_local_rank(axis)
        self.gloo = dist.get_backend(self.group) == "gloo"

    def sum(self, t: torch.Tensor, what: str,
            op=dist.ReduceOp.SUM) -> torch.Tensor:
        """All-reduce ``t`` over the group (in place where it can)."""
        TRAFFIC[what] += t.numel() * t.element_size()
        TRAFFIC["collectives"] += 1
        staged = t.is_cuda and self.gloo
        buf = t.cpu() if staged else t
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(t.device) if staged else buf

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Concatenate every rank's ``t`` along dim 0, in group order."""
        TRAFFIC["gather"] += t.numel() * t.element_size()
        TRAFFIC["collectives"] += 1
        staged = t.is_cuda and self.gloo
        src = (t.cpu() if staged else t).contiguous()
        out = src.new_empty((self.size * src.shape[0],) + src.shape[1:])
        _all_gather(out, src, group=self.group)
        return out.to(t.device) if staged else out


def distributed_search_kernel(corpus: ShardedCorpus, queries,
                              cfg: SearchConfig, metric: str = "l2",
                              mode: str = "nsp", mesh=None,
                              data_axis: str = "data",
                              queue_axis: str = "model",
                              bloom_bits: int = 1 << 17,
                              num_hashes: int = 8):
    """Batched distributed search — the ``distributed`` execution spine of
    a ``plan.QueryPlan``.  Every rank of ``mesh`` calls it with the same
    (Q, D) queries; the queue-axis size must divide Q.  Returns (ids,
    dists), (Q, k) int32 / float32 tensors on the corpus's device, on every
    rank."""
    if mesh is None:
        raise ValueError("distributed_search_kernel needs mesh=")
    if mode not in ("nsp", "fetch"):
        raise ValueError(f"mode must be 'nsp' or 'fetch', not {mode!r}")
    cfg = upgrade_config(cfg)
    data, queue = _Group(mesh, data_axis), _Group(mesh, queue_axis)
    p, shard = corpus.num_shards, data.index
    if p != data.size:
        raise ValueError(f"the corpus has {p} shards, the mesh's "
                         f"{data_axis!r} axis {data.size} ranks")
    if corpus.shard is not None and corpus.shard != shard:
        raise ValueError(f"this rank serves shard {shard}, the corpus holds "
                         f"shard {corpus.shard}")
    i = shard if corpus.shard is None else 0
    adj_l, codes_l, base_l = (corpus.adjacency[i], corpus.codes[i],
                              corpus.base[i])
    dev = base_l.device
    q_all = queries_to(queries, dev, base_l.shape[1])
    if q_all.shape[0] % queue.size:
        raise ValueError(f"{q_all.shape[0]} queries do not split over "
                         f"{queue.size} {queue_axis!r} ranks")
    qb = q_all.shape[0] // queue.size
    q = q_all[queue.index * qb:(queue.index + 1) * qb]
    if metric == "angular":
        q = l2_normalize(q)

    L, k = cfg.list_size, cfg.k
    R, M = adj_l.shape[1], codes_l.shape[1]
    E = min(max(int(cfg.beam_width), 1), L)
    use_pq, do_et = cfg.use_pq, cfg.early_termination
    t_init = cfg.t_init if do_et else L
    t_step = cfg.t_step if do_et else L
    hot_n, h_rows = corpus.hot_count, corpus.hot_adjacency.shape[0]
    i32 = torch.int32
    if not use_pq:
        adts = torch.zeros((qb, 1, 1), device=dev)
    elif q.is_cuda:
        adts = ops.pq_adt(q, corpus.centroids, metric)
    else:
        adts = compute_adt(q, corpus.centroids, metric)

    def owned(ids):
        """Of ids >= 0: their local rows, owned by this shard and not hot,
        hot, and their rows in the hot replica (clamped)."""
        hot = ids < hot_n
        return (ids // p, (ids % p == shard) & ~hot, hot,
                ids.clamp(max=h_rows - 1))

    def neighbours(vs):
        """(Qb, E) vertex ids -> (Qb, E*R) neighbour ids (collective)."""
        local, mine, hot, hot_ids = owned(vs)
        rows = torch.where(mine[..., None], adj_l[local.long()], 0)
        rows = data.sum(rows, "adjacency")
        rows = torch.where(hot[..., None],
                           corpus.hot_adjacency[hot_ids.long()], rows)
        return rows.reshape(vs.shape[0], -1)

    def exact(ids, need, acc):
        """``acc`` with the exact distances of the ids where ``need`` holds
        (collective): the owners' rows summed, then the hot replica's."""
        local, mine, hot, hot_ids = owned(ids.clamp(min=0))
        cold = ops.l2_rerank_masked(q, local, base_l, torch.zeros_like(acc),
                                    need & mine, metric)
        cold = data.sum(cold, "exact")
        d = ops.l2_rerank_masked(q, hot_ids, corpus.hot_base, cold,
                                 need & hot, metric)
        return torch.where(need, d, acc)

    def tdist(ids, fresh):
        """Traversal distances of (Qb, n) ids in [0, N), +inf where
        ``fresh`` is False (collective)."""
        if not use_pq:           # accurate traversal: always nsp-style
            return exact(ids, fresh, torch.full(ids.shape, INF, device=dev))
        local, mine, hot, hot_ids = owned(ids)
        if mode == "fetch":
            rows = torch.where(mine[..., None], codes_l[local.long()].to(i32),
                               0)
            rows = data.sum(rows, "codes").to(torch.uint8)
            table = torch.where(hot[..., None],
                                corpus.hot_codes[hot_ids.long()], rows)
            n = ids.shape[1]
            tids = torch.arange(qb * n, dtype=i32, device=dev).reshape(qb, n)
            return ops.pq_lookup_gather(tids, table.reshape(-1, M), adts,
                                        fresh)
        cold_mask = fresh & mine
        cold = ops.pq_lookup_gather(local, codes_l, adts, cold_mask)
        cold = data.sum(torch.where(cold_mask, cold, 0.0), "scores")
        d = ops.pq_lookup_gather(hot_ids, corpus.hot_codes, adts,
                                 fresh & hot)
        return torch.where(fresh, torch.where(hot, d, cold), INF)

    # ---- round 0: every lane at the entry point --------------------------
    ep = torch.full((qb, 1), corpus.entry_point, dtype=i32, device=dev)
    d0 = tdist(ep, torch.ones_like(ep, dtype=torch.bool))[:, 0]
    ids0 = torch.full((qb, L), -1, dtype=i32, device=dev)
    ids0[:, 0] = corpus.entry_point
    dists0 = torch.full((qb, L), INF, device=dev)
    dists0[:, 0] = d0
    acc0 = torch.full((qb, L), INF, device=dev)
    if not use_pq:
        acc0[:, 0] = d0
    bits0 = bloom.bloom_init(bloom_bits, qb, dev)
    bloom.insert(bits0, ep, torch.ones_like(ep, dtype=torch.bool),
                 num_hashes)
    zero = torch.zeros((qb,), dtype=i32, device=dev)
    lanes = _Lanes(
        ids=ids0, dists=dists0, acc=acc0,
        evaluated=torch.zeros((qb, L), dtype=torch.bool, device=dev),
        bits=bits0, t=torch.full_like(zero, min(t_init, L)),
        prev=torch.full((qb, k), -2, dtype=i32, device=dev), stable=zero,
        done=torch.zeros_like(zero, dtype=torch.bool), rounds=zero)
    ar_e = torch.arange(E, device=dev)
    ar_l = torch.arange(L, device=dev)

    def active(s: _Lanes) -> torch.Tensor:
        return ~s.done & (s.rounds < cfg.max_rounds)

    def step(s: _Lanes) -> _Lanes:
        """One round over the block; done lanes keep their state."""
        live = active(s)
        valid = s.ids >= 0
        unev = valid & ~s.evaluated
        n_unev = unev.sum(1, dtype=i32)
        if E == 1:
            sel = unev.to(i32).argmax(1, keepdim=True)
        else:
            sel = torch.sort((~unev).to(i32), dim=1,
                             stable=True).indices[:, :E]
        sel_valid = ar_e[None, :] < n_unev[:, None]
        vs = torch.where(sel_valid, s.ids.gather(1, sel), 0)
        neigh = neighbours(vs)
        fresh = (_dedup_round(neigh)
                 & ~bloom.contains(s.bits, neigh, num_hashes)
                 & sel_valid.repeat_interleave(R, dim=1))
        nd = tdist(neigh, fresh)
        bloom.insert(s.bits, neigh, fresh & live[:, None], num_hashes)
        evaluated = s.evaluated.scatter(1, sel,
                                        s.evaluated.gather(1, sel) | sel_valid)
        ids, dists, acc, evaluated = ops.bitonic_merge_topl(
            s.ids, s.dists, s.acc, evaluated,
            torch.where(fresh, neigh, -1), nd)
        valid = ids >= 0
        in_t = (ar_l[None, :] < s.t[:, None]) & valid
        all_eval = in_t.any(1) & (~in_t | evaluated).all(1)
        if use_pq:
            acc2 = exact(ids, in_t & torch.isinf(acc)
                         & (all_eval & live)[:, None], acc)
        else:
            acc2 = torch.where(valid, dists, INF)
        new_topk = _topk_ids_by(ids, torch.where(in_t, acc2, INF), k)
        same = (new_topk == s.prev).all(1)
        stable = torch.where(all_eval, torch.where(same, s.stable + 1, 1),
                             s.stable)
        t = torch.where(all_eval, s.t + t_step, s.t)
        done = ((all_eval & (stable >= cfg.repetition_rate) & do_et)
                | (n_unev == 0) | (t > L))
        new = _Lanes(
            ids=ids, dists=dists, acc=acc2, evaluated=evaluated, bits=s.bits,
            t=torch.clamp(t, max=L),
            prev=torch.where(all_eval[:, None], new_topk, s.prev),
            stable=stable, done=done, rounds=s.rounds + 1)
        return _Lanes(*(
            b if b is a else torch.where(
                live.reshape((qb,) + (1,) * (b.dim() - 1)), b, a)
            for a, b in zip(s, new)))

    def any_active(s: _Lanes) -> bool:
        flag = active(s).any().to(i32).reshape(1)
        return bool(data.sum(flag, "active", dist.ReduceOp.MAX).item())

    every = DONE_CHECK_EVERY if q.is_cuda else 1
    while any_active(lanes):
        for _ in range(every):
            lanes = step(lanes)
        TRAFFIC["rounds"] += every

    # ---- beta-margin rerank + top-k (Alg.1 l.19-22) ----------------------
    s = lanes
    valid = s.ids >= 0
    t_idx = (torch.clamp(s.t, 1, L) - 1).long()
    d_t = s.dists.gather(1, t_idx[:, None])[:, 0]
    thr = d_t + (cfg.beta - 1.0) * torch.abs(d_t)
    if use_pq and cfg.rerank:
        acc = exact(s.ids, valid & (s.dists <= thr[:, None])
                    & torch.isinf(s.acc), s.acc)
    else:
        acc = torch.where(valid, s.dists, INF)
    key = torch.where(valid, acc, INF)
    idx = _stable_order(key, k)
    return queue.gather(s.ids.gather(1, idx)), queue.gather(key.gather(1, idx))


def distributed_search(corpus: ShardedCorpus, queries, cfg: SearchConfig,
                       metric: str = "l2", mode: str = "nsp", mesh=None,
                       data_axis: str = "data", queue_axis: str = "model",
                       bloom_bits: int = 1 << 17, num_hashes: int = 8):
    """DEPRECATED entry point, as in the reference: a ``plan.SearchRequest``
    over the mesh target through the ``Searcher`` facade, which calls
    ``distributed_search_kernel`` with the same arguments (so the results
    are the same)."""
    from repro_torch.plan import Searcher, SearchRequest
    from repro_torch.plan.searcher import warn_legacy

    warn_legacy("core.distributed_search")
    s = Searcher.open(corpus, cfg=cfg, metric=metric, mesh=mesh, mode=mode,
                      data_axis=data_axis, queue_axis=queue_axis,
                      bloom_bits=bloom_bits, num_hashes=num_hashes)
    return s.search(SearchRequest(queries=queries)).raw
