"""Proxima graph search — Algorithm 1 of the paper, ported from
``src/repro/core/search.py`` (``Corpus`` … ``_finalize_batch``, lines 50-437,
and the round-stepped API, lines 458-570).

Per traversal round, for every lane (query) of the batch at once:
  1. pop the E best unevaluated candidates (E = ``SearchConfig.beam_width``);
  2. fetch their E*R neighbours, dedup, Bloom-filter visited ones;
  3. PQ-distance the fresh ones through the lane's ADT;
  4. one (L + E*R) merge + stable sort, keep the top L;
  5. if the top-T entries are all evaluated: exact distances for them,
     early-termination check (r stable rounds), grow T by T_step.
Post-loop: beta-margin rerank, top-k by exact distance (Alg.1 l.19-22).

The lane axis is an explicit batch dimension (the reference vmaps) and the
loop is a Python loop over rounds (the reference's ``lax.while_loop``).  One
round is ``graph_search_step``: lanes that are done or at ``max_rounds`` pass
through unchanged, so extra rounds are no-ops and ``graph_search`` equals
stepping to quiescence.  ``graph_search`` asks the device whether any lane is
still active only every ``DONE_CHECK_EVERY`` rounds on CUDA — each check is
a host sync that drains the launch queue — and every round on the CPU,
where nothing runs ahead (PERF.md records the choice and its cost).

Routing by device mirrors the reference's ``use_pallas`` switch.  On CUDA the
ADTs, lookups, merge sort and exact distances launch the four kernels (the
reference's Pallas path, with a stable sort).  On the CPU the ADT is the
expanded form of ``core.pq.compute_adt`` (the reference's jnp path, which
rounds differently from the kernel), while lookup, sort and exact distances
take the kernels' plain versions, which compute exactly what the jnp path
computes.  The exact distances — the round's, for the entries that just
entered the top-T, and the beta-margin rerank's — come from
``ops.l2_rerank_masked`` in the direct form of ``exact_dist``, on both
devices: the kernel reads only the rows the mask asks for.

Filtered traversal (``node_mask``, the ``filter`` subsystem): an (N,) bool
pass mask restricts result admission, never routing — non-passing nodes
still enter the list and route, but only passing ones count for the
early-termination top-k, the beta-margin anchor (the T-th *passing*
candidate) and the final top-k, as in ``search.py:178-185``, ``:292-305`` and
``:389-408``.  The mask folds into the exact-distance mask, so no row that
fails the filter is read for an exact distance.  With an all-true mask every
selection reduces to the unfiltered arithmetic: the result is bit-identical
to ``node_mask=None``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import SearchConfig, upgrade_config
from repro_torch.core import bloom
from repro_torch.core.dataset import l2_normalize
from repro_torch.core.pq import compute_adt
from repro_torch.kernels import ops
from repro_torch.kernels.l2_rerank import exact_dist

INF = float("inf")
DONE_CHECK_EVERY = 4     # rounds between host checks of "any lane active"


class Corpus(NamedTuple):
    """Device-resident search structures (one NAND tile's worth), or the P
    tiles of a ``TiledCorpus`` stacked into one set of tables
    (``shard.search``'s batched fan-out): then lane p*Q + q searches query q
    in tile p, its ids stay tile-local, and ``lane_offset`` says where its
    tile's rows start in the stacked tables."""
    adjacency: torch.Tensor     # (N, R) int32 padded
    codes: torch.Tensor         # (N, M) uint8 PQ codes
    base: torch.Tensor          # (N, D) f32 raw vectors (rerank path)
    centroids: torch.Tensor     # (M, C, dsub) f32 PQ codebook
    entry_point: int            # stacked: (P*Q,) int32, one per lane
    hot_count: int              # ids < hot_count are "hot nodes";
                                # stacked: (P*Q, 1) int32
    lane_offset: torch.Tensor | None = None   # stacked: (P*Q, 1) int32


class SearchResult(NamedTuple):
    ids: torch.Tensor           # (Q, k) int32
    dists: torch.Tensor         # (Q, k) f32 accurate distances
    n_hops: torch.Tensor        # (Q,) expansions (index fetches)
    n_pq: torch.Tensor          # (Q,) PQ distance computations
    n_acc: torch.Tensor         # (Q,) accurate distance computations
    n_hot_hops: torch.Tensor    # (Q,) expansions that hit a hot node
    n_free_pq: torch.Tensor     # (Q,) PQ fetches covered by hot-node pages
    rounds: torch.Tensor        # (Q,) traversal rounds


class _State(NamedTuple):
    """Per-lane traversal state, lane axis first."""
    ids: torch.Tensor           # (Q, L) int32, -1 padding, sorted by dist
    dists: torch.Tensor         # (Q, L) f32 traversal (PQ) distances
    acc: torch.Tensor           # (Q, L) f32 accurate distances, +inf unknown
    evaluated: torch.Tensor     # (Q, L) bool
    bits: torch.Tensor          # (Q, W + 1) bool Bloom filter (core.bloom)
    t: torch.Tensor             # (Q,) int32 dynamic list size
    prev_topk: torch.Tensor     # (Q, k) int32 last reranked top-k (sorted)
    stable: torch.Tensor        # (Q,) int32 consecutive stable rounds
    done: torch.Tensor          # (Q,) bool
    n_hops: torch.Tensor
    n_pq: torch.Tensor
    n_acc: torch.Tensor
    n_hot: torch.Tensor
    n_free: torch.Tensor
    rounds: torch.Tensor


class SearchState(NamedTuple):
    """Mid-traversal snapshot of a batch of lanes: metric-normalized
    queries, their ADTs ((Q, 1, 1) when ``use_pq`` is off) and the lanes."""
    queries: torch.Tensor
    adts: torch.Tensor
    lanes: _State


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def empty_search_result(nq: int, k: int, device="cuda") -> SearchResult:
    """A no-work result batch: -1 ids, +inf distances, zeroed counters."""
    z = torch.zeros((nq,), dtype=torch.int32, device=device)
    return SearchResult(
        ids=torch.full((nq, k), -1, dtype=torch.int32, device=device),
        dists=torch.full((nq, k), INF, device=device),
        n_hops=z, n_pq=z, n_acc=z, n_hot_hops=z, n_free_pq=z, rounds=z,
    )


def _dedup_round(neighbors: torch.Tensor) -> torch.Tensor:
    """(Q, n) -> (Q, n) bool: False on a repeat of an earlier entry."""
    n = neighbors.shape[1]
    eq = neighbors[:, None, :] == neighbors[:, :, None]
    lower = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                  device=neighbors.device), diagonal=-1)
    return ~(eq & lower).any(dim=2)


def _stable_order(key: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices of each row's k smallest keys, ties lower column
    first — what the reference gets from ``lax.top_k(-key)``."""
    return torch.sort(key, dim=1, stable=True).indices[:, :k]


def _topk_ids_by(ids, key, k):
    """ids of the k smallest keys, returned sorted by id for set comparison."""
    return torch.sort(ids.gather(1, _stable_order(key, k)), dim=1).values


def _passes_of(ids: torch.Tensor, node_mask) -> torch.Tensor:
    """Valid AND mask-passing, elementwise (-1 slots never pass); with
    ``node_mask=None`` plain validity, the unfiltered path."""
    valid = ids >= 0
    if node_mask is None:
        return valid
    return valid & node_mask[ids.clamp(min=0).long()]


def _rows(corpus: Corpus, ids: torch.Tensor) -> torch.Tensor:
    """Table rows of (lanes, n) lane-local ids: the ids themselves, or in a
    stacked corpus the ids plus their lane's tile offset, -1 padding kept
    -1 (the kernels' id checks must still see it)."""
    off = corpus.lane_offset
    return ids if off is None else torch.where(ids >= 0, ids + off, -1)


def _mask_on(corpus: Corpus, node_mask):
    """The (N,) pass mask as a bool tensor on the corpus's device."""
    if node_mask is None:
        return None
    return torch.as_tensor(node_mask, dtype=torch.bool,
                           device=corpus.base.device)


def _build_adts(corpus: Corpus, queries: torch.Tensor, cfg: SearchConfig,
                metric: str) -> torch.Tensor:
    """(Q, M, C) ADTs: the pq_adt kernel on CUDA, the expanded jnp-path form
    on the CPU."""
    if not cfg.use_pq:
        return torch.zeros((queries.shape[0], 1, 1), device=queries.device)
    if queries.is_cuda:
        return ops.pq_adt(queries, corpus.centroids, metric)
    return compute_adt(queries, corpus.centroids, metric)


def _round_fns(corpus: Corpus, cfg: SearchConfig, metric: str,
               bloom_bits: int, num_hashes: int, node_mask=None):
    """THE traversal round: returns ``(init, active, step)`` over a batch of
    lanes.  ``graph_search`` and ``graph_search_step`` both apply ``step``,
    which is what makes them agree exactly.  ``node_mask`` is None or an
    (N,) bool tensor on the corpus's device."""
    cfg = upgrade_config(cfg)
    L, k = cfg.list_size, cfg.k
    R = corpus.adjacency.shape[1]
    # beam wider than the candidate list can never pop more than L entries
    E = min(max(int(cfg.beam_width), 1), L)
    use_pq, do_et = cfg.use_pq, cfg.early_termination
    t_init = cfg.t_init if do_et else L
    t_step = cfg.t_step if do_et else L
    dev = corpus.base.device
    i32 = torch.int32

    def tdist(q, adts, ids, mask=None):
        """Traversal distances of (Q, n) ids; +inf where ``mask`` is False
        (the lookup kernel then reads nothing for them)."""
        rows = _rows(corpus, ids)
        if use_pq:
            return ops.pq_lookup_gather(rows, corpus.codes, adts, mask)
        d = exact_dist(q, corpus.base[rows.long()], metric)
        return d if mask is None else torch.where(mask, d, INF)

    def init(q, adts) -> _State:
        nq = q.shape[0]
        if corpus.lane_offset is None:
            ep = torch.full((nq, 1), corpus.entry_point, dtype=i32,
                            device=dev)
        else:
            ep = corpus.entry_point.reshape(nq, 1)
        d0 = tdist(q, adts, ep)[:, 0]
        ids0 = torch.full((nq, L), -1, dtype=i32, device=dev)
        ids0[:, 0] = ep[:, 0]
        dists0 = torch.full((nq, L), INF, device=dev)
        dists0[:, 0] = d0
        acc0 = torch.full((nq, L), INF, device=dev)
        if not use_pq:
            acc0[:, 0] = d0
        bits0 = bloom.bloom_init(bloom_bits, nq, dev)
        bloom.insert(bits0, ep, torch.ones_like(ep, dtype=torch.bool),
                     num_hashes)
        zero = torch.zeros((nq,), dtype=i32, device=dev)
        return _State(
            ids=ids0, dists=dists0, acc=acc0,
            evaluated=torch.zeros((nq, L), dtype=torch.bool, device=dev),
            bits=bits0, t=torch.full_like(zero, min(t_init, L)),
            prev_topk=torch.full((nq, k), -2, dtype=i32, device=dev),
            stable=zero, done=torch.zeros_like(zero, dtype=torch.bool),
            n_hops=zero, n_pq=torch.full_like(zero, 1 if use_pq else 0),
            n_acc=torch.full_like(zero, 0 if use_pq else 1),
            n_hot=zero, n_free=zero, rounds=zero,
        )

    def active(s: _State) -> torch.Tensor:
        return ~s.done & (s.rounds < cfg.max_rounds)

    ar_e = torch.arange(E, device=dev)
    ar_l = torch.arange(L, device=dev)

    def step(q, adts, s: _State) -> _State:
        """One guarded round.  ``s.bits`` is updated in place (only for
        active lanes): the old state must not be stepped again."""
        live = active(s)
        nq = s.ids.shape[0]
        valid = s.ids >= 0
        unev = valid & ~s.evaluated
        n_unev = unev.sum(1, dtype=i32)
        has_unev = n_unev > 0
        # the E best unevaluated entries in list (distance) order: a stable
        # sort of ~unev floats them to the front; E == 1 is the first max
        if E == 1:
            sel = unev.to(i32).argmax(1, keepdim=True)
        else:
            sel = torch.sort((~unev).to(i32), dim=1, stable=True).indices[:, :E]
        sel_valid = ar_e[None, :] < n_unev[:, None]                 # (Q, E)
        vs = torch.where(sel_valid, s.ids.gather(1, sel), 0)        # (Q, E)

        # ---- expand the beam: one E-row adjacency gather ---------------
        neigh = corpus.adjacency[_rows(corpus, vs).long()].reshape(nq, E * R)
        fresh = (_dedup_round(neigh)
                 & ~bloom.contains(s.bits, neigh, num_hashes)
                 & sel_valid.repeat_interleave(R, dim=1))
        nd = tdist(q, adts, neigh, fresh)
        bloom.insert(s.bits, neigh, fresh & live[:, None], num_hashes)
        evaluated = s.evaluated.scatter(1, sel,
                                        s.evaluated.gather(1, sel) | sel_valid)
        n_new = fresh.sum(1, dtype=i32)
        is_hot = (vs < corpus.hot_count) & sel_valid                 # (Q, E)
        # L existing + E*R new candidates, stable-sorted by dist, top L
        ids, dists, acc, evaluated = ops.bitonic_merge_topl(
            s.ids, s.dists, s.acc, evaluated,
            torch.where(fresh, neigh, -1), nd)

        # ---- top-T evaluated? -> rerank + early-termination ------------
        valid = ids >= 0
        in_t = (ar_l[None, :] < s.t[:, None]) & valid
        all_eval = in_t.any(1) & (~in_t | evaluated).all(1)
        # only passing candidates are admitted to the reranked top-k (in_t
        # implies valid, so without a mask in_t_pl is in_t)
        in_t_pl = in_t if node_mask is None \
            else in_t & _passes_of(ids, node_mask)
        # exact distances for the admitted top-T entries that have none yet,
        # once the top-T is all evaluated; an inactive lane's result is
        # dropped below, so none of its rows is read
        need = in_t_pl & torch.isinf(acc) & (all_eval & live)[:, None]
        n_acc_new = need.sum(1, dtype=i32)
        if use_pq:
            acc2 = ops.l2_rerank_masked(q, _rows(corpus, ids), corpus.base,
                                        acc, need, metric)
        else:
            acc2 = torch.where(valid, dists, INF)
        rerank_key = torch.where(in_t_pl, acc2, INF)
        new_topk = _topk_ids_by(ids, rerank_key, k)
        same = (new_topk == s.prev_topk).all(1)
        stable = torch.where(all_eval, torch.where(same, s.stable + 1, 1),
                             s.stable)
        prev_topk = torch.where(all_eval[:, None], new_topk, s.prev_topk)
        t = torch.where(all_eval, s.t + t_step, s.t)

        terminated = all_eval & (stable >= cfg.repetition_rate) & do_et
        done = terminated | ~has_unev | (t > L)

        hot_new = (fresh.reshape(nq, E, R) & is_hot[:, :, None]).sum(
            (1, 2), dtype=i32)
        new = _State(
            ids=ids, dists=dists, acc=acc2, evaluated=evaluated, bits=s.bits,
            t=torch.clamp(t, max=L), prev_topk=prev_topk, stable=stable,
            done=done,
            n_hops=s.n_hops + torch.clamp(n_unev, max=E),
            n_pq=s.n_pq + (n_new if use_pq else 0),
            n_acc=s.n_acc + n_acc_new + (0 if use_pq else n_new),
            n_hot=s.n_hot + is_hot.sum(1, dtype=i32),
            n_free=s.n_free + hot_new,
            rounds=s.rounds + 1,
        )
        # inactive lanes keep their state
        return _State(*(
            b if b is a else torch.where(
                live.reshape((nq,) + (1,) * (b.dim() - 1)), b, a)
            for a, b in zip(s, new)
        ))

    return init, active, step


def _finalize_batch(corpus: Corpus, cfg: SearchConfig, metric: str,
                    node_mask, queries: torch.Tensor,
                    s: _State) -> SearchResult:
    """Post-loop beta-margin rerank + top-k (Alg.1 l.19-22): the margin's
    exact distances come from ``ops.l2_rerank_masked``, which reads only the
    rows the margin asks for (passing rows only, under a filter)."""
    L, k = cfg.list_size, cfg.k
    valid = s.ids >= 0
    pass_l = _passes_of(s.ids, node_mask)
    if node_mask is None:
        t_idx = (torch.clamp(s.t, 1, L) - 1).long()
        d_t = s.dists.gather(1, t_idx[:, None])[:, 0]
        thr = d_t + (cfg.beta - 1.0) * torch.abs(d_t)        # sign-safe margin
    else:
        # margin anchor = the T-th PASSING candidate's distance; with an
        # all-true mask that is position T-1 (or the +inf padding), the
        # unfiltered read above
        rank = torch.cumsum(pass_l, dim=1, dtype=torch.int32)
        tt = torch.clamp(s.t, 1, L)
        is_t = pass_l & (rank == tt[:, None])
        d_t = torch.where(is_t, s.dists, -INF).amax(1)
        d_t = torch.where(rank[:, -1] >= tt, d_t, INF)
        # inf anchor (fewer than T passing): rerank every passing candidate
        # — guarded, since beta == 1.0 would make inf + 0*inf a NaN
        thr = torch.where(torch.isinf(d_t), INF,
                          d_t + (cfg.beta - 1.0) * torch.abs(d_t))
    if cfg.use_pq and cfg.rerank:
        need = pass_l & (s.dists <= thr[:, None]) & torch.isinf(s.acc)
        acc = ops.l2_rerank_masked(queries, _rows(corpus, s.ids),
                                   corpus.base, s.acc, need, metric)
        n_acc = s.n_acc + need.sum(1, dtype=torch.int32)
    else:
        # no rerank (rank by PQ) / accurate traversal (dists are accurate)
        acc = torch.where(valid, s.dists, INF)
        n_acc = s.n_acc
    key = torch.where(pass_l, acc, INF)
    idx = _stable_order(key, k)
    out_ids, out_d = s.ids.gather(1, idx), key.gather(1, idx)
    if node_mask is not None:
        # a filter can leave fewer than k admissible candidates: such slots
        # carry +inf keys and come back as explicit -1 padding
        out_ids = torch.where(torch.isinf(out_d), -1, out_ids)
    return SearchResult(
        ids=out_ids, dists=out_d, n_hops=s.n_hops,
        n_pq=s.n_pq, n_acc=n_acc, n_hot_hops=s.n_hot, n_free_pq=s.n_free,
        rounds=s.rounds,
    )


def queries_to(queries, device, dim: int) -> torch.Tensor:
    """(Q, dim) float32 queries on ``device``, in memory of their own: the
    round step and the slot pools write into the state's query rows, which
    must never be the caller's array."""
    if isinstance(queries, torch.Tensor):
        q = queries.to(device=device, dtype=torch.float32, copy=True)
    else:
        q = torch.tensor(np.asarray(queries), dtype=torch.float32,
                         device=device)
    return q.reshape(-1, dim).contiguous()


def _queries_on(corpus: Corpus, queries) -> torch.Tensor:
    return queries_to(queries, corpus.base.device, corpus.base.shape[1])


def init_search_state(corpus: Corpus, queries, cfg: SearchConfig,
                      metric: str = "l2", bloom_bits: int = 1 << 17,
                      num_hashes: int = 8, node_mask=None) -> SearchState:
    """Round 0 for a (Q, D) query batch: normalize, build ADTs, seed every
    lane at the entry point.  Over a stacked corpus of P tiles the ADTs are
    built once per query and the lanes are P*Q: lane p*Q + q takes query q
    and its ADT.  ``node_mask`` only matters in later rounds but is
    accepted here for signature symmetry."""
    q = _queries_on(corpus, queries)
    if metric == "angular":
        q = l2_normalize(q)
    adts = _build_adts(corpus, q, cfg, metric)
    if corpus.lane_offset is not None:
        tiles = corpus.lane_offset.shape[0] // q.shape[0]
        q, adts = q.repeat(tiles, 1), adts.repeat(tiles, 1, 1)
    init, _, _ = _round_fns(corpus, cfg, metric, bloom_bits, num_hashes)
    return SearchState(queries=q, adts=adts, lanes=init(q, adts))


def graph_search_step(corpus: Corpus, state: SearchState, cfg: SearchConfig,
                      metric: str = "l2", bloom_bits: int = 1 << 17,
                      num_hashes: int = 8, node_mask=None) -> SearchState:
    """ONE traversal round over every lane.  Inactive lanes — done, or at
    ``max_rounds`` — pass through unchanged.  The Bloom bits of ``state``
    are updated in place, so ``state`` itself must not be stepped again."""
    _, _, step = _round_fns(corpus, cfg, metric, bloom_bits, num_hashes,
                            _mask_on(corpus, node_mask))
    return state._replace(lanes=step(state.queries, state.adts, state.lanes))


def search_state_active(state: SearchState, cfg: SearchConfig) -> torch.Tensor:
    """(Q,) bool — lanes that still have rounds to run."""
    return ~state.lanes.done & (state.lanes.rounds < cfg.max_rounds)


def finalize_search(corpus: Corpus, state: SearchState, cfg: SearchConfig,
                    metric: str = "l2", node_mask=None) -> SearchResult:
    """Post-traversal beta-margin rerank + top-k over quiesced lanes."""
    return _finalize_batch(corpus, upgrade_config(cfg), metric,
                           _mask_on(corpus, node_mask), state.queries,
                           state.lanes)


def graph_search_stepped(corpus: Corpus, queries, cfg: SearchConfig,
                         metric: str = "l2", bloom_bits: int = 1 << 17,
                         num_hashes: int = 8, node_mask=None) -> SearchResult:
    """Host-side driver: one ``graph_search_step`` at a time, asking after
    each whether any lane is active, then finalize.  Equal to
    ``graph_search``."""
    node_mask = _mask_on(corpus, node_mask)
    state = init_search_state(corpus, queries, cfg, metric, bloom_bits,
                              num_hashes)
    while bool(search_state_active(state, cfg).any()):
        state = graph_search_step(corpus, state, cfg, metric, bloom_bits,
                                  num_hashes, node_mask)
    return finalize_search(corpus, state, cfg, metric, node_mask)


def graph_search(corpus: Corpus, queries, cfg: SearchConfig,
                 metric: str = "l2", bloom_bits: int = 1 << 17,
                 num_hashes: int = 8, node_mask=None) -> SearchResult:
    """Batched Proxima traversal. queries: (Q, D) array or tensor; the search
    runs on the corpus's device.  Steps every lane to quiescence, checking
    for it every ``DONE_CHECK_EVERY`` rounds on CUDA (extra rounds are
    no-ops), then runs the beta-margin rerank.  ``node_mask`` (N,) bool, if
    given, admits only passing nodes to the result (filtered search)."""
    node_mask = _mask_on(corpus, node_mask)
    state = init_search_state(corpus, queries, cfg, metric, bloom_bits,
                              num_hashes)
    _, active, step = _round_fns(corpus, cfg, metric, bloom_bits, num_hashes,
                                 node_mask)
    every = DONE_CHECK_EVERY if state.queries.is_cuda else 1
    lanes = state.lanes
    while bool(active(lanes).any()):
        for _ in range(every):
            lanes = step(state.queries, state.adts, lanes)
    return _finalize_batch(corpus, upgrade_config(cfg), metric, node_mask,
                           state.queries, lanes)


# ---------------------------------------------------------------------------
# Reference traversal (direct Algorithm-1 transliteration) — the oracle
# ---------------------------------------------------------------------------

def search_reference(adjacency, degrees, codes, base, centroids, entry: int,
                     query, cfg: SearchConfig, metric: str = "l2",
                     hot_count: int = 0, trace=None, node_mask=None):
    """Single-query Python loop of Algorithm 1 with an exact visited set (no
    Bloom false positives) — port of the reference's ``search_reference``
    (``src/repro/core/search.py:633-788``).  Returns (ids, dists, counters)
    as numpy arrays and a dict.

    The graph (``adjacency``, ``degrees``) is walked on the host; the
    distances run on the device of ``base`` (``codes``, ``centroids`` and
    ``query`` are moved there): the ADT from ``compute_adt`` on the CPU and
    the ``pq_adt`` kernel on CUDA, as ``graph_search`` builds it; each
    round's PQ distances from ``ops.pq_lookup_gather`` and every exact
    distance from ``ops.l2_rerank_masked``.  Angular: ``base`` rows must be
    unit-normalized (the reference normalizes each fetched slice, which is
    idempotent on such rows); the query is normalized here.

    Honours ``cfg.beam_width``: each round pops the E best unevaluated
    candidates and expands them together, deduplicating the combined
    neighbour set in beam order (first occurrence wins).  ``trace`` (an
    (N,) int64 numpy array), if given, accumulates expansion counts (the
    visit-frequency histogram of the reordering, §IV-E).  ``node_mask``
    (N,) bool: non-passing nodes route but are excluded from the reranked
    top-k, the beta-margin anchor (T-th passing candidate) and the
    results."""
    adjacency = np.asarray(adjacency)
    degrees = np.asarray(degrees)
    base = torch.as_tensor(base)
    dev = base.device
    codes = torch.as_tensor(codes, device=dev)
    centroids = torch.as_tensor(centroids, device=dev)
    q = torch.as_tensor(query, dtype=torch.float32, device=dev).reshape(1, -1)
    if metric == "angular":
        q = l2_normalize(q)
    cfg = upgrade_config(cfg)
    if cfg.use_pq:
        adt = ops.pq_adt(q, centroids, metric) if q.is_cuda \
            else compute_adt(q, centroids, metric)

    def _ids(ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int32), device=dev)[None]

    def adist(ids) -> list:
        t = _ids(ids)
        return ops.l2_rerank_masked(
            q, t, base, torch.full(t.shape, INF, device=dev),
            torch.ones(t.shape, dtype=torch.bool, device=dev),
            metric)[0].tolist()

    def tdist(ids) -> list:
        if cfg.use_pq:
            return ops.pq_lookup_gather(_ids(ids), codes, adt)[0].tolist()
        return adist(ids)

    L, k = cfg.list_size, cfg.k
    E = max(int(cfg.beam_width), 1)

    def _pass(u: int) -> bool:
        return node_mask is None or bool(node_mask[u])

    counters = {"hops": 0, "pq": 0, "acc": 0, "hot": 0, "free": 0, "rounds": 0}
    d0 = tdist([entry])[0]
    counters["pq" if cfg.use_pq else "acc"] += 1
    lst = [(d0, int(entry))]        # sorted (dist, id)
    visited = {int(entry)}
    evaluated = set()
    acc_cache = {}
    t = cfg.t_init if cfg.early_termination else L
    t_step = cfg.t_step if cfg.early_termination else L
    prev_topk = None
    stable = 0
    while counters["rounds"] < cfg.max_rounds:
        counters["rounds"] += 1
        unev = [(d, v) for d, v in lst if v not in evaluated]
        if not unev:
            break
        beam = [v for _, v in unev[:E]]           # E best unevaluated
        fresh: list = []                          # beam-order, deduped
        fresh_owner_hot: list = []
        for v in beam:
            evaluated.add(v)
            counters["hops"] += 1
            if trace is not None:
                trace[v] += 1
            is_hot = v < hot_count
            if is_hot:
                counters["hot"] += 1
            neigh = [int(u) for u in adjacency[v, : degrees[v]]]
            for u in dict.fromkeys(neigh):
                if u not in visited:
                    visited.add(u)                # first occurrence owns u
                    fresh.append(u)
                    fresh_owner_hot.append(is_hot)
        if fresh:
            nd = tdist(fresh)
            counters["pq" if cfg.use_pq else "acc"] += len(fresh)
            counters["free"] += sum(fresh_owner_hot)
            for u, du in zip(fresh, nd):
                lst.append((du, u))
            lst.sort(key=lambda x: (x[0], ))
            lst = lst[:L]
        top_t = lst[: min(t, len(lst))]
        if top_t and all(v2 in evaluated for _, v2 in top_t):
            # only mask-passing candidates are admitted to the reranked
            # top-k (non-passing ones still route the traversal)
            ids_t = [v2 for _, v2 in top_t if _pass(v2)]
            new = [u for u in ids_t if u not in acc_cache]
            if cfg.use_pq and new:
                for u, du in zip(new, adist(new)):
                    acc_cache[u] = du
                counters["acc"] += len(new)
            if not cfg.use_pq:
                for dd, u in top_t:
                    if _pass(u):
                        acc_cache[u] = dd
            topk = tuple(sorted(sorted(ids_t, key=lambda u: acc_cache[u])[:k]))
            if topk == prev_topk:
                stable += 1
            else:
                stable = 1
            prev_topk = topk
            if cfg.early_termination and stable >= cfg.repetition_rate:
                break
            t += t_step
            if t > L:
                break
    # final beta rerank (filtered: margin anchored at the T-th PASSING entry)
    if node_mask is None:
        t_idx = min(max(t, 1), len(lst)) - 1
        d_t = lst[t_idx][0]
        thr = d_t + (cfg.beta - 1.0) * abs(d_t)
    else:
        pass_list = [d for d, u in lst if _pass(u)]
        tt = max(t, 1)
        d_t = pass_list[tt - 1] if len(pass_list) >= tt else np.inf
        # the beta == 1.0 NaN guard of the masked anchor
        thr = np.inf if np.isinf(d_t) else d_t + (cfg.beta - 1.0) * abs(d_t)
    if cfg.use_pq and cfg.rerank:
        need = [u for d, u in lst
                if d <= thr and _pass(u) and u not in acc_cache]
        if need:
            for u, du in zip(need, adist(need)):
                acc_cache[u] = du
            counters["acc"] += len(need)
        scored = sorted(((u, d) for u, d in acc_cache.items() if _pass(u)),
                        key=lambda kv: kv[1])
    else:
        scored = sorted(((u, d) for d, u in lst if _pass(u)),
                        key=lambda kv: kv[1])
    ids = np.asarray([u for u, _ in scored[:k]], dtype=np.int32)
    ds = np.asarray([d for _, d in scored[:k]], dtype=np.float32)
    if len(ids) < k:
        ids = np.pad(ids, (0, k - len(ids)), constant_values=-1)
        ds = np.pad(ds, (0, k - len(ds)), constant_values=np.inf)
    return ids, ds, counters
