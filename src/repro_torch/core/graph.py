"""Proximity-graph construction — port of ``build_knn_prune`` of
``src/repro/core/graph.py`` (lines 47-232), batched on the device.

The rule is the reference's, step for step:
  1. exact kNN lists (self excluded), ascending by (distance, id);
  2. the Vamana RRND robust prune of every list (alpha slack, R kept);
  3. reverse edges: each row gets the nodes that kept it, in ascending id,
     after its own kept entries; rows longer than R are pruned again over
     their merged list;
  4. the medoid of a 4096-point sample as entry point;
  5. NSG-style connectivity repair: while some node is unreachable from the
     entry, stitch the orphan closest to the dataset centroid to its nearest
     reached node with a free or unprotected slot, both ways; stitch edges
     are protected and never evicted;
  6. rows deduplicated, self-loops dropped, padded to R with the last entry.

The reference runs steps 2-3 as a Python loop over nodes and step 5 as a
Python BFS per orphan component, which takes hours at 1M vectors.  Here the
kNN is a chunked full-float32 ``torch.matmul`` with a stable top-k; the prune
runs for a chunk of nodes at once — a loop over candidate positions with
each node's K x K candidate distances in one batched product; re-prunes are
grouped by merged-list size; reachability is a BFS over the device
adjacency.  A build list longer than ``_LONG_LIST`` (the segments' 4x list,
or ~N/4 under the tile partitioner's k // 4 floor) is never held whole:
``_knn_prune_windows`` walks each node's sorted candidates a window at a
time, keeps one node per step, and stops once r are kept — the same rule
over the same order.  Distances round differently from
numpy's, so a near-tie can resolve the other way; on the test corpus the
rows agree (PERF.md).

``build_incremental`` (the faithful Vamana: points inserted one at a time,
greedy-searched from the medoid, the visited set robust-pruned, reverse
edges re-pruned on overflow) and its two helpers, ``_greedy_search_np`` and
the one-node ``robust_prune``, are the reference's numpy, copied as they
are (``heapq`` order and stable sorts included): they run on the host for
any device, and ``stream.delta`` builds on them.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import GraphConfig
from repro_torch.core.dataset import (
    full_precision, l2_normalize, pairwise_dist, pairwise_dist_torch,
    sorted_smallest,
)

# elements of a chunk's largest temporary: the (rows, N) kNN distance block,
# or the (nodes, K, K + D) candidate block of the prune — 1 GiB of float32
_CHUNK_ELEMS = 1 << 28
# Build lists longer than _LONG_LIST (the segments' and tiles' compensated
# lists: 512 at 4 segments, ~N/4 under the tile partitioner's floor) take the
# windowed kNN + prune: the batched prune holds K x K distances per node, and
# its chunks of nodes shrink with K^2.  It fetches sorted candidates _FETCH
# at first and 4x more each time after (to the nodes that have not kept R
# yet), prunes them _WINDOW at a time, and stops a chunk once its nodes have
# kept R or spent their lists.  On the smoke's corpus a tile
# graph from a 512-long list and one from the floor's 62,500-long list search
# alike (scripts/tile_graph_recall.py, PERF.md).
_LONG_LIST = 256
_FETCH = 512
_WINDOW = 1024


@dataclass
class Graph:
    adjacency: np.ndarray   # (N, R) int32, padded
    degrees: np.ndarray     # (N,) int32 true degrees
    entry_point: int
    metric: str

    @property
    def num_vertices(self) -> int:
        return self.adjacency.shape[0]

    @property
    def max_degree(self) -> int:
        return self.adjacency.shape[1]


def compensated_build_cfg(cfg: GraphConfig, factor: int, n: int,
                          floor: int = 0) -> GraphConfig:
    """The density-compensation rule of the reference (``graph.py:64-86``),
    shared by the tile partitioner, the segmented builder and the stitcher:
    a graph built over a 1/``factor`` sample of every cluster sees
    intra-cluster gaps grow by ~``factor``, so the build neighbourhood is
    scaled by ``factor`` (with an optional ``floor``, capped at n - 1)."""
    if factor <= 1 and floor <= 0:
        return cfg
    return dataclasses.replace(
        cfg,
        build_list_size=min(
            max(cfg.build_list_size * max(factor, 1), floor),
            max(n - 1, 1),
        ),
    )


def medoid(base: np.ndarray, metric: str, sample: int = 4096, seed: int = 0) -> int:
    """The reference's medoid, in numpy: same sample, same arithmetic."""
    rng = np.random.default_rng(seed)
    n = base.shape[0]
    idx = rng.choice(n, size=min(sample, n), replace=False)
    centroid = base.mean(0, keepdims=True)
    d = pairwise_dist(centroid, base[idx], metric)[0]
    return int(idx[np.argmin(d)])


def robust_prune(cand_ids: np.ndarray, cand_dists: np.ndarray,
                 base: np.ndarray, metric: str, r: int, alpha: float) -> list:
    """Vamana RRND rule for one node (the reference's numpy): greedily keep
    the closest candidate p, discard any remaining candidate x with
    alpha * dist(p, x) <= dist(query, x)."""
    order = np.argsort(cand_dists, kind="stable")
    ids = cand_ids[order]
    dists = cand_dists[order]
    kept: list = []
    alive = np.ones(len(ids), dtype=bool)
    for i in range(len(ids)):
        if not alive[i]:
            continue
        p = int(ids[i])
        kept.append(p)
        if len(kept) >= r:
            break
        rest = np.where(alive)[0]
        rest = rest[rest > i]
        if rest.size:
            d_p = pairwise_dist(base[p : p + 1], base[ids[rest]], metric)[0]
            alive[rest[alpha * d_p <= dists[rest]]] = False
    return kept


def _pad_rows_np(rows, r, n):
    """The reference's row padding in numpy: rows deduplicated, self-loops
    dropped, an empty row given node (i + 1) % n, padded with the last
    entry."""
    adj = np.empty((n, r), dtype=np.int32)
    deg = np.empty((n,), dtype=np.int32)
    for i, row in enumerate(rows):
        row = list(dict.fromkeys(int(v) for v in row if v != i))[:r]
        if not row:
            row = [(i + 1) % n]
        deg[i] = len(row)
        adj[i, : len(row)] = row
        adj[i, len(row):] = row[-1]
    return adj, deg


def _compact(rows: torch.Tensor, keep: torch.Tensor, width: int) -> torch.Tensor:
    """Move each row's kept entries to the front, in order; -1 after them;
    cut to ``width`` columns."""
    pos = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    pos = pos[:, :width]
    return torch.where(keep.gather(1, pos), rows.gather(1, pos), -1)


def knn_lists(base: torch.Tensor, k: int, metric: str):
    """(N, k) int64 ids and float32 distances of each point's k nearest
    other points, ascending by (distance, id)."""
    n = base.shape[0]
    x2 = (base * base).sum(-1) if metric == "l2" else None
    chunk = max(1, _CHUNK_ELEMS // n)
    ids, dists = [], []
    for s in range(0, n, chunk):
        d = pairwise_dist_torch(base[s : s + chunk], base, metric, x2)
        r = torch.arange(d.shape[0], device=base.device)
        d[r, s + r] = float("inf")                       # exclude self
        v, i = sorted_smallest(d, k)
        ids.append(i)
        dists.append(v)
    return torch.cat(ids), torch.cat(dists)


def robust_prune_batch(cand: torch.Tensor, cand_d: torch.Tensor,
                       base: torch.Tensor, metric: str, r: int,
                       alpha: float) -> torch.Tensor:
    """The Vamana RRND rule for a batch of nodes at once.

    cand (B, K) int64 candidate ids (-1 padding), cand_d (B, K) their
    distances to the node (+inf padding) -> (B, r) kept ids in keep order,
    -1 padded.  Per node, exactly the reference's ``robust_prune``: walk the
    candidates by (distance, position); keep each survivor p, stop at r kept,
    else drop every later survivor x with alpha * d(p, x) <= d(node, x)."""
    order = torch.sort(cand_d, dim=1, stable=True).indices
    ids = cand.gather(1, order)
    d = cand_d.gather(1, order)
    x = base[ids.clamp(min=0)]                                 # (B, K, D)
    if metric == "l2":
        x2 = (x * x).sum(-1)
        pd = x2[:, :, None] + x2[:, None, :] - 2.0 * torch.bmm(
            x, x.transpose(1, 2))
    else:
        if metric == "angular":
            x = l2_normalize(x)
        pd = -torch.bmm(x, x.transpose(1, 2))
    b, k = ids.shape
    alive = ids >= 0
    live = torch.ones(b, dtype=torch.bool, device=ids.device)
    count = torch.zeros(b, dtype=torch.int32, device=ids.device)
    kept = torch.zeros_like(alive)
    later = torch.arange(k, device=ids.device)
    for j in range(k):
        # every 64 positions: stop once no node can keep anything more
        if j and j % 64 == 0 and not bool((live[:, None]
                                           & alive[:, j:]).any()):
            break
        keep_j = alive[:, j] & live
        kept[:, j] = keep_j
        count += keep_j
        stop = keep_j & (count >= r)
        live &= ~stop
        kill = ((keep_j & ~stop)[:, None] & (alpha * pd[:, j, :] <= d)
                & (later > j)[None, :])
        alive &= ~kill
    return _compact(ids, kept, r)


def _prune_chunks(nodes: torch.Tensor, cand: torch.Tensor, cand_d, base,
                  metric, r, alpha) -> torch.Tensor:
    width = cand.shape[1]
    step = max(1, _CHUNK_ELEMS // (width * (width + base.shape[1])))
    return torch.cat([
        robust_prune_batch(cand[s : s + step], cand_d[s : s + step], base,
                           metric, r, alpha)
        for s in range(0, nodes.shape[0], step)
    ]) if nodes.numel() else cand.new_empty((0, r))


def _knn_prune_windows(base: torch.Tensor, k: int, metric: str, r: int,
                       alpha: float) -> torch.Tensor:
    """kNN lists of length ``k`` and their robust prune in one pass, for
    build lists too long to hold (N x k): a chunk of nodes takes its
    candidates in (distance, id) order, fetched in growing batches for the
    nodes that have not kept r yet, prunes them ``_WINDOW`` at a time, and
    stops as soon as every node of the chunk has r kept or its k candidates
    are spent.  Per node, exactly
    ``robust_prune_batch`` over the full sorted list: a window's candidates
    are first tested against the nodes already kept (the kill rule is per
    pair, so order does not matter); within the window the first live
    candidate is kept and kills the later ones, one kept node per step.
    Pair distances are the prune's expanded form.  -> (N, r) kept ids, -1
    padded."""
    n = base.shape[0]
    dev = base.device
    x2 = (base * base).sum(-1) if metric == "l2" else None
    unit = l2_normalize(base) if metric == "angular" else base
    sq = (unit * unit).sum(-1)                       # the prune's norms
    chunk = max(1, _CHUNK_ELEMS // n)
    out = []

    def pair(a, a_sq, x, xs):
        """(b, m, D) rows x (b, w, D) rows -> (b, m, w)."""
        dot = torch.bmm(a, x.transpose(1, 2))
        if metric == "l2":
            return a_sq[:, :, None] + xs[:, None, :] - 2.0 * dot
        return -dot

    for s in range(0, n, chunk):
        d = pairwise_dist_torch(base[s : s + chunk], base, metric, x2)
        b = d.shape[0]
        ar = torch.arange(b, device=dev)
        d[ar, s + ar] = float("inf")                      # exclude self
        chunk_kept = torch.full((b, r), -1, dtype=torch.long, device=dev)
        rows = ar                        # the chunk's nodes still walking
        kept = chunk_kept.clone()
        count = torch.zeros(b, dtype=torch.long, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        taken, fetch = 0, _FETCH
        while True:
            f = min(fetch, k - taken)
            v_f, i_f = sorted_smallest(d, f)              # next in order
            d.scatter_(1, i_f, float("inf"))
            taken, fetch = taken + f, 4 * fetch
            for w0 in range(0, f, _WINDOW):
                if w0 and bool(done.all()):
                    break
                v, i = v_f[:, w0 : w0 + _WINDOW], i_f[:, w0 : w0 + _WINDOW]
                w = v.shape[1]
                x, xs = unit[i], sq[i]                    # (b, w, D), (b, w)
                alive = ~done[:, None].expand(b, w).clone()
                if bool((count > 0).any()):
                    kc = kept.clamp(min=0)
                    dk = pair(unit[kc], sq[kc], x, xs)
                    alive &= ~((alpha * dk <= v[:, None, :])
                               & (kept >= 0)[:, :, None]).any(1)
                while True:
                    has = alive.any(1)
                    if not bool(has.any()):
                        break
                    j = alive.to(torch.int8).argmax(1)    # first live one
                    p = i[ar, j]
                    kept[ar[has], count[has]] = p[has]
                    count += has
                    done |= count >= r
                    alive[ar, j] = False
                    dp = pair(unit[p][:, None], sq[p][:, None], x, xs)[:, 0]
                    alive &= ~((alpha * dp <= v) & (has & ~done)[:, None])
                    alive &= ~done[:, None]
            if taken >= k or bool(done.all()):
                break
            # the nodes that kept r leave; the rest walk on alone
            chunk_kept[rows[done]] = kept[done]
            walk = ~done
            rows, d, kept, count = rows[walk], d[walk], kept[walk], count[walk]
            b = rows.numel()
            ar = torch.arange(b, device=dev)
            done = torch.zeros(b, dtype=torch.bool, device=dev)
        chunk_kept[rows] = kept
        del d
        out.append(chunk_kept)
    return torch.cat(out)


def _dist_to_rows(base: torch.Tensor, nodes: torch.Tensor,
                  cand: torch.Tensor, metric: str) -> torch.Tensor:
    """(B,) nodes, (B, W) candidate ids (-1 padding) -> (B, W) distances
    node -> candidate (+inf on padding), the reference's pairwise_dist."""
    q = base[nodes][:, None, :]                                # (B, 1, D)
    x = base[cand.clamp(min=0)]                                # (B, W, D)
    if metric == "l2":
        d = ((q * q).sum(-1) + (x * x).sum(-1)
             - 2.0 * torch.bmm(x, q.transpose(1, 2))[..., 0])
    else:
        if metric == "angular":
            q, x = l2_normalize(q), l2_normalize(x)
        d = -torch.bmm(x, q.transpose(1, 2))[..., 0]
    return torch.where(cand >= 0, d, float("inf"))


def _add_reverse_edges(rows: torch.Tensor, base, metric, r, alpha):
    """rows (N, r) kept lists -> (N, r): each row followed by the nodes that
    kept it (ascending, skipping ones already in the row), re-pruned over
    that merged list when it is longer than r."""
    n = rows.shape[0]
    dev = rows.device
    src = torch.arange(n, device=dev)[:, None].expand_as(rows)
    has = rows >= 0
    e_src, e_dst = src[has], rows[has]
    fwd = torch.sort(e_src * n + e_dst).values
    # reverse entry (dst <- src) is dropped when dst already lists src
    back = e_dst * n + e_src
    pos = torch.searchsorted(fwd, back).clamp(max=fwd.numel() - 1)
    mutual = fwd[pos] == back
    back = torch.sort(back[~mutual]).values                    # by (dst, src)
    return merge_edges(rows, back // n, back % n, base, metric, r, alpha)


def merge_edges(rows: torch.Tensor, r_dst: torch.Tensor, r_src: torch.Tensor,
                base, metric, r, alpha) -> torch.Tensor:
    """rows (N, r) compact lists (-1 after the entries) and new edges
    ``r_dst -> r_src``, sorted by (dst, src), none already in its row ->
    (N, r): each touched row followed by its new entries, re-pruned over
    that merged list when it is longer than r; other rows as they were."""
    n = rows.shape[0]
    dev = rows.device
    cnt = torch.bincount(r_dst, minlength=n)
    ptr = torch.cumsum(cnt, 0) - cnt
    merged_len = (rows >= 0).sum(1) + cnt
    out = rows.clone()
    # groups of similar merged length share one padded width
    width = torch.where(merged_len > r, 2 ** torch.ceil(torch.log2(
        merged_len.clamp(min=1).double())).long(), r)
    width = torch.where(cnt > 0, width, 0)
    for w in torch.unique(width).tolist():
        if not w:
            continue
        nodes = torch.nonzero(width == w)[:, 0]
        nodes = nodes[torch.argsort(cnt[nodes])]
        step = max(1, _CHUNK_ELEMS // (w * (w + base.shape[1])))
        for s in range(0, nodes.numel(), step):
            nd = nodes[s : s + step]
            wrev = int(cnt[nd].max())
            rev = rows.new_empty((nd.numel(), 0))
            if wrev:                      # the nodes' reverse lists, padded
                t = torch.arange(wrev, device=dev)
                at = (ptr[nd][:, None] + t).clamp(max=r_src.numel() - 1)
                rev = torch.where(t[None, :] < cnt[nd][:, None], r_src[at], -1)
            merged = torch.cat([rows[nd], rev], 1)
            merged = _compact(merged, merged >= 0, max(w, r))
            if w > r:
                cd = _dist_to_rows(base, nd, merged, metric)
                out[nd] = robust_prune_batch(merged, cd, base, metric, r, alpha)
            else:
                out[nd] = merged[:, :r]
    return out


def _reachable(rows: torch.Tensor, entry: int) -> torch.Tensor:
    """(N,) bool: nodes reachable from ``entry`` (BFS on the device)."""
    reached = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    reached[entry] = True
    frontier = torch.tensor([entry], device=rows.device)
    while frontier.numel():
        nb = rows[frontier].reshape(-1)
        nb = nb[nb >= 0]
        nb = torch.unique(nb[~reached[nb]])
        reached[nb] = True
        frontier = nb
    return reached


def _ensure_connected(rows: torch.Tensor, base: torch.Tensor,
                      base_np: np.ndarray, metric: str, entry: int,
                      r: int) -> torch.Tensor:
    """The reference's connectivity repair (``graph.py:122-189``) on the
    device rows (N, r), -1 padded; edited in place and returned."""
    n = rows.shape[0]
    centroid = base_np.mean(0, keepdims=True)
    d_centroid = pairwise_dist(centroid, base_np, metric)[0]
    x2 = (base * base).sum(-1) if metric == "l2" else None
    protected: set = set()          # stitch edges are preferentially kept

    def row_of(a: int) -> list:
        return [v for v in rows[a].tolist() if v >= 0]

    for _ in range(4 * n + 16):
        reached = _reachable(rows, entry)
        reached_np = reached.cpu().numpy()
        if reached_np.all():
            return rows
        orphans = np.where(~reached_np)[0]
        u = int(orphans[np.argmin(d_centroid[orphans])])
        d = pairwise_dist_torch(base[u : u + 1], base, metric, x2)[0]
        d = torch.where(reached, d, float("inf"))
        order = torch.sort(d, stable=True).indices[: int(reached.sum())]
        # the nearest reached node with a free or unprotected slot —
        # protected (stitch) edges are never evicted, so a reached node
        # never becomes unreachable again
        w = None
        for s in range(0, order.numel(), 256):
            for cand in order[s : s + 256].tolist():
                row = row_of(cand)
                if len(row) < r or any((cand, e) not in protected for e in row):
                    w = cand
                    break
            if w is not None:
                break
        if w is None:
            raise RuntimeError("connectivity repair exhausted slots")
        for a, b in ((w, u), (u, w)):
            row = row_of(a)
            if b in row:
                continue
            if len(row) < r:
                row.append(b)
            else:
                da = pairwise_dist(base_np[a : a + 1], base_np[row], metric)[0]
                evictable = [j for j in range(len(row))
                             if (a, row[j]) not in protected]
                if not evictable:
                    # the reference front-inserts here; the choice of w
                    # above makes it unreachable
                    raise RuntimeError("connectivity repair: row fully "
                                       "protected")
                j = max(evictable, key=lambda j: da[j])
                row[j] = b
            rows[a] = torch.tensor(row + [-1] * (r - len(row)),
                                   dtype=rows.dtype)
            protected.add((a, b))
    raise RuntimeError("connectivity repair did not converge")


def pad_rows(rows: torch.Tensor, r: int):
    """The reference's ``_pad_rows`` on (N, W) -1-padded rows: drop
    self-loops and repeats (first occurrence wins), cut to r, an empty row
    gets (i + 1) % n, pad with the last entry.  -> (adjacency, degrees)."""
    n, w = rows.shape
    dev = rows.device
    ar = torch.arange(n, device=dev)[:, None]
    keep = (rows >= 0) & (rows != ar)
    col = torch.arange(w, device=dev)[None, :]
    vals = torch.where(keep, rows, n + col)          # unique filler per slot
    sv, order = torch.sort(vals, dim=1, stable=True)
    dup_sorted = torch.zeros_like(keep)
    dup_sorted[:, 1:] = sv[:, 1:] == sv[:, :-1]
    keep &= ~torch.zeros_like(keep).scatter(1, order, dup_sorted)
    out = _compact(rows, keep, r)
    if out.shape[1] < r:
        out = torch.nn.functional.pad(out, (0, r - out.shape[1]), value=-1)
    deg = (out >= 0).sum(1)
    empty = deg == 0
    out[empty, 0] = (ar[empty, 0] + 1) % n
    deg = torch.clamp(deg, min=1)
    last = out.gather(1, (deg - 1)[:, None])
    out = torch.where(torch.arange(r, device=dev)[None, :] < deg[:, None],
                      out, last)
    return out.to(torch.int32).cpu().numpy(), deg.to(torch.int32).cpu().numpy()


def build_knn_prune(base: np.ndarray, cfg: GraphConfig, metric: str,
                    device="cuda", stage_times: dict | None = None) -> Graph:
    """kNN lists -> robust prune -> reverse edges -> medoid -> connectivity
    repair -> padding, on ``device``.  ``stage_times``, if given, receives
    the seconds each stage took (synchronised)."""
    n = base.shape[0]
    r = cfg.max_degree
    k = min(cfg.build_list_size, n - 1)
    timer = StageTimer(stage_times, device)
    with full_precision():
        xb = torch.as_tensor(np.ascontiguousarray(base, np.float32),
                             device=device)
        if k <= _LONG_LIST:
            knn, knn_d = knn_lists(xb, k, metric)
            timer.mark("knn")
            nodes = torch.arange(n, device=device)
            rows = _prune_chunks(nodes, knn, knn_d, xb, metric, r, cfg.alpha)
            del knn, knn_d
            timer.mark("prune")
        else:
            rows = _knn_prune_windows(xb, k, metric, r, cfg.alpha)
            timer.mark("knn_prune")
        rows = _add_reverse_edges(rows, xb, metric, r, cfg.alpha)
        timer.mark("reverse_edges")
        entry = medoid(base, metric, seed=cfg.seed)
        rows = _ensure_connected(rows, xb, base, metric, entry, r)
        timer.mark("connect")
        adj, deg = pad_rows(rows, r)
        timer.mark("pad")
    return Graph(adjacency=adj, degrees=deg, entry_point=entry, metric=metric)


class StageTimer:
    """Adds synchronised seconds per build stage into a dict (or not): a
    stage marked again, e.g. once per segment, accumulates."""

    def __init__(self, out: dict | None, device):
        self.out, self.device = out, torch.device(device)
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[name] = self.out.get(name, 0.0) + now - self.t
        self.t = now

    def restart(self) -> None:
        """Start the next stage now, leaving the time since the last mark
        unrecorded (a callee recorded it)."""
        if self.out is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t = time.perf_counter()


def add_stage_times(out: dict | None, times: dict, prefix: str) -> None:
    """Add ``times`` into ``out`` (if given) under ``prefix + name``."""
    if out is not None:
        for k, v in times.items():
            out[prefix + k] = out.get(prefix + k, 0.0) + v


def _greedy_search_np(base, adj, deg, entry, query, metric, list_size):
    """Plain best-first search (the HNSW/DiskANN inner loop) returning the
    visited set with distances, ascending — the incremental builder's and
    the delta segment's search (the reference's numpy)."""
    import heapq

    d0 = float(pairwise_dist(query[None], base[entry : entry + 1],
                             metric)[0, 0])
    cand = [(d0, entry)]           # min-heap of unexpanded
    best: dict = {entry: d0}       # id -> dist of everything scored
    expanded = set()
    while cand:
        d, v = heapq.heappop(cand)
        topl = sorted(best.values())[: list_size]
        if d > topl[-1] and len(best) >= list_size:
            break
        if v in expanded:
            continue
        expanded.add(v)
        neigh = [int(u) for u in adj[v, : deg[v]] if int(u) not in best]
        neigh = list(dict.fromkeys(neigh))
        if not neigh:
            continue
        nd = pairwise_dist(query[None], base[neigh], metric)[0]
        for u, du in zip(neigh, nd):
            best[u] = float(du)
            heapq.heappush(cand, (float(du), u))
    order = sorted(best.items(), key=lambda kv: kv[1])
    return order, expanded


def build_incremental(base: np.ndarray, cfg: GraphConfig,
                      metric: str) -> Graph:
    """The faithful Vamana build on the host (the reference's numpy): random
    bootstrap edges, then every point in a seeded random order is
    greedy-searched from the medoid, its visited set robust-pruned into its
    row, and reverse edges added with an overflow re-prune."""
    n = base.shape[0]
    r = cfg.max_degree
    rng = np.random.default_rng(cfg.seed)
    start = medoid(base, metric, seed=cfg.seed)
    rows: list = [[] for _ in range(n)]
    for i in range(n):           # bootstrap: random initial edges
        rows[i] = [int(v) for v in rng.choice(n, size=min(4, n - 1),
                                              replace=False) if v != i]
    adj, deg = _pad_rows_np(rows, r, n)
    order = rng.permutation(n)
    for i in order:
        scored, _ = _greedy_search_np(base, adj, deg, start, base[i], metric,
                                      cfg.build_list_size)
        cand = np.asarray([v for v, _ in scored if v != i], dtype=np.int64)
        cd = np.asarray([d for v, d in scored if v != i], dtype=np.float32)
        kept = robust_prune(cand, cd, base, metric, r, cfg.alpha)
        rows[i] = kept
        for j in kept:           # reverse edges with overflow re-prune
            if i not in rows[j]:
                rows[j].append(i)
                if len(rows[j]) > r:
                    cj = pairwise_dist(base[j : j + 1], base[rows[j]],
                                       metric)[0]
                    rows[j] = robust_prune(np.asarray(rows[j]), cj, base,
                                           metric, r, cfg.alpha)
        adj, deg = _pad_rows_np(rows, r, n)
    return Graph(adjacency=adj, degrees=deg, entry_point=start, metric=metric)


def build_graph(base: np.ndarray, cfg: GraphConfig, metric: str,
                method: str = "knn_prune", device="cuda",
                stage_times: dict | None = None) -> Graph:
    if method == "knn_prune":
        return build_knn_prune(base, cfg, metric, device, stage_times)
    if method == "incremental":          # the host's numpy, any device
        return build_incremental(base, cfg, metric)
    raise ValueError(f"unknown graph build method {method!r}")
