"""Cross-segment stitching: patch per-segment graphs into one navigable
global graph — port of ``src/repro/stream/stitch.py``, rebuilt for the
device.

The segmented builder (``core.segmented``) emits S independent graphs over
contiguous global-id blocks, mutually unreachable.  Segments join the union
one at a time, as in the reference: each joining segment's boundary anchors
(its entry point, its hot prefix, then a random sample; ``stitch_sample`` of
them) are searched against the union stitched so far, each anchor's row is
merged with the cross-segment candidates through the Vamana robust-prune
rule, and the kept cross edges are reverse-patched into the union's rows
(re-pruning rows that overflow ``max_degree``) — the streaming delta
segment's insert recipe with a whole segment as the delta.

What the device changes.  The reference runs one numpy best-first search
per anchor (``_greedy_search_np``, every scored vertex a candidate) and
patches after each; that costs ~0.4 s an anchor on a 1M union, and a
stitched 1M graph stays unnavigable at the default 32 anchors a segment
(PERF.md).  Here the anchors go to the device ``STITCH_BATCH`` at a time:
one exact-distance beam search (``core.search.graph_search``, no PQ, no
early termination, list = the density-compensated ``build_list_size``) of
the union as the earlier batches left it, whose list is each anchor's
candidate set; one batched prune (``robust_prune_batch``); and the reverse
patches of the batch merged per union row (``core.graph.merge_edges``: a
row that overflows is pruned once over all its new entries).  Up to one
batch, the rule and its order are the reference's.  The finalize —
connectivity repair (every vertex reachable from the entry), then the
padded adjacency — is the device build's (``core.graph._ensure_connected``,
``pad_rows``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import BuildConfig, GraphConfig, SearchConfig
from repro_torch.core.dataset import full_precision
from repro_torch.core.graph import (
    Graph, _compact, _dist_to_rows, _ensure_connected, compensated_build_cfg,
    merge_edges, pad_rows, robust_prune_batch,
)

STITCH_BATCH = 512          # anchors searched together
_BEAM = 8                   # beam width E of the anchors' search
_BLOOM_BITS = 1 << 20       # visited-set bits a lane (~50k visits)


@dataclass
class StitchResult:
    """The stitched global graph plus the patch accounting (every patched
    row is an adjacency re-program in the NAND build model)."""
    graph: Graph                 # global built ids, all segments reachable
    anchors: np.ndarray          # (A,) global ids used as stitch anchors
    cross_edges: int             # directed edges between different segments
    patched_rows: int            # adjacency rows rewritten by stitching


def _segment_of(segments) -> np.ndarray:
    """(N,) global id -> segment index."""
    n = sum(s.num_vertices for s in segments)
    out = np.empty(n, np.int32)
    for i, seg in enumerate(segments):
        out[seg.start : seg.start + seg.num_vertices] = i
    return out


def _pick_anchors(seg, sample: int, rng: np.random.Generator) -> np.ndarray:
    """Boundary anchors of one segment, global ids: the entry point first,
    then the hot prefix, then a random spread (the reference's draw)."""
    n = seg.num_vertices
    picks = [seg.graph.entry_point]
    picks += [i for i in range(seg.hot_count) if i != seg.graph.entry_point]
    if len(picks) < sample:
        rest = rng.permutation(n)
        seen = set(picks)
        picks += [int(i) for i in rest if int(i) not in seen]
    return seg.start + np.asarray(picks[:sample], np.int64)


def _search_union(rows: torch.Tensor, base: torch.Tensor, entry: int,
                  anchors: torch.Tensor, metric: str,
                  list_size: int) -> torch.Tensor:
    """(A, list_size) ids (-1 padded) of each anchor's nearest union
    vertices: an exact beam search of the -1-padded ``rows`` from
    ``entry``."""
    from repro_torch.core.search import Corpus, graph_search

    deg = (rows >= 0).sum(1)
    last = rows.gather(1, (deg - 1).clamp(min=0)[:, None])
    adjacency = torch.where(rows >= 0, rows, last).to(torch.int32)
    dev = base.device
    corpus = Corpus(adjacency=adjacency,
                    codes=torch.zeros((1, 1), dtype=torch.uint8, device=dev),
                    base=base,
                    centroids=torch.zeros((1, 1, 1), device=dev),
                    entry_point=entry, hot_count=0)
    cfg = SearchConfig(k=list_size, list_size=list_size, use_pq=False,
                       early_termination=False, beam_width=_BEAM,
                       max_rounds=4 * list_size)
    return graph_search(corpus, base[anchors], cfg, metric,
                        bloom_bits=_BLOOM_BITS).ids.long()


def _stitch_batch(rows, base, seg_of, s, anchors, entry, metric, list_size,
                  r, alpha, patched) -> None:
    """One batch of segment ``s``'s anchors: search, prune, reverse-patch
    ``rows`` in place; marks the rows it rewrites in ``patched``."""
    cand = _search_union(rows, base, entry, anchors, metric, list_size)
    cross = torch.where((cand >= 0) & (seg_of[cand.clamp(min=0)] != s),
                        cand, -1)
    has_cross = (cross >= 0).any(1)
    anchors, cross = anchors[has_cross], cross[has_cross]
    if not anchors.numel():
        return
    # the anchor's own row, then its cross candidates, first occurrence
    merged = torch.cat([rows[anchors], cross], 1)
    sv, order = torch.sort(torch.where(merged >= 0, merged, -1 - torch.arange(
        merged.shape[1], device=merged.device)), dim=1, stable=True)
    dup_sorted = torch.zeros_like(merged, dtype=torch.bool)
    dup_sorted[:, 1:] = (sv[:, 1:] == sv[:, :-1]) & (sv[:, 1:] >= 0)
    dup = torch.zeros_like(dup_sorted).scatter(1, order, dup_sorted)
    merged = _compact(merged, (merged >= 0) & ~dup, merged.shape[1])
    kept = robust_prune_batch(merged, _dist_to_rows(base, anchors, merged,
                                                    metric),
                              base, metric, r, alpha)
    rows[anchors] = kept
    patched[anchors] = True
    # reverse-patch the union side: j -> anchor, unless j lists it already
    j = kept.reshape(-1)
    a = anchors[:, None].expand_as(kept).reshape(-1)
    keep = (j >= 0) & (seg_of[j.clamp(min=0)] != s)
    j, a = j[keep], a[keep]
    keep = ~(rows[j] == a[:, None]).any(1)
    j, a = j[keep], a[keep]
    if not j.numel():
        return
    n = rows.shape[0]
    key = torch.sort(j * n + a).values
    rows.copy_(merge_edges(rows, key // n, key % n, base, metric, r, alpha))
    patched[j] = True


def stitch_segments(segments, metric: str, graph_cfg: GraphConfig,
                    build_cfg: BuildConfig, device="cuda") -> StitchResult:
    """Stitch built segments (``core.segmented.IndexSegment``) into one
    global ``Graph`` on ``device``."""
    num_segments = len(segments)
    n = sum(s.num_vertices for s in segments)
    r = graph_cfg.max_degree
    alpha = graph_cfg.alpha
    base = np.concatenate([s.base for s in segments])
    seg_of_np = _segment_of(segments)

    # block-diagonal union: per-segment adjacency offset to global ids,
    # -1 after each row's true degree
    adj = np.full((n, r), -1, np.int64)
    for seg in segments:
        lo = seg.start
        g = seg.graph
        valid = np.arange(r)[None, :] < g.degrees[:, None]
        adj[lo : lo + seg.num_vertices] = np.where(valid, g.adjacency + lo, -1)

    entry = int(segments[0].start + segments[0].graph.entry_point)
    list_size = build_cfg.stitch_list_size or compensated_build_cfg(
        graph_cfg, num_segments, n
    ).build_list_size

    anchors_all: list = []
    rng = np.random.default_rng(graph_cfg.seed)
    with full_precision():
        rows = torch.as_tensor(adj, device=device)
        xb = torch.as_tensor(base, device=device)
        seg_of = torch.as_tensor(seg_of_np, device=device)
        patched = torch.zeros(n, dtype=torch.bool, device=device)
        # segments join the union one at a time; segment 0 seeds it
        for s in range(1, num_segments):
            anchors = _pick_anchors(segments[s], build_cfg.stitch_sample, rng)
            anchors_all.append(anchors)
            a_t = torch.as_tensor(anchors, device=device)
            for b0 in range(0, a_t.numel(), STITCH_BATCH):
                _stitch_batch(rows, xb, seg_of, s, a_t[b0 : b0 + STITCH_BATCH],
                              entry, metric, list_size, r, alpha, patched)
        # finalize: connectivity repair -> padded adjacency
        before = rows.clone()
        rows = _ensure_connected(rows, xb, base, metric, entry, r)
        patched |= (rows != before).any(1)
        del xb, before
        padded, degrees = pad_rows(rows, r)
        n_patched = int(patched.sum())

    valid = np.arange(r)[None, :] < degrees[:, None]
    cross_edges = int(((seg_of_np[padded] != seg_of_np[:, None])
                       & valid).sum())
    return StitchResult(
        graph=Graph(adjacency=padded, degrees=degrees, entry_point=entry,
                    metric=metric),
        anchors=np.concatenate(anchors_all) if anchors_all
        else np.empty((0,), np.int64),
        cross_edges=cross_edges,
        patched_rows=n_patched,
    )
