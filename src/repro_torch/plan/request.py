"""Typed request/result envelope of the query-plan layer — port of
``src/repro/plan/request.py``.  Same fields as the reference."""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

from repro_torch.filter.spec import FilterSpec


@dataclasses.dataclass
class SearchRequest:
    """One search call against a ``Searcher``: a ``(Q, D)`` (or ``(D,)``)
    float query array, ``k`` (default: the searcher's ``SearchConfig.k``),
    a hashable ``filter`` (``filter.FilterSpec``) and per-request
    ``SearchConfig`` overrides (e.g. ``{"beam_width": 4}``).  ``node_mask``
    is a caller-compiled (N,) bool admission mask; ``adaptive`` selects
    whether the selectivity regimes (scan / inflated masked traversal)
    apply to it, or it goes to the traversal verbatim."""
    queries: Any
    k: Optional[int] = None
    filter: Optional[FilterSpec] = None
    tenant: Optional[str] = None
    overrides: Any = ()
    probe_tiles: Optional[int] = None
    node_mask: Optional[Any] = None
    adaptive: bool = True

    def override_items(self) -> Tuple[Tuple[str, Any], ...]:
        """Overrides as a sorted, hashable tuple (the plan-cache key part)."""
        if isinstance(self.overrides, Mapping):
            return tuple(sorted(self.overrides.items()))
        return tuple(self.overrides)


@dataclasses.dataclass(frozen=True)
class SearchStats:
    """Per-execution search statistics; counters are per-query means."""
    queries: int = 0                 # batch size executed
    k: int = 0
    kind: str = "flat"               # flat | tiled | merged | distributed
    strategy: str = "none"           # none | masked | scan | empty | adaptive
    selectivity: float = 1.0         # passing fraction (1.0 unfiltered)
    hops: float = 0.0                # vertex expansions (index fetches)
    pq: float = 0.0                  # PQ distance computations
    acc: float = 0.0                 # accurate distance computations
    hot_hops: float = 0.0            # expansions served by hot-node replicas
    free_pq: float = 0.0             # PQ fetches covered by hot pages
    rounds: float = 0.0              # serial traversal rounds
    delta_candidates: float = 0.0    # delta-segment candidates (merged path)
    beam_width: int = 1              # nominal E executed
    num_tiles: int = 1

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SearchResult:
    """Plan-layer search reply: host numpy ``(Q, k)`` ``ids``/``dists``
    (-1 / +inf padded where a filter admits fewer than k), the ``stats``,
    the executed ``plan`` and the ``raw`` kernel result
    (``core.search.SearchResult``, ``filter.FilteredSearchResult``,
    ``shard.ShardedSearchResult``, ``stream.MergedResult`` or a distributed
    ``(ids, dists)`` pair, its tensors on the search device)."""
    ids: Any
    dists: Any
    stats: SearchStats
    plan: Any
    raw: Any
