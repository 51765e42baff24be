"""Batched ANN-search serving engine — port of the batch-flush mode of
``src/repro/serve/engine.py`` (``ServingEngine`` lines 211-290, ``_bucket``,
``submit``, ``step``/``_step_batch``, ``drain``).

Requests arrive one at a time; each ``submit`` compiles (or plan-cache-hits)
a ``QueryPlan``, and a flush packs queued requests sharing the head
request's plan into one batch, padded with zero queries to a power-of-two
bucket (at most ``batch_size``), and runs it once through the ``Searcher``.
A batch flushes when it is full or its oldest request has waited
``flush_us``; ``drain`` forces flushes until the queue is empty.  The
constructor warms the full-batch bucket up with one search of zero queries.
All timing is ``time.perf_counter()``: a flush's results are host arrays, so
the device work is done when the clock is read.

Not ported yet, and refused: continuous batching (ROADMAP Queue 1 item 7),
streaming/mutable targets (item 10), tiled serving (item 11), filtered
requests (item 9), observability (item 12).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from repro_torch.configs.base import PlanConfig, SearchConfig
from repro_torch.core.search import next_pow2
from repro_torch.plan import QueryPlan, Searcher, SearchRequest


@dataclasses.dataclass
class Request:
    rid: int
    query: np.ndarray
    t_submit: float = 0.0
    t_done: float = 0.0
    ids: Optional[np.ndarray] = None
    dists: Optional[np.ndarray] = None
    filter: Optional[Any] = None
    tenant: Optional[str] = None
    plan: Optional[QueryPlan] = None

    @property
    def latency_ms(self) -> float:
        return (self.t_done - self.t_submit) * 1e3


@dataclasses.dataclass
class EngineStats:
    """Serving counters of batch-flush mode."""
    batches: int = 0
    queries: int = 0
    pad_fraction: float = 0.0        # running MEAN pad share over batches

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ServingEngine:
    def __init__(
        self,
        index,
        batch_size: int = 32,
        cfg: Optional[SearchConfig] = None,
        flush_us: float = 2000.0,
        beam_width: Optional[int] = None,
        plan: Optional[PlanConfig] = None,
        continuous: bool = False,
    ):
        if continuous:
            raise NotImplementedError(
                "continuous batching is not ported yet: ROADMAP Queue 1 "
                "item 7 (continuous engine and plan/rounds.py)")
        pcfg = plan or PlanConfig()
        legacy = dict(search=cfg, beam_width=beam_width)
        pcfg = dataclasses.replace(
            pcfg, **{k: v for k, v in legacy.items() if v is not None})
        self.searcher = Searcher.open(index, pcfg)
        self.batch_size = batch_size
        self.flush_us = flush_us
        self.continuous = False
        self.queue: Deque[Request] = deque()
        self.done: Dict[int, Request] = {}
        self._next = 0
        self._stats = EngineStats()
        # warm the full-batch bucket (kernel builds, allocator pools)
        dummy = np.zeros((batch_size, index.dataset.dim), np.float32)
        self.searcher.search(SearchRequest(queries=dummy))

    def _bucket(self, n: int) -> int:
        """Smallest power-of-two >= n, capped at batch_size."""
        return min(next_pow2(max(n, 1)), self.batch_size)

    @property
    def index(self):
        return self.searcher.index

    @property
    def cfg(self) -> SearchConfig:
        return self.searcher.cfg

    @property
    def metric(self) -> str:
        return self.searcher.metric

    @property
    def stats(self) -> dict:
        d = self._stats.as_dict()
        d.update(self.searcher.plan_cache_stats())
        return d

    # --------------------------------------------------------------- requests
    def submit(self, query: np.ndarray, filter: Optional[Any] = None,
               tenant: Optional[str] = None) -> int:
        """Queue one query; its ``QueryPlan`` is compiled here and requests
        batch by its cache key (``tenant`` is part of it)."""
        rid = self._next
        self._next += 1
        q = np.asarray(query, np.float32)
        plan = self.searcher.plan(SearchRequest(queries=q, filter=filter,
                                                tenant=tenant))
        self.queue.append(Request(rid=rid, query=q,
                                  t_submit=time.perf_counter(),
                                  filter=filter, tenant=tenant, plan=plan))
        return rid

    # ------------------------------------------------------------- scheduling
    def _flush_due(self) -> bool:
        """Full batch, or the oldest queued request has waited ``flush_us``."""
        if len(self.queue) >= self.batch_size:
            return True
        return (
            bool(self.queue)
            and (time.perf_counter() - self.queue[0].t_submit) * 1e6
            >= self.flush_us
        )

    def step(self, force: bool = False) -> List[Request]:
        """Run one plan-homogeneous batch if due; returns completed
        requests."""
        if not (force and self.queue) and not self._flush_due():
            return []
        plan = self.queue[0].plan
        key = plan.cache_key
        batch: List[Request] = []
        skipped: List[Request] = []
        while self.queue and len(batch) < self.batch_size:
            r = self.queue.popleft()
            (batch if r.plan.cache_key == key else skipped).append(r)
        self.queue.extendleft(reversed(skipped))
        n = len(batch)
        q = np.stack([r.query for r in batch])
        bucket = self._bucket(n)
        if n < bucket:  # pad to the bucket's shape
            q = np.concatenate(
                [q, np.zeros((bucket - n, q.shape[1]), np.float32)])
        ex = self.searcher.execute(plan, q)
        now = time.perf_counter()
        for i, r in enumerate(batch):
            r.ids, r.dists, r.t_done = ex.ids[i], ex.dists[i], now
            self.done[r.rid] = r
        b = self._stats.batches
        self._stats.pad_fraction = (
            self._stats.pad_fraction * b + (bucket - n) / bucket) / (b + 1)
        self._stats.batches = b + 1
        self._stats.queries += n
        return batch

    def drain(self, max_steps: Optional[int] = None) -> List[Request]:
        """Force-run until the queue is empty (bounded: each forced step
        completes at least one request)."""
        out: List[Request] = []
        if max_steps is None:
            max_steps = 2 * (len(self.queue) + 1) + 16
        steps = 0
        while self.queue:
            if steps >= max_steps:
                raise RuntimeError(
                    f"drain() exceeded {max_steps} steps with "
                    f"{len(self.queue)} queued")
            out.extend(self.step(force=True))
            steps += 1
        return out
