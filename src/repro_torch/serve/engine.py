"""Batched ANN-search serving engine — port of ``src/repro/serve/engine.py``:
batch-flush and continuous (iteration-level) scheduling, unfiltered and
filtered requests, over a frozen index (flat, tiled or segment-built) or a
streaming ``stream.MutableIndex``.

Batch-flush mode: each ``submit`` compiles (or plan-cache-hits) a
``QueryPlan``, and a flush packs queued requests sharing the head request's
plan into one batch, padded with zero queries to a power-of-two bucket (at
most ``batch_size``), and runs it once through the ``Searcher``.  A batch
flushes when it is full or its oldest request has waited ``flush_us``;
``drain`` forces flushes until the queue is empty.

Continuous mode (``continuous=True``): the engine keeps a fixed pool of
``slots`` in-flight lanes per plan cache key and advances all of them one
traversal round per ``step()`` (a tick, through the plan layer's
``RoundSession``).  Each tick reads the pool's "active" flags to the host
once — the retire decision — and retires every lane that quiesced (beta
rerank over the gathered retiring lanes only), so no query waits on
another's last round; freed slots refill from the queue on the next tick.
Plans without a round-steppable spine (tiled fan-outs, bitmap ``scan``,
``empty``, a request whose planning failed) go through the batch-flush path: the
reference's scheduling, on the card through the same kernels.  Per-lane
arithmetic does not depend on the batch a lane runs in, so both modes
return the same ids and distances.

The three slot-pool helpers are PyTorch index ops over the port's
``SearchState``: ``_scatter_rows`` (``index_copy_`` per field: admission
inits only the admitted queries, since ``init`` is independent per lane,
and copies their rows, Bloom bits included, into the pool's own tensors),
``_gather_rows`` (``index_select``; no power-of-two padding — the port has
no compile cache to bound) and ``_quiet_free_lanes``.  A pool's state is
stepped exactly once per tick and replaced by the result, since a step
updates the Bloom bits in place.

Tiled serving (``num_tiles``, ``shard_policy``, ``probe_tiles``, or a
segment-built index) runs every batch through the fan-out over the tiles
(by default the batched one: one traversal of the tiles' P x Q lanes) and
the cross-tile merge (``shard.sharded_search_kernel``).

Streaming (``ServingEngine(MutableIndex(index))``): ``insert`` / ``delete``
interleave with ``submit``; updates apply at once (the delta segment is
host memory), and every query flushed or retired after an update sees it.
Merged plans run the base search on the device and fuse the delta and the
tombstones on the host (``stream.searcher``).  With ``auto_consolidate``
the delta folds into a rebuilt base between batches (and between ticks)
once ``MutableIndex.needs_consolidation()``; a full delta consolidates
inside ``insert``.  In continuous mode a lane traverses the base (and a
filtered plan's admission mask) pinned at its session's creation, while
tombstones and the delta are read live when it retires; a consolidation
rebuilds the base's id space, so the engine first runs every in-flight
merged lane to completion (``_complete_merged_pools``), the capacity-forced
consolidation inside ``insert`` included, then drops the merged sessions
and the shadow oracle's copy of the live vectors, which pin the old base's
device arrays, before the rebuild allocates the new ones
(``_drop_merged_sessions``); new sessions open on the new base.

Observability (``repro_torch.obs``): pass ``obs=Observability.on()`` (or an
``ObsConfig``) and the engine records queue-wait and end-to-end latency
histograms and batch/slot occupancy labelled by plan kind / filter strategy
/ tenant, emits ``queue-wait`` async spans and ``batch`` > ``batch-assembly``
/ ``kernel-execute`` / ``post-process`` / ``nand-billing`` spans (``tick``
and ``retire`` in continuous mode), installs the kernel hooks (calls and
CUDA-event launch times, read after each batch's ids reached the host),
watches the kernel libraries for rebuilds, samples shadow recall
(``quality=True``), logs per-round convergence (``convergence=True``) and —
with ``nand_billing`` — bills every flushed batch and every retired set of
lanes through the NAND model (``nand=`` a ``NandConfig``, ``nand_queues=``
the modelled queue count).  ``slo=`` takes ``{tenant: obs.SLOTarget}``.
The default is the shared no-op bundle: one branch per call site.

All timing is ``time.perf_counter()``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import Counter, deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import PlanConfig, SearchConfig
from repro_torch.core.search import SearchState, next_pow2
from repro_torch.filter.spec import FilterSpec
from repro_torch.kernels import ops
from repro_torch.obs import (
    KernelWatch, Observability, SLOTracker, record_plan_execution,
)
from repro_torch.plan import QueryPlan, Searcher, SearchRequest
from repro_torch.plan.request import SearchResult as PlanSearchResult


@dataclasses.dataclass
class Request:
    rid: int
    query: np.ndarray
    t_submit: float = 0.0
    t_done: float = 0.0
    ids: Optional[np.ndarray] = None
    dists: Optional[np.ndarray] = None
    filter: Optional[FilterSpec] = None
    tenant: Optional[str] = None
    plan: Optional[QueryPlan] = None

    @property
    def latency_ms(self) -> float:
        return (self.t_done - self.t_submit) * 1e3


@dataclasses.dataclass
class EngineStats:
    """Serving counters."""
    batches: int = 0
    queries: int = 0
    pad_fraction: float = 0.0        # running MEAN pad share over batches
    inserts: int = 0
    deletes: int = 0
    consolidations: int = 0
    filtered_queries: int = 0
    filter_scan_batches: int = 0
    ticks: int = 0                   # continuous mode: round-step ticks run
    retired: int = 0                 # continuous mode: lanes retired
    fallback_batches: int = 0        # continuous mode: non-steppable plans
                                     # served through the batch-flush path
    slo_violations: int = 0          # rolling-window SLO breaches observed

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _SlotPool:
    """One plan's fixed pool of in-flight lanes (continuous mode).  ``state``
    is a ``SearchState`` over exactly ``len(requests)`` lanes; free slots
    hold quiesced lanes (``done=True``), so stepping them is a no-op."""
    session: object                          # plan.RoundSession
    requests: List[Optional[Request]]        # slot -> in-flight request
    state: Optional[SearchState] = None      # built on first admit

    @property
    def occupied(self) -> int:
        return sum(r is not None for r in self.requests)


def _fields(state: SearchState) -> tuple:
    return (state.queries, state.adts, *state.lanes)


def _gather_rows(state: SearchState, rows: torch.Tensor) -> SearchState:
    """The given lanes of a state, copied (``index_select`` per field)."""
    q, a, *lanes = (f.index_select(0, rows) for f in _fields(state))
    return SearchState(queries=q, adts=a, lanes=type(state.lanes)(*lanes))


def _scatter_rows(state: SearchState, rows: torch.Tensor,
                  src: SearchState) -> None:
    """Copy ``src``'s lanes into ``state`` at ``rows``, in place
    (``index_copy_`` per field).  ``state``'s fields must be tensors of
    their own: ``init`` shares one zero tensor among its counters."""
    for dst, s in zip(_fields(state), _fields(src)):
        dst.index_copy_(0, rows, s)


def _quiet_free_lanes(state: SearchState,
                      occupied: torch.Tensor) -> SearchState:
    """Force ``done=True`` on unoccupied lanes so a free slot's dummy query
    never traverses."""
    lanes = state.lanes._replace(done=state.lanes.done | ~occupied)
    return state._replace(lanes=lanes)


class ServingEngine:
    def __init__(
        self,
        index,
        batch_size: int = 32,
        cfg: Optional[SearchConfig] = None,
        flush_us: float = 2000.0,
        auto_consolidate: bool = True,
        num_tiles: Optional[int] = None,
        shard_policy: Optional[str] = None,
        probe_tiles: Optional[int] = None,
        beam_width: Optional[int] = None,
        attributes=None,
        plan: Optional[PlanConfig] = None,
        obs=None,
        continuous: bool = False,
        slots: Optional[int] = None,
        nand=None,
        nand_queues: Optional[int] = None,
        slo=None,
    ):
        """``slo`` takes a ``{tenant: obs.SLOTarget}`` mapping (key ``None``
        covers untenanted traffic); completed requests then feed per-tenant
        rolling latency windows — and, with quality monitoring on,
        shadow-recall windows — whose breaches count into
        ``EngineStats.slo_violations``."""
        pcfg = plan or PlanConfig()
        legacy = dict(search=cfg, num_tiles=num_tiles,
                      shard_policy=shard_policy, probe_tiles=probe_tiles,
                      beam_width=beam_width)
        pcfg = dataclasses.replace(
            pcfg, **{k: v for k, v in legacy.items() if v is not None})
        self.obs = Observability.resolve(obs)
        self.searcher = Searcher.open(index, pcfg, attributes=attributes,
                                      obs=self.obs)
        self.batch_size = batch_size
        self.flush_us = flush_us
        self.auto_consolidate = auto_consolidate
        self.continuous = bool(continuous)
        self.slots = int(slots) if slots else batch_size
        self.queue: Deque[Request] = deque()
        self.done: Dict[int, Request] = {}
        self._next = 0
        self._stats = EngineStats()
        self._pools: Dict[tuple, _SlotPool] = {}
        self._sessions: Dict[tuple, object] = {}   # key -> RoundSession|None
        # continuous mode: queued requests per steppable plan key, so a
        # refill stops scanning the queue once nothing more can be admitted
        self._waiting: Counter = Counter()
        self.nand = nand                     # NandConfig override for billing
        self.nand_queues = nand_queues       # modelled scheduler queue count
        self._slo = SLOTracker(self.obs.metrics, slo) if slo else None
        if self.obs.quality is not None and self._slo is not None:
            # shadow-recall samples are the only recall observations the
            # SLO windows can get
            self.obs.quality.slo = self._slo
        if self.obs.enabled:
            self.obs.install_kernel_hooks()
        # warm the full-batch bucket (kernel builds, allocator pools); the
        # synthetic queries stay out of the shadow-recall sampling stream
        dummy = np.zeros((batch_size, self.index.dataset.dim), np.float32)
        qm = self.obs.quality
        with (qm.paused() if qm is not None else contextlib.nullcontext()):
            self.searcher.search(SearchRequest(queries=dummy))
        if self.continuous:
            # and the round step at the slot-pool shape (a tiled default
            # plan has no round step)
            sess0 = self._session_for(
                self.searcher.plan(SearchRequest(queries=dummy[:1])))
            if sess0 is not None:
                z = np.zeros((self.slots, dummy.shape[1]), np.float32)
                sess0.finalize(sess0.step(sess0.init(z)))
        # rebuild watch baselined after warm-up: any kernel library built
        # while serving is a rebuild
        self._watch = KernelWatch(self.obs.metrics) \
            if self.obs.metrics.enabled else None

    def _bucket(self, n: int) -> int:
        """Smallest power-of-two >= n, capped at batch_size."""
        return min(next_pow2(max(n, 1)), self.batch_size)

    @property
    def mutable(self):
        return self.searcher.mutable

    @property
    def index(self):
        """The served base index — a mutable's latest after any
        consolidation (the capacity-forced one inside ``insert`` too), so
        NAND billing follows the rebuilt geometry."""
        return self.searcher.index

    @property
    def cfg(self) -> SearchConfig:
        return self.searcher.cfg

    @property
    def metric(self) -> str:
        return self.searcher.metric

    @property
    def filter_cfg(self):
        return self.searcher.filter_cfg

    @property
    def attributes(self):
        return self.searcher.attributes

    @property
    def tiled(self):
        return self.searcher.tiled

    @property
    def corpus(self):
        return self.searcher.corpus

    @property
    def num_tiles(self) -> int:
        return self.searcher.num_tiles

    @property
    def shard_policy(self):
        return self.searcher.shard_policy

    @property
    def probe_tiles(self) -> int:
        return self.searcher.probe_tiles

    @property
    def stats(self) -> dict:
        d = self._stats.as_dict()
        d.update(self.searcher.plan_cache_stats())
        return d

    def slo_status(self) -> dict:
        """Per-tenant rolling-window SLO state (empty without ``slo=``)."""
        return self._slo.status() if self._slo is not None else {}

    # --------------------------------------------------------------- requests
    def submit(self, query: np.ndarray, filter: Optional[FilterSpec] = None,
               tenant: Optional[str] = None) -> int:
        """Queue one query; ``filter`` restricts results to attribute-passing
        nodes.  Its ``QueryPlan`` is compiled here and requests batch by its
        cache key (``tenant`` is part of it).  A planning error (a filter
        without an attribute store) surfaces when the request flushes."""
        rid = self._next
        self._next += 1
        if filter is not None and filter.is_all:
            filter = None                 # all-pass spec == unfiltered batch
        q = np.array(query, np.float32)    # a copy: the caller keeps theirs
        obs = self.obs
        with obs.tracer.span("plan-lookup", rid=rid):
            try:
                plan = self.searcher.plan(SearchRequest(
                    queries=q, filter=filter, tenant=tenant))
            except RuntimeError:
                plan = None
        self.queue.append(Request(rid=rid, query=q,
                                  t_submit=time.perf_counter(),
                                  filter=filter, tenant=tenant, plan=plan))
        self._count_waiting(plan, 1)
        if obs.enabled:
            # queue residency is an async span: requests overlap
            obs.tracer.async_begin("queue-wait", rid)
            obs.metrics.gauge("queue_depth", float(len(self.queue)))
        return rid

    def insert(self, vector: np.ndarray, attrs=None) -> int:
        """Streaming insert; returns the stable external id.  Visible to
        every query flushed or retired after this call.  ``attrs`` is the
        new vector's attribute row when the index carries an attribute
        store."""
        if self.mutable is None:
            raise RuntimeError("engine serves a frozen index — wrap it in "
                               "stream.MutableIndex for online updates")
        if self.mutable.delta_full:
            # this insert WILL consolidate: complete the in-flight merged
            # lanes first, they traverse the base about to be rebuilt
            if self.continuous:
                self._complete_merged_pools()
            self._drop_merged_sessions()
        before = self.mutable.stats["consolidations"]
        ext = self.mutable.insert(vector, attrs=attrs)  # may consolidate
        consolidated = self.mutable.stats["consolidations"] - before
        if consolidated:
            self._recount_waiting()
        self._stats.consolidations += consolidated
        self._stats.inserts += 1
        return ext

    def delete(self, ext_id: int) -> bool:
        """Streaming delete (tombstone), filtered from every later flush and
        retire."""
        if self.mutable is None:
            raise RuntimeError("engine serves a frozen index — wrap it in "
                               "stream.MutableIndex for online updates")
        ok = self.mutable.delete(ext_id)
        if ok:
            self._stats.deletes += 1
        return ok

    def _count_waiting(self, plan: Optional[QueryPlan], n: int) -> None:
        if self.continuous:
            sess, key = self._plan_entry(plan)
            if sess is not None:
                self._waiting[key] += n

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
        """Advance the engine; returns completed requests.  Batch mode: run
        one plan-homogeneous batch if due.  Continuous mode: one tick."""
        if self.continuous:
            return self._tick(force)
        return self._step_batch(force)

    def _step_batch(self, force: bool = False) -> List[Request]:
        """Run one plan-homogeneous batch if due; returns completed
        requests.  Other-plan requests keep their place in the queue."""
        if not (force and self.queue) and not self._flush_due():
            return []
        head = self.queue[0]
        plan = head.plan
        if plan is None:             # deferred planning error raises HERE
            plan = self.searcher.plan(
                SearchRequest(queries=head.query, filter=head.filter,
                              tenant=head.tenant))
            # planning succeeded after all: cache the plan onto every queued
            # same-filter request, so they batch under the real cache key
            for r in self.queue:
                if r.plan is None and r.filter == head.filter \
                        and r.tenant == head.tenant:
                    r.plan = plan
                    self._count_waiting(plan, 1)
        key = plan.cache_key
        obs = self.obs
        labels = dict(kind=plan.kind, strategy=plan.strategy,
                      tenant=plan.tenant)
        with obs.tracer.span("batch", kind=plan.kind,
                             strategy=plan.strategy) as bsp:
            with obs.tracer.span("batch-assembly"):
                batch: List[Request] = []
                skipped: List[Request] = []
                while self.queue and len(batch) < self.batch_size:
                    r = self.queue.popleft()
                    same = r.plan is not None and r.plan.cache_key == key
                    (batch if same else skipped).append(r)
                self.queue.extendleft(reversed(skipped))
                self._count_waiting(plan, -len(batch))
                n = len(batch)
                if obs.enabled:
                    t_assembled = time.perf_counter()
                    for r in batch:
                        # the request leaves the queue here
                        obs.tracer.async_end("queue-wait", r.rid)
                        obs.metrics.observe(
                            "queue_wait_ms",
                            (t_assembled - r.t_submit) * 1e3, **labels)
                q = np.stack([r.query for r in batch])
                bucket = self._bucket(n)
                if n < bucket:  # pad to the bucket's shape
                    q = np.concatenate(
                        [q, np.zeros((bucket - n, q.shape[1]), np.float32)])
            ex = self.searcher.execute(plan, q)   # kernel-execute span inside
            now = time.perf_counter()
            with obs.tracer.span("post-process"):
                if plan.spec is not None:
                    self._stats.filtered_queries += n
                if plan.strategy == "scan":
                    self._stats.filter_scan_batches += 1
                for i, r in enumerate(batch):
                    r.ids, r.dists, r.t_done = ex.ids[i], ex.dists[i], now
                    self.done[r.rid] = r
                    if obs.enabled:
                        obs.metrics.observe("request_latency_ms",
                                            r.latency_ms, **labels)
                    if self._slo is not None:
                        self._slo.record_latency(plan.tenant, r.latency_ms)
                if obs.quality is not None:
                    # off-path shadow-recall sampling over the batch's
                    # unpadded rows (also feeds the SLO recall windows)
                    obs.quality.observe(self.searcher, plan, q[:n],
                                        ex.ids[:n])
                if self._slo is not None:
                    self._stats.slo_violations = self._slo.total_violations
            if obs.enabled:
                bsp.set(queries=n, bucket=bucket)
                obs.metrics.gauge("batch_occupancy", n / bucket)
                obs.metrics.observe("batch_occupancy_hist", n / bucket,
                                    kind=plan.kind)
                obs.metrics.gauge("queue_depth", float(len(self.queue)))
            if obs.nand_billing:
                with obs.tracer.span("nand-billing"):
                    pres = PlanSearchResult(
                        ids=ex.ids, dists=ex.dists,
                        stats=self.searcher.planner.stats_for(plan, ex),
                        plan=plan, raw=ex.raw)
                    record_plan_execution(
                        obs.metrics, pres, index=self.index,
                        nand=self.nand, batch_queries=n,
                        n_queues=self.nand_queues)
        b = self._stats.batches
        self._stats.pad_fraction = (
            self._stats.pad_fraction * b + (bucket - n) / bucket) / (b + 1)
        self._stats.batches = b + 1
        self._stats.queries += n
        if self._watch is not None:
            self._watch.check(0)
        self._maybe_consolidate()
        return batch

    # ----------------------------------------------- continuous (tick) mode
    def _plan_entry(self, plan: Optional[QueryPlan]):
        """(session, cache_key) for a plan — None session when the plan has
        no round-steppable spine."""
        if plan is None:
            return None, None
        key = plan.cache_key
        if key not in self._sessions:
            self._sessions[key] = self.searcher.round_session(plan)
        return self._sessions[key], key

    def _session_for(self, plan: Optional[QueryPlan]):
        return self._plan_entry(plan)[0]

    def inflight(self) -> int:
        """Lanes currently mid-traversal across every slot pool."""
        return sum(p.occupied for p in self._pools.values())

    def _admit(self, pool: _SlotPool, admissions: List[tuple]) -> None:
        """Fill freed slots: init only the admitted queries and copy their
        lanes into the pool's state.  A pool's first admission inits the
        whole pool (zero queries in the free slots, forced done) and gives
        every field a tensor of its own."""
        slots = [slot for slot, _ in admissions]
        for slot, r in admissions:
            pool.requests[slot] = r
        if pool.state is None:
            qmat = np.zeros((len(pool.requests), self.index.dataset.dim),
                            np.float32)
            qmat[slots] = np.stack([r.query for _, r in admissions])
            fresh = pool.session.init(qmat)
            q, a, *lanes = (f.clone() for f in _fields(fresh))
            occupied = torch.as_tensor([r is not None for r in pool.requests],
                                       device=q.device)
            pool.state = _quiet_free_lanes(
                SearchState(queries=q, adts=a,
                            lanes=type(fresh.lanes)(*lanes)), occupied)
            return
        fresh = pool.session.init(np.stack([r.query for _, r in admissions]))
        _scatter_rows(pool.state, torch.as_tensor(
            slots, dtype=torch.int64, device=fresh.queries.device), fresh)

    def _refill(self) -> None:
        """Admit queued requests into free slots, FIFO, creating slot pools
        per plan cache key on first use.  Requests whose plan is unplanned
        or not round-steppable stay queued for the batch-flush path.  The
        scan of the queue stops as soon as every admissible request is in
        (a deep backlog behind full pools costs nothing)."""
        free: Dict[tuple, List[int]] = {}
        todo = 0                             # requests this refill admits
        for key, n in self._waiting.items():
            if not n:
                continue
            pool = self._pools.get(key)
            slots = [i for i, r in enumerate(pool.requests) if r is None] \
                if pool is not None else list(range(self.slots))
            free[key] = slots[::-1]
            todo += min(n, len(slots))
        admitted: Dict[tuple, List[tuple]] = {}
        skipped: List[Request] = []
        while todo and self.queue:
            r = self.queue.popleft()
            sess, key = self._plan_entry(r.plan)
            if sess is None or not free.get(key):
                skipped.append(r)            # not steppable, or pool full
                continue
            if key not in self._pools:
                self._pools[key] = _SlotPool(session=sess,
                                             requests=[None] * self.slots)
            admitted.setdefault(key, []).append((free[key].pop(), r))
            self._waiting[key] -= 1
            todo -= 1
        self.queue.extendleft(reversed(skipped))
        obs = self.obs
        if obs.enabled and admitted:
            now = time.perf_counter()
            for admissions in admitted.values():
                for _, r in admissions:
                    obs.tracer.async_end("queue-wait", r.rid)
                    obs.metrics.observe(
                        "queue_wait_ms", (now - r.t_submit) * 1e3,
                        kind=r.plan.kind, strategy=r.plan.strategy,
                        tenant=r.plan.tenant)
        for key, admissions in admitted.items():
            self._admit(self._pools[key], admissions)

    def _step_pool(self, pool: _SlotPool) -> List[Request]:
        """ONE round over a pool's lanes; finalize and hand back every lane
        that quiesced.  The host reads the pool's active flags once."""
        obs = self.obs
        session = pool.session
        plan = session.plan
        pool.state = session.step(pool.state)
        if obs.convergence is not None:
            # per-round telemetry for every occupied lane (one host copy)
            occ = [i for i, r in enumerate(pool.requests) if r is not None]
            if occ:
                session.record_round(obs.convergence,
                                     [pool.requests[i].rid for i in occ],
                                     pool.state, select=occ)
        active = session.active(pool.state)
        rows = [i for i, r in enumerate(pool.requests)
                if r is not None and not active[i]]
        if not rows:
            return []
        # rounds per retiring lane, read while the stream is idle
        rounds = session.rounds(pool.state)[rows] \
            if obs.enabled or obs.convergence is not None else None
        dev = pool.state.queries.device
        core = session.finalize(_gather_rows(
            pool.state, torch.as_tensor(rows, dtype=torch.int64, device=dev)))
        qrows = np.stack([pool.requests[i].query for i in rows])
        with obs.tracer.span("retire", kind=plan.kind,
                             strategy=plan.strategy, lanes=len(rows)):
            pres = session.complete(qrows, core)
        ops.flush_kernel_timings()           # the ids are on the host
        now = time.perf_counter()
        completed: List[Request] = []
        for j, i in enumerate(rows):
            r = pool.requests[i]
            r.ids, r.dists, r.t_done = pres.ids[j], pres.dists[j], now
            self.done[r.rid] = r
            pool.requests[i] = None
            completed.append(r)
            if obs.enabled:
                obs.metrics.observe(
                    "request_latency_ms", r.latency_ms, kind=plan.kind,
                    strategy=plan.strategy, tenant=plan.tenant)
                obs.metrics.observe("rounds_in_flight", float(rounds[j]),
                                    kind=plan.kind, strategy=plan.strategy)
            if self._slo is not None:
                self._slo.record_latency(plan.tenant, r.latency_ms)
            if obs.convergence is not None:
                obs.convergence.finalize_lane(r.rid, int(rounds[j]))
        if obs.quality is not None:
            obs.quality.observe(self.searcher, plan, qrows, pres.ids)
        if self._slo is not None:
            self._stats.slo_violations = self._slo.total_violations
        if plan.spec is not None:
            self._stats.filtered_queries += len(rows)
        self._stats.retired += len(rows)
        self._stats.queries += len(rows)
        if obs.nand_billing:
            # retired lanes bill exactly like a flushed batch
            with obs.tracer.span("nand-billing"):
                record_plan_execution(
                    obs.metrics, pres, index=self.index,
                    nand=self.nand, batch_queries=len(rows),
                    n_queues=self.nand_queues)
        return completed

    def _tick(self, force: bool = False) -> List[Request]:
        """One scheduler tick: refill free slots from the queue, advance
        every occupied pool one traversal round, retire quiesced lanes.  A
        non-steppable head request flushes through the batch path when due
        (or on ``force``)."""
        obs = self.obs
        completed: List[Request] = []
        with obs.tracer.span("tick"):
            self._refill()
            for pool in self._pools.values():
                if not pool.occupied:
                    continue
                completed.extend(self._step_pool(pool))
                if obs.enabled:
                    obs.metrics.gauge("slot_occupancy",
                                      pool.occupied / len(pool.requests),
                                      kind=pool.session.plan.kind,
                                      strategy=pool.session.plan.strategy)
        self._stats.ticks += 1
        if obs.enabled:
            obs.metrics.gauge("queue_depth", float(len(self.queue)))
        if self.queue and self._session_for(self.queue[0].plan) is None \
                and (force or self._flush_due()):
            n0 = self._stats.batches
            completed.extend(self._step_batch(force=force))
            self._stats.fallback_batches += self._stats.batches - n0
        elif self._watch is not None:
            self._watch.check(0)
        self._maybe_consolidate()
        return completed

    # ------------------------------------------------------------ streaming
    def _maybe_consolidate(self) -> None:
        """Between batches and ticks: consolidate once the mutable index
        asks for it (with ``auto_consolidate``)."""
        if self.auto_consolidate and self.mutable is not None \
                and self.mutable.needs_consolidation():
            self.consolidate()

    def _complete_merged_pools(self) -> List[Request]:
        """Run every in-flight MERGED lane to completion: they traverse the
        base whose id space a consolidation is about to rebuild.  Retired
        requests land in ``done`` as usual."""
        out: List[Request] = []
        for pool in self._pools.values():
            if pool.session.plan.kind != "merged":
                continue
            guard = self.cfg.max_rounds + 2
            while pool.occupied and guard:
                out.extend(self._step_pool(pool))
                guard -= 1
        return out

    def _drop_merged_sessions(self) -> None:
        """Before a consolidation: drop the merged sessions and pools and
        the shadow oracle's copy of the live vectors — they pin the old
        base's corpus and masks, which must be freed before the rebuild
        allocates the new ones.  New sessions open on the next admission,
        on the new base."""
        for key in [k for k, p in self._pools.items()
                    if p.session.plan.kind == "merged"]:
            del self._pools[key]
        for key in [k for k, s in self._sessions.items()
                    if s is not None and s.plan.kind == "merged"]:
            del self._sessions[key]
        self.searcher.release_live_oracle()

    def _recount_waiting(self) -> None:
        """After a consolidation: recount the per-plan queue counts
        against sessions opened on the new base."""
        self._waiting = Counter()
        for r in self.queue:
            self._count_waiting(r.plan, 1)

    def consolidate(self) -> None:
        """Fold the delta segment into a rebuilt base index.  In continuous
        mode the in-flight merged lanes complete first."""
        if self.mutable is None:
            return
        self._complete_merged_pools()
        self._drop_merged_sessions()
        self.mutable.consolidate()
        self._recount_waiting()
        self._stats.consolidations += 1

    def drain(self, max_steps: Optional[int] = None) -> List[Request]:
        """Force-run until the queue (and, in continuous mode, every
        in-flight lane) is empty.  Bounded: batch mode completes at least
        one request per forced step, a continuous lane finishes within
        ``max_rounds`` ticks; past the budget it raises instead of
        spinning."""
        out: List[Request] = []
        if max_steps is None:
            pending = len(self.queue) + self.inflight()
            per = (self.cfg.max_rounds + 2) if self.continuous else 2
            max_steps = per * (pending + 1) + 16
        steps = 0
        while self.queue or (self.continuous and self.inflight()):
            if steps >= max_steps:
                raise RuntimeError(
                    f"drain() exceeded {max_steps} steps with "
                    f"{len(self.queue)} queued and {self.inflight()} "
                    "in-flight — a plan that cannot execute (or a stuck "
                    "lane) is spinning the loop")
            out.extend(self.step(force=True))
            steps += 1
        return out
