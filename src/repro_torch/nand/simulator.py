"""Trace-driven Proxima accelerator simulator (front-end in the spirit of the
paper's modified NeuroSIM; back-end = device.py timing/energy) — copy of
``src/repro/nand/simulator.py``.  The one change is at the counter reads:
the port's search results hold torch tensors, on the card or the CPU, so
``trace_from_search_result`` and ``traces_from_sharded_result`` read a
result's six traversal counters to the host in one copy
(``host_counters``) and average them with the reference's numpy
arithmetic.

Input: a ``WorkloadTrace`` built from REAL search-counter traces
(core/search.py SearchResult) — expansions, PQ distance counts, rerank
counts, hot-node hits — plus the data-layout bit widths (gap encoding).

Output: QPS, query latency, QPS/W, runtime breakdown (NAND access vs H-tree
vs engine compute), and core utilization, under an M/M/1-style contention
model across the 512 NAND cores. Reproduces the shapes of paper Figs 12-16.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np

from repro_torch.nand.device import NandConfig
from repro_torch.nand.engine import EngineConfig


@dataclasses.dataclass
class WorkloadTrace:
    """Per-query averages from a measured search run."""
    hops: float                 # vertex expansions (index fetches)
    pq: float                   # PQ distance computations (code fetches)
    acc: float                  # accurate distance computations (raw fetches)
    hot_hops: float = 0.0       # expansions served by hot-node repetition
    free_pq: float = 0.0        # PQ fetches covered by hot pages
    rounds: float = 0.0
    beam_width: float = 1.0     # E — expansions issued per traversal round;
                                # up to min(E, NandConfig.n_planes) of a
                                # round's page reads overlap on parallel
                                # planes, shortening the serial pointer-chase
    dim: int = 128
    r_degree: int = 64
    index_bits: int = 32        # 32 uncompressed; 20-26 gap-encoded
    pq_bits: int = 256          # M=32 x 8b codes
    raw_bytes: int = 512        # D x fp32
    metric: str = "l2"
    use_pq: bool = True
    # --- filtered-query billing (repro.filter) -----------------------------
    attr_bits: int = 0          # per-node attribute word (page spare area)
    filter_mode: str = "off"    # off | pushdown | host — where the
                                # predicate is evaluated (see
                                # _accesses_per_query for the billing split)
    filter_selectivity: float = 1.0  # passing fraction of scored candidates


def logical_insert_bytes(dim: int, pq_bits: int, r_degree: int,
                         index_bits: int) -> float:
    """Bytes one insert adds to the NAND-resident index: raw vector + PQ
    code + one adjacency row. Shared by the analytic update model below and
    the live delta segment's write accounting (stream.delta) so the two
    cannot drift."""
    return dim * 4 + pq_bits / 8.0 + r_degree * index_bits / 8.0


@dataclasses.dataclass
class UpdateTrace:
    """Streaming-update workload: online inserts/deletes buffered in a DRAM
    delta segment, folded into NAND by periodic consolidation (the
    ``stream.MutableIndex`` serving model). NAND sees no per-insert program;
    it sees the consolidation rewrite — that rewrite/logical ratio IS the
    subsystem's write amplification."""
    insert_rate: float = 0.0          # inserts per second offered
    delete_rate: float = 0.0          # deletes per second offered
    corpus_size: int = 1_000_000      # live vectors at steady state
    consolidate_fraction: float = 0.25  # delta/base fraction triggering rebuild
    dim: int = 128
    r_degree: int = 64
    index_bits: int = 32
    pq_bits: int = 256

    @property
    def bytes_per_insert(self) -> float:
        return logical_insert_bytes(self.dim, self.pq_bits, self.r_degree,
                                    self.index_bits)


@dataclasses.dataclass
class UpdateSimResult:
    update_throughput_per_s: float    # max sustainable inserts/sec
    program_mb_per_s: float           # NAND program bandwidth at offered rate
    write_amplification: float        # programmed / logical bytes
    program_energy_pj_per_insert: float
    erase_energy_pj_per_insert: float
    update_power_w: float             # program+erase power at offered rate
    program_busy_fraction: float      # share of core-time spent programming
    endurance_years: float            # to SLC P/E limit at offered rate

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SimResult:
    qps: float
    latency_us: float
    qps_per_watt: float
    power_w: float
    core_utilization: float
    breakdown: Dict[str, float]          # fractional runtime shares
    traffic_bytes_per_query: Dict[str, float]
    transfer_pj_per_query: float = 0.0   # H-tree channel-transfer energy —
                                         # the quantity predicate pushdown
                                         # shrinks vs host-side filtering
    round_latency_us: float = 0.0        # ONE traversal round's critical
                                         # path: read + score sequential, or
                                         # max(read, score) double-buffered
    overlap_saved_us: float = 0.0        # per-query latency hidden by the
                                         # double-buffered channel (0 when
                                         # NandConfig.double_buffer is off)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def metrics(self) -> dict:
        """Flat name -> value mapping for the observability registry
        (``repro.obs.record_plan_execution``): the per-query cost figures
        serving snapshots report next to host wall-time percentiles.
        ``nand_pj_per_query`` is TOTAL power (NAND array + CMOS engine)
        amortized per query at the modeled QPS."""
        return {
            "nand_latency_us": self.latency_us,
            "nand_model_qps": self.qps,
            "nand_power_w": self.power_w,
            "nand_pj_per_query": self.power_w / max(self.qps, 1e-12) * 1e12,
            "nand_transfer_pj_per_query": self.transfer_pj_per_query,
            "nand_core_utilization": self.core_utilization,
            "nand_round_latency_us": self.round_latency_us,
            "nand_overlap_saved_us": self.overlap_saved_us,
        }


def _transfer_pj(traffic: Dict[str, float], nand: NandConfig) -> float:
    """Channel-transfer energy of the per-query H-tree traffic (continuous
    window billing — strictly monotone in bytes, so a strict byte saving is
    a strict energy saving)."""
    per_window = nand.e_core_htree_pj + nand.e_tile_htree_pj
    return sum(traffic.values()) / nand.page_bytes * per_window


def _accesses_per_query(t: WorkloadTrace, nand: NandConfig):
    """Returns (WL activations, core-busy ns, traffic bytes by category).

    Each access = one WL activation; extra bytes beyond the MUX window add
    transfer time only (device.access_latency_ns). Hot hops read the
    co-located index+codes record in a single activation (§IV-E).

    Filtered queries split by where the predicate runs:

      * ``pushdown`` — each neighbour's attribute word sits in the spare
        area of the adjacency page, so the expansion's WL activation
        already returns it (extra transfer bytes, no extra activation);
        the tile drops non-passing candidates BEFORE channel transfer, so
        only ``filter_selectivity`` of the candidate stream crosses the
        H-tree.
      * ``host`` — attribute words ride with the candidate's PQ record and
        every candidate (plus its attribute word) crosses the channel for
        host-side evaluation: the ``attrs`` traffic category is the
        pushdown path's saving.
    """
    cold_hops = max(t.hops - t.hot_hops, 0.0)
    attr_each = t.attr_bits / 8.0 if t.filter_mode != "off" else 0.0
    idx_xfer_each = t.r_degree * t.index_bits / 8.0
    hot_xfer_each = (t.r_degree * (t.index_bits + t.pq_bits) + t.pq_bits) / 8.0
    cold_pq = max(t.pq - t.free_pq, 0.0)
    pq_xfer_each = t.pq_bits / 8.0
    # bytes READ from the array per activation may exceed bytes that cross
    # the channel: pushdown consumes the spare-area attr words in-tile
    idx_read_each, hot_read_each, pq_read_each = \
        idx_xfer_each, hot_xfer_each, pq_xfer_each
    if t.filter_mode == "pushdown":
        # spare-area co-location: R neighbour attr words per adjacency read
        idx_read_each += t.r_degree * attr_each
        hot_read_each += t.r_degree * attr_each
    elif t.filter_mode == "host":
        # attr word rides with the candidate record AND crosses the channel
        pq_read_each += attr_each

    n_access = cold_hops * (1 + cold_pq / max(cold_hops, 1.0)) \
        + t.hot_hops + t.acc
    busy_ns = (
        cold_hops * nand.access_latency_ns(int(idx_read_each))
        + t.hot_hops * nand.access_latency_ns(int(hot_read_each))
        + cold_pq * nand.access_latency_ns(int(pq_read_each))
        + t.acc * nand.access_latency_ns(t.raw_bytes)
    )
    energy_pj = (
        cold_hops * nand.access_energy_pj(int(idx_read_each))
        + t.hot_hops * nand.access_energy_pj(int(hot_read_each))
        + cold_pq * nand.access_energy_pj(int(pq_read_each))
        + t.acc * nand.access_energy_pj(t.raw_bytes)
    )
    pass_frac = (
        min(max(t.filter_selectivity, 0.0), 1.0)
        if t.filter_mode == "pushdown" else 1.0
    )
    traffic = {
        "index": cold_hops * idx_xfer_each + t.hot_hops * hot_xfer_each,
        "pq_codes": cold_pq * pq_xfer_each * pass_frac,
        "raw": t.acc * t.raw_bytes,
        "attrs": cold_pq * attr_each if t.filter_mode == "host" else 0.0,
    }
    return n_access, busy_ns, energy_pj, traffic


def _engine_ns_per_query(t: WorkloadTrace, eng: EngineConfig) -> float:
    ns = eng.adt_latency_ns(t.dim, t.metric) if t.use_pq else 0.0
    per_round_pq = t.pq / max(t.rounds, 1.0)
    ns += t.rounds * (
        eng.pq_batch_latency_ns(per_round_pq)
        + eng.sorter_latency_ns()
        + 1.0  # bloom
    )
    ns += t.acc * eng.acc_latency_ns(t.dim)
    return ns


def simulate_updates(
    u: UpdateTrace,
    nand: NandConfig = NandConfig(),
) -> UpdateSimResult:
    """Program/erase cost of the streaming-update path.

    One consolidation cycle: ``consolidate_fraction * corpus_size`` inserts
    accumulate in DRAM, then the rebuilt index — every live vector's raw
    data + PQ code + adjacency row — is reprogrammed and the superseded
    blocks erased. Deletes add no program traffic of their own but shrink
    the live set the rewrite carries."""
    frac = max(u.consolidate_fraction, 1e-6)
    inserts_per_cycle = max(frac * u.corpus_size, 1.0)
    pvb = u.bytes_per_insert
    live_after = u.corpus_size * (1.0 + frac)
    if u.insert_rate > 0:
        live_after -= u.delete_rate / u.insert_rate * inserts_per_cycle
    live_after = max(live_after, inserts_per_cycle)
    rewrite_bytes = live_after * pvb
    logical_bytes = inserts_per_cycle * pvb
    wa = rewrite_bytes / logical_bytes

    prog_ns_cycle = nand.program_latency_ns(int(rewrite_bytes))
    erase_ns_cycle = nand.erase_latency_ns(int(rewrite_bytes))
    core_ns_cycle = (prog_ns_cycle + erase_ns_cycle) / nand.n_cores
    max_rate = inserts_per_cycle / (core_ns_cycle * 1e-9)

    e_prog_cycle = nand.program_energy_pj(int(rewrite_bytes))
    e_erase_cycle = nand.erase_energy_pj(int(rewrite_bytes))
    e_prog_ins = e_prog_cycle / inserts_per_cycle
    e_erase_ins = e_erase_cycle / inserts_per_cycle

    rate = u.insert_rate
    busy_frac = min(rate / max_rate, 1.0) if max_rate > 0 else 0.0
    power_w = rate * (e_prog_ins + e_erase_ins) * 1e-12
    prog_mb_s = rate * pvb * wa / 1e6

    # endurance: bytes erased per second wear the whole array uniformly
    # (consolidation is a sequential full rewrite -> perfect wear leveling)
    cap_bytes = nand.capacity_bits / 8.0
    bytes_per_s = rate * pvb * wa
    if bytes_per_s > 0:
        pe_per_s = bytes_per_s / cap_bytes
        endurance_years = nand.pe_cycle_limit / pe_per_s / (365.25 * 86400)
    else:
        endurance_years = float("inf")
    return UpdateSimResult(
        update_throughput_per_s=max_rate,
        program_mb_per_s=prog_mb_s,
        write_amplification=wa,
        program_energy_pj_per_insert=e_prog_ins,
        erase_energy_pj_per_insert=e_erase_ins,
        update_power_w=power_w,
        program_busy_fraction=busy_frac,
        endurance_years=endurance_years,
    )


@dataclasses.dataclass
class BuildTrace:
    """Offline segmented-build workload (``core.segmented``): each emitted
    segment programs its artifacts — raw vectors + PQ codes + adjacency
    rows, the same per-vertex record ``logical_insert_bytes`` prices for
    the streaming path — ONCE; cross-segment stitching then re-programs the
    adjacency rows it patched (erase + program of superseded rows).  The
    (logical + stitch) / logical ratio is the BUILD-time write
    amplification, reported next to serve-time reads."""
    segment_sizes: tuple              # vertices emitted per segment
    stitched_rows: int = 0            # adjacency rows rewritten by stitching
    dim: int = 128
    r_degree: int = 64
    index_bits: int = 32
    pq_bits: int = 256

    @property
    def bytes_per_vertex(self) -> float:
        return logical_insert_bytes(self.dim, self.pq_bits, self.r_degree,
                                    self.index_bits)

    @property
    def row_bytes(self) -> float:
        """One adjacency row — the unit stitching rewrites."""
        return self.r_degree * self.index_bits / 8.0


@dataclasses.dataclass
class BuildSimResult:
    build_seconds: float              # NAND program/erase time, all segments
    program_mb: float                 # total bytes programmed
    write_amplification: float        # programmed / logical bytes
    program_energy_uj: float
    erase_energy_uj: float
    per_segment_seconds: tuple        # program time per emitted segment

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def simulate_build(
    b: BuildTrace,
    nand: NandConfig = NandConfig(),
) -> BuildSimResult:
    """Program/erase cost of the segmented offline build.

    Segments are billed independently (each emission is one sequential
    program burst across the cores); stitch patches additionally erase the
    superseded adjacency rows and program the rewritten ones — reusing the
    same ``NandConfig`` program/erase model as :func:`simulate_updates`, so
    build-time and serve-time write amplification share one price list."""
    pvb = b.bytes_per_vertex
    seg_seconds = []
    e_prog = 0.0
    for n_seg in b.segment_sizes:
        seg_bytes = n_seg * pvb
        ns = nand.program_latency_ns(int(seg_bytes)) / nand.n_cores
        seg_seconds.append(ns * 1e-9)
        e_prog += nand.program_energy_pj(int(seg_bytes))

    logical = sum(b.segment_sizes) * pvb
    stitch_bytes = b.stitched_rows * b.row_bytes
    programmed = logical + stitch_bytes
    e_erase = 0.0
    stitch_ns = 0.0
    if b.stitched_rows:  # the device model floors at one page/block
        e_prog += nand.program_energy_pj(int(stitch_bytes))
        e_erase = nand.erase_energy_pj(int(stitch_bytes))
        stitch_ns = (
            nand.program_latency_ns(int(stitch_bytes))
            + nand.erase_latency_ns(int(stitch_bytes))
        ) / nand.n_cores

    return BuildSimResult(
        build_seconds=sum(seg_seconds) + stitch_ns * 1e-9,
        program_mb=programmed / 1e6,
        write_amplification=programmed / max(logical, 1e-12),
        program_energy_uj=e_prog / 1e6,
        erase_energy_uj=e_erase / 1e6,
        per_segment_seconds=tuple(seg_seconds),
    )


def simulate(
    trace: WorkloadTrace,
    nand: NandConfig = NandConfig(),
    eng: EngineConfig = EngineConfig(),
    n_queues: int | None = None,
    iters: int = 40,
    available_core_fraction: float = 1.0,
) -> SimResult:
    nq = n_queues if n_queues is not None else eng.n_queues
    t_core = nand.read_latency_ns()
    accesses, busy_ns_q, energy_pj_q, traffic = _accesses_per_query(trace, nand)
    # update programs steal core-time from reads (mixed read/write serving)
    busy_ns_q = busy_ns_q / max(available_core_fraction, 0.05)
    engine_ns = _engine_ns_per_query(trace, eng)

    cold_hops = max(trace.hops - trace.hot_hops, 0.0)
    hot_bytes_each = (
        trace.r_degree * (trace.index_bits + trace.pq_bits) + trace.pq_bits
    ) / 8.0
    # critical path: per cold hop an index fetch followed by one (parallel)
    # neighbour-code wave; per hot hop one single-shot activation. With
    # beam-parallel traversal the E expansions of one round are concurrent
    # page reads on independent planes, so the serial chain is divided by
    # the realized plane parallelism min(E, n_planes) — rounds, not hops,
    # set the pointer-chase length.
    par = max(1.0, min(trace.beam_width, float(nand.n_planes)))
    s_t0 = (
        cold_hops * 2.0 * t_core / par
        + trace.hot_hops * nand.access_latency_ns(int(hot_bytes_each)) / par
        + 2.0 * t_core  # rerank waves (pipelined raw fetches)
    )

    # contention equilibrium (M/M/1 per core):
    #   latency = S/(1-rho) + E,  rho = QPS*busy/C,  QPS = Nq/latency
    # -> quadratic  -E rho^2 + (S + E + K) rho - K = 0,  K = Nq*busy/C
    e_ns = engine_ns
    k = nq * busy_ns_q / nand.n_cores
    if e_ns > 1e-12:
        b = s_t0 + e_ns + k
        disc = max(b * b - 4.0 * e_ns * k, 0.0)
        rho = (b - math.sqrt(disc)) / (2.0 * e_ns)
    else:
        rho = k / (s_t0 + k)
    rho = min(max(rho, 0.0), 0.95)
    lat_ns = s_t0 / max(1.0 - rho, 0.05) + e_ns

    # --- double-buffered channel (NDSEARCH-style round pipelining) ---------
    # With a double-buffered page buffer the page reads for round t+1 issue
    # while the CMOS engine scores round t, so a steady-state round's
    # critical path is max(read, score) instead of read + score.  Core BUSY
    # time is unchanged (the work still happens — overlap hides latency,
    # not occupancy), so rho and power are untouched; the pipeline saves
    # min(read, score) per round after the one fill round.
    rounds = max(trace.rounds, 1.0)
    read_chain_ns = max(s_t0 - 2.0 * t_core, 0.0)   # minus the rerank waves
    per_round_read = read_chain_ns / rounds / max(1.0 - rho, 0.05)
    per_round_pq = trace.pq / rounds
    per_round_score = (
        eng.pq_batch_latency_ns(per_round_pq) + eng.sorter_latency_ns() + 1.0
    )
    if nand.double_buffer:
        round_ns = max(per_round_read, per_round_score)
        overlap_ns = (rounds - 1.0) * min(per_round_read, per_round_score)
        lat_ns = max(lat_ns - overlap_ns, round_ns)
    else:
        round_ns = per_round_read + per_round_score
        overlap_ns = 0.0
    qps = nq / (lat_ns * 1e-9)

    # --- power
    p_nand_w = qps * energy_pj_q * 1e-12
    busy_frac = min(qps * engine_ns * 1e-9 / nq, 1.0)
    queue_scale = nq / 256.0
    p_engine_w = (
        eng.p_static_mw * queue_scale
        + eng.p_dynamic_mw * busy_frac * queue_scale
    ) * 1e-3
    power = p_nand_w + p_engine_w

    nand_ns = s_t0 / max(1.0 - rho, 0.05)
    bus_ns = sum(traffic.values()) / nand.bus_bytes_per_ns / max(nand.n_cores / 8, 1)
    total = nand_ns + bus_ns + engine_ns
    return SimResult(
        qps=qps,
        latency_us=lat_ns * 1e-3,
        qps_per_watt=qps / max(power, 1e-9),
        power_w=power,
        core_utilization=rho,
        breakdown={
            "nand_access": nand_ns / total,
            "htree_bus": bus_ns / total,
            "engine": engine_ns / total,
        },
        traffic_bytes_per_query=traffic,
        transfer_pj_per_query=_transfer_pj(traffic, nand),
        round_latency_us=round_ns * 1e-3,
        overlap_saved_us=overlap_ns * 1e-3,
    )


@dataclasses.dataclass
class MixedSimResult:
    """Read + update serving on the same cores."""
    read: SimResult
    update: UpdateSimResult
    qps: float                        # read QPS under update contention
    update_rate: float                # offered inserts/sec
    total_power_w: float
    qps_per_watt: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def simulate_mixed(
    trace: WorkloadTrace,
    updates: UpdateTrace,
    nand: NandConfig = NandConfig(),
    eng: EngineConfig = EngineConfig(),
    n_queues: int | None = None,
) -> MixedSimResult:
    """Mixed read/write serving: the update stream's program/erase busy
    fraction derates the cores available to reads."""
    upd = simulate_updates(updates, nand)
    read = simulate(
        trace, nand, eng, n_queues=n_queues,
        available_core_fraction=1.0 - min(upd.program_busy_fraction, 0.95),
    )
    power = read.power_w + upd.update_power_w
    return MixedSimResult(
        read=read,
        update=upd,
        qps=read.qps,
        update_rate=updates.insert_rate,
        total_power_w=power,
        qps_per_watt=read.qps / max(power, 1e-9),
    )


def filter_comparison(
    trace: WorkloadTrace,
    nand: NandConfig = NandConfig(),
    eng: EngineConfig = EngineConfig(),
    n_queues: int | None = None,
) -> dict:
    """Near-storage predicate pushdown vs host-side filtering for the SAME
    measured trace: the pushdown path bills attribute words as spare-area
    reads co-located with adjacency pages and lets only passing candidates
    cross the channel; the host path ships every candidate plus its
    attribute word. Returns both SimResults and the savings ratios.
    ``trace.attr_bits`` must be set (> 0) for the comparison to bite."""
    push = simulate(dataclasses.replace(trace, filter_mode="pushdown"),
                    nand, eng, n_queues=n_queues)
    host = simulate(dataclasses.replace(trace, filter_mode="host"),
                    nand, eng, n_queues=n_queues)
    return {
        "pushdown": push,
        "host": host,
        "transfer_bytes_saved": (
            sum(host.traffic_bytes_per_query.values())
            - sum(push.traffic_bytes_per_query.values())
        ),
        "transfer_energy_ratio": (
            push.transfer_pj_per_query / max(host.transfer_pj_per_query, 1e-12)
        ),
        "latency_speedup": host.latency_us / max(push.latency_us, 1e-12),
        "qps_per_watt_gain": (
            push.qps_per_watt / max(host.qps_per_watt, 1e-12)
        ),
    }


COUNTERS = ("n_hops", "n_pq", "n_acc", "n_hot_hops", "n_free_pq", "rounds")


def host_counters(res) -> dict:
    """``{field: np.ndarray}`` of the six traversal counters of a core
    ``SearchResult`` (any leading axes), read to the host in ONE copy: the
    counters are stacked where they live (the card or the CPU) and moved
    with one ``.cpu()``.  Host arrays pass through."""
    xs = [getattr(res, f) for f in COUNTERS]
    if not hasattr(xs[0], "cpu"):
        return {f: np.asarray(x) for f, x in zip(COUNTERS, xs)}
    import torch

    host = torch.stack([x.to(torch.int64) for x in xs]).cpu().numpy()
    return dict(zip(COUNTERS, host))


def _workload_trace(c: dict, tile_axis: bool, *, dim, r_degree, index_bits,
                    pq_bits, metric, use_pq, use_hot, beam_width, attr_bits,
                    filter_mode, filter_selectivity) -> WorkloadTrace:
    """Per-query mean counters (``host_counters``' arrays; with
    ``tile_axis`` the (P, Q) counters are summed over the tiles first) ->
    ``WorkloadTrace``."""
    if tile_axis:
        f = lambda x: float(x.sum(0).mean())
    else:
        f = lambda x: float(x.mean())
    hops, rounds = f(c["n_hops"]), f(c["rounds"])
    if beam_width is None:
        beam_width = hops / max(rounds, 1.0)
    return WorkloadTrace(
        hops=hops, pq=f(c["n_pq"]), acc=f(c["n_acc"]),
        hot_hops=f(c["n_hot_hops"]) if use_hot else 0.0,
        free_pq=f(c["n_free_pq"]) if use_hot else 0.0,
        rounds=rounds, beam_width=max(float(beam_width), 1.0),
        dim=dim, r_degree=r_degree,
        index_bits=index_bits, pq_bits=pq_bits, raw_bytes=dim * 4,
        metric=metric, use_pq=use_pq,
        attr_bits=attr_bits, filter_mode=filter_mode,
        filter_selectivity=filter_selectivity,
    )


def trace_from_search_result(res, *, dim, r_degree, index_bits, pq_bits,
                             metric="l2", use_pq=True, use_hot=True,
                             beam_width=None, attr_bits=0,
                             filter_mode="off",
                             filter_selectivity=1.0) -> WorkloadTrace:
    """Average the per-query counters of a core.search SearchResult.

    A ``shard.ShardedSearchResult`` is accepted too: its (P, Q) counters are
    summed across the tile axis first, so the trace carries the TOTAL work a
    query costs across all channels (use ``traces_from_sharded_result`` +
    ``simulate_sharded`` for the per-channel view).

    ``beam_width`` defaults to the REALIZED per-round expansion parallelism
    measured from the counters themselves (mean hops / mean rounds — the
    n_hops-vs-rounds separation core.search maintains); pass the configured
    ``SearchConfig.beam_width`` explicitly to bill the nominal E instead.

    A ``filter.FilteredSearchResult`` is accepted too (its ``.result``
    counters are used, and ``filter_selectivity`` defaults to the result's
    measured selectivity); set ``attr_bits``/``filter_mode`` to bill the
    predicate evaluation (see ``filter_comparison``)."""
    if hasattr(res, "mode") and hasattr(res, "result"):   # FilteredSearchResult
        if filter_selectivity == 1.0:
            # traversal mode scores the full frontier, of which only
            # `selectivity` passes; scan mode's candidate stream is the
            # passing subset itself — every scored candidate crosses, so
            # pushdown must not discount it
            filter_selectivity = (
                res.selectivity if res.mode == "traversal" else 1.0
            )
        res = res.result
    tile_axis = hasattr(res, "per_tile")
    return _workload_trace(
        host_counters(res.per_tile if tile_axis else res), tile_axis,
        dim=dim, r_degree=r_degree, index_bits=index_bits, pq_bits=pq_bits,
        metric=metric, use_pq=use_pq, use_hot=use_hot, beam_width=beam_width,
        attr_bits=attr_bits, filter_mode=filter_mode,
        filter_selectivity=filter_selectivity,
    )


def traces_from_sharded_result(res, *, dim, r_degree, index_bits, pq_bits,
                               metric="l2", use_pq=True, use_hot=True,
                               beam_width=None, attr_bits=0,
                               filter_mode="off",
                               filter_selectivity=1.0) -> list[WorkloadTrace]:
    """Per-tile workload traces from a ``shard.ShardedSearchResult`` — the
    per-tile counter axis maps 1:1 onto NAND channel groups. ``beam_width``
    propagates to every channel trace (None -> realized hops/rounds,
    measured per tile); so do the filter billing knobs.  The (P, Q)
    counters come to the host in one copy."""
    per = res.per_tile if hasattr(res, "per_tile") else res
    c = host_counters(per)
    return [
        _workload_trace(
            {f: x[p] for f, x in c.items()}, False,
            dim=dim, r_degree=r_degree, index_bits=index_bits,
            pq_bits=pq_bits, metric=metric, use_pq=use_pq, use_hot=use_hot,
            beam_width=beam_width, attr_bits=attr_bits,
            filter_mode=filter_mode, filter_selectivity=filter_selectivity,
        )
        for p in range(per.ids.shape[0])
    ]


# ---------------------------------------------------------------------------
# Channel-parallel (sharded) serving model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedSimResult:
    """Multi-channel serving: P tiles, each on its own slice of the NAND
    cores, every query fanned out to all channels and merged by the shared
    bitonic sorter."""
    per_channel: list                     # SimResult per channel group
    qps: float                            # aggregate (straggler-bound)
    latency_us: float                     # max channel latency + merge pass
    qps_per_watt: float
    power_w: float
    channel_utilization: list             # per-channel rho
    load_imbalance: float                 # max/mean channel busy-time
    merge_overhead_us: float              # cross-tile bitonic merge per query

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["per_channel"] = [r.to_dict() for r in self.per_channel]
        return d


def _with_cores(nand: NandConfig, cores: int) -> NandConfig:
    """A NandConfig whose core count is one channel group's share."""
    cores = max(int(cores), 1)
    if cores % nand.cores_per_tile == 0:
        return dataclasses.replace(nand, n_tiles=cores // nand.cores_per_tile)
    return dataclasses.replace(nand, n_tiles=1, cores_per_tile=cores)


def simulate_sharded(
    traces: list,
    nand: NandConfig = NandConfig(),
    eng: EngineConfig = EngineConfig(),
    n_queues: int | None = None,
    available_core_fraction: float = 1.0,
) -> ShardedSimResult:
    """Serve one query stream over P corpus tiles on channel-partitioned
    cores.

    Each of the P tiles gets ``n_cores / P`` cores; a query runs on every
    channel concurrently (per-tile traversal of a 1/P-size graph), so query
    latency is the slowest channel's latency plus one cross-tile bitonic
    merge pass, and the engine's N_q queues bound concurrency exactly as in
    the single-tile model. Per-tile traces carry less work per query than
    the single-tile trace (shorter traversals on smaller graphs), which is
    where the channel-level bandwidth win comes from; imbalance across
    channels (allocation-policy dependent) shows up as straggler latency.

    With routed probing (``shard.sharded_search(probe_tiles=...)``) the
    skipped lanes arrive zeroed, so each per-tile trace is the channel's
    work amortized over ALL arriving queries — correct for throughput and
    utilization; per-query latency of the probed subset is then slightly
    underestimated (amortized chain length < probed chain length).
    """
    if not traces:
        raise ValueError("need at least one per-tile trace")
    p = len(traces)
    nq = n_queues if n_queues is not None else eng.n_queues
    ch_nand = _with_cores(nand, nand.n_cores // p)
    per = [
        simulate(t, ch_nand, eng, n_queues=nq,
                 available_core_fraction=available_core_fraction)
        for t in traces
    ]
    merge_us = eng.sorter_latency_ns() * 1e-3
    lat_us = max(r.latency_us for r in per) + merge_us
    qps = nq / (lat_us * 1e-6)

    # power: every channel pays its NAND access energy at the aggregate
    # query rate; the CMOS engine is shared and counted once
    e_nand_pj = sum(_accesses_per_query(t, ch_nand)[2] for t in traces)
    p_nand_w = qps * e_nand_pj * 1e-12
    engine_ns = max(_engine_ns_per_query(t, eng) for t in traces)
    busy_frac = min(qps * engine_ns * 1e-9 / nq, 1.0)
    queue_scale = nq / 256.0
    p_engine_w = (
        eng.p_static_mw * queue_scale
        + eng.p_dynamic_mw * busy_frac * queue_scale
    ) * 1e-3
    power = p_nand_w + p_engine_w

    busy = [_accesses_per_query(t, ch_nand)[1] for t in traces]
    imbalance = max(busy) / max(sum(busy) / p, 1e-9)
    return ShardedSimResult(
        per_channel=per,
        qps=qps,
        latency_us=lat_us,
        qps_per_watt=qps / max(power, 1e-9),
        power_w=power,
        channel_utilization=[r.core_utilization for r in per],
        load_imbalance=imbalance,
        merge_overhead_us=merge_us,
    )


# ---------------------------------------------------------------------------
# Plan-derived billing (repro.plan)
# ---------------------------------------------------------------------------

def _plan_geometry(index, dim, r_degree, index_bits, pq_bits) -> dict:
    """Resolve trace geometry from an index handle (a ``ProximaIndex``; a
    ``stream.MutableIndex`` once ported) unless given explicitly."""
    if index is not None:
        base = index.base if hasattr(index, "delta") and \
            hasattr(index, "base") else index
        dim = base.dataset.dim if dim is None else dim
        r_degree = base.graph.adjacency.shape[1] if r_degree is None \
            else r_degree
        index_bits = (base.gap.bit_width if base.gap else 32) \
            if index_bits is None else index_bits
        pq_bits = 8 * base.codes.shape[1] if pq_bits is None else pq_bits
    missing = [n for n, v in (("dim", dim), ("r_degree", r_degree),
                              ("index_bits", index_bits),
                              ("pq_bits", pq_bits)) if v is None]
    if missing:
        raise ValueError(
            f"trace geometry underspecified: pass index= or {missing}"
        )
    return dict(dim=dim, r_degree=r_degree, index_bits=index_bits,
                pq_bits=pq_bits)


def _plan_filter_billing(pres) -> dict:
    """Filter billing facts read off the executed plan: where the predicate
    ran (pushdown vs host), the attribute-word width, and the passing
    fraction of the scored candidate stream (scan mode's candidates are the
    passing subset itself — every scored candidate crosses the channel, so
    pushdown must not discount it)."""
    plan = pres.plan
    filtered = plan.strategy not in ("none",)
    if not filtered:
        return dict(attr_bits=0, filter_mode="off", filter_selectivity=1.0)
    sel = pres.stats.selectivity if plan.strategy in ("masked", "adaptive") \
        else 1.0
    # a merged plan defers the regime choice to execute time; when its base
    # actually ran the bitmap scan, the scored candidates ARE the passing
    # subset and every one crosses the channel — no pushdown discount
    if plan.strategy == "adaptive" and \
            getattr(pres.raw, "base_mode", None) in ("scan", "empty"):
        sel = 1.0
    return dict(
        attr_bits=plan.attr_bits,
        filter_mode="pushdown" if plan.pushdown else "host",
        filter_selectivity=float(sel),
    )


def _plan_counters(pres):
    """The counter-carrying kernel result inside a plan execution."""
    raw = pres.raw
    if hasattr(raw, "delta_candidates"):      # MergedResult: bill the base
        return raw.base
    if hasattr(raw, "n_hops") or hasattr(raw, "per_tile") \
            or hasattr(raw, "result"):        # core / sharded / filtered
        return raw
    raise ValueError(                         # distributed (ids, dists) pair
        "distributed plan executions carry no NAND counters — bill a "
        "flat/tiled/merged execution of the same workload instead"
    )


def trace_from_plan_execution(pres, *, index=None, dim=None, r_degree=None,
                              index_bits=None, pq_bits=None, use_hot=True,
                              beam_width=None) -> WorkloadTrace:
    """One aggregate ``WorkloadTrace`` from a ``repro.plan.SearchResult`` —
    billing derived from the PLAN (filter strategy, selectivity, attribute
    word width, metric, PQ use) instead of hand-threaded per-path trace
    constructor arguments. Geometry comes from ``index=`` (the served
    ``ProximaIndex``/``MutableIndex``) or the explicit kwargs.

    ``beam_width`` follows ``trace_from_search_result``: None bills the
    REALIZED per-round parallelism measured from the counters; pass
    ``pres.plan.cfg.beam_width`` to bill the nominal E instead."""
    plan = pres.plan
    geo = _plan_geometry(index, dim, r_degree, index_bits, pq_bits)
    fb = _plan_filter_billing(pres)
    return trace_from_search_result(
        _plan_counters(pres), metric=plan.metric, use_pq=plan.cfg.use_pq,
        use_hot=use_hot, beam_width=beam_width, **geo, **fb,
    )


def traces_from_plan_execution(pres, *, index=None, dim=None, r_degree=None,
                               index_bits=None, pq_bits=None, use_hot=True,
                               beam_width=None) -> list:
    """Per-channel ``WorkloadTrace`` list from a tiled plan execution (the
    input ``simulate_sharded`` consumes); the execution's raw result must
    carry a per-tile counter axis (a tiled plan, or a merged plan over a
    tiled base)."""
    plan = pres.plan
    geo = _plan_geometry(index, dim, r_degree, index_bits, pq_bits)
    fb = _plan_filter_billing(pres)
    counters = _plan_counters(pres)
    if not hasattr(counters, "per_tile"):
        raise ValueError(
            "plan execution has no per-tile counter axis — use "
            "trace_from_plan_execution for flat/merged-over-flat plans"
        )
    return traces_from_sharded_result(
        counters, metric=plan.metric, use_pq=plan.cfg.use_pq,
        use_hot=use_hot, beam_width=beam_width, **geo, **fb,
    )
