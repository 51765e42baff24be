"""Metrics registry — labeled counters, gauges, and fixed-bucket histograms;
copy of ``src/repro/obs/registry.py`` (pure Python).

The serving stack's one measurement sink: every layer (``ServingEngine``,
``QueryPlanner``, the CUDA kernel wrappers, the NAND cost bridge) records
into a shared :class:`MetricsRegistry`, and ``snapshot()`` renders the whole
system state — queue-wait and latency percentiles, batch occupancy,
plan-cache hit rates, per-batch NAND energy — as one plain dict (JSON-ready,
the ``BENCH_serving.json`` perf-trajectory format).

Histograms use fixed log-spaced buckets (Prometheus-style, never a sample
reservoir): ``observe`` is O(log buckets) with bounded memory, and
``p50/p95/p99`` are estimated by linear interpolation inside the covering
bucket — relative error is bounded by the bucket ratio (~8% at the default
16 buckets/decade; see tests/test_obs.py for the numpy.percentile check).

Zero-cost-when-off: a registry constructed with ``enabled=False`` (what
``NULL_REGISTRY`` is) returns from every record call on the first branch and
allocates nothing — the serving hot path pays one attribute load + one
predictable branch per call site, asserted under 5% of dispatch cost by
``benchmarks/planner_bench``.
"""
from __future__ import annotations

import json
import math
from bisect import bisect_right
from typing import Dict, Optional, Tuple

# default bucket geometry: 16 log-spaced buckets per decade covering
# microseconds-to-picojoule magnitudes (1e-6 .. 1e12) — one shared edge
# tuple, computed once, reused by every histogram instance
_BUCKETS_PER_DECADE = 16
_DECADE_LO, _DECADE_HI = -6, 12


def _default_edges() -> Tuple[float, ...]:
    n = (_DECADE_HI - _DECADE_LO) * _BUCKETS_PER_DECADE
    return tuple(
        10.0 ** (_DECADE_LO + i / _BUCKETS_PER_DECADE) for i in range(n + 1)
    )


_DEFAULT_EDGES = _default_edges()

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: dict) -> LabelKey:
    """Canonical hashable label identity (sorted, values stringified)."""
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items() if v is not None))


def _label_str(key: LabelKey) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


class Histogram:
    """Fixed-bucket histogram with interpolated quantile estimation."""

    __slots__ = ("edges", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, edges: Tuple[float, ...] = _DEFAULT_EDGES):
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)   # +underflow/overflow slots
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            return
        self.counts[bisect_right(self.edges, v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def quantile(self, q: float) -> float:
        """Estimate the q-th percentile (q in [0, 100]) by linear
        interpolation inside the covering bucket, clamped to the observed
        [min, max] so the tails are exact."""
        if self.count == 0:
            return math.nan
        target = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.edges[i - 1] if 0 < i <= len(self.edges) \
                    else self.vmin
                hi = self.edges[i] if i < len(self.edges) else self.vmax
                lo = max(lo, self.vmin)
                hi = min(hi, self.vmax)
                if hi <= lo:
                    return min(max(lo, self.vmin), self.vmax)
                frac = (target - cum) / c
                return min(max(lo + frac * (hi - lo), self.vmin), self.vmax)
            cum += c
        return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.mean,
            "min": self.vmin if self.count else math.nan,
            "max": self.vmax if self.count else math.nan,
            "p50": self.quantile(50.0),
            "p95": self.quantile(95.0),
            "p99": self.quantile(99.0),
        }


class MetricsRegistry:
    """Counter / gauge / histogram store, keyed by (name, label set).

    ``counter`` accumulates, ``gauge`` overwrites, ``observe`` feeds the
    named histogram.  Label sets are fully isolated: two label combinations
    of the same name never share a cell (the multi-tenant accounting
    contract — tenant A's counters cannot bleed into tenant B's).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._counters: Dict[str, Dict[LabelKey, float]] = {}
        self._gauges: Dict[str, Dict[LabelKey, float]] = {}
        self._hists: Dict[str, Dict[LabelKey, Histogram]] = {}

    # ------------------------------------------------------------- recording
    def counter(self, name: str, value: float = 1.0, **labels) -> None:
        if not self.enabled:
            return
        cells = self._counters.setdefault(name, {})
        key = _label_key(labels)
        cells[key] = cells.get(key, 0.0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        self._gauges.setdefault(name, {})[_label_key(labels)] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        cells = self._hists.setdefault(name, {})
        key = _label_key(labels)
        hist = cells.get(key)
        if hist is None:
            hist = cells[key] = Histogram()
        hist.observe(value)

    # --------------------------------------------------------------- reading
    def counter_value(self, name: str, **labels) -> float:
        return self._counters.get(name, {}).get(_label_key(labels), 0.0)

    def counter_total(self, name: str) -> float:
        """Sum of a counter across every label set."""
        return sum(self._counters.get(name, {}).values())

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        return self._gauges.get(name, {}).get(_label_key(labels))

    def histogram(self, name: str, **labels) -> Optional[Histogram]:
        return self._hists.get(name, {}).get(_label_key(labels))

    def merged_histogram(self, name: str) -> Optional[Histogram]:
        """One histogram aggregating every label set of ``name`` (bucket
        counts add exactly — same fixed edges everywhere)."""
        cells = self._hists.get(name)
        if not cells:
            return None
        out = Histogram()
        for h in cells.values():
            for i, c in enumerate(h.counts):
                out.counts[i] += c
            out.count += h.count
            out.total += h.total
            out.vmin = min(out.vmin, h.vmin)
            out.vmax = max(out.vmax, h.vmax)
        return out

    def snapshot(self) -> dict:
        """The whole registry as one JSON-ready dict:
        ``{"counters": {name: {label_str: value}}, "gauges": {...},
        "histograms": {name: {label_str: {count,sum,mean,min,max,
        p50,p95,p99}}}}``."""
        return {
            "counters": {
                n: {_label_str(k): v for k, v in cells.items()}
                for n, cells in self._counters.items()
            },
            "gauges": {
                n: {_label_str(k): v for k, v in cells.items()}
                for n, cells in self._gauges.items()
            },
            "histograms": {
                n: {_label_str(k): h.snapshot() for k, h in cells.items()}
                for n, cells in self._hists.items()
            },
        }

    def to_json(self, path: Optional[str] = None, indent: int = 2) -> str:
        payload = json.dumps(self.snapshot(), indent=indent, sort_keys=True,
                             allow_nan=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(payload)
        return payload

    def clear(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()


#: the shared disabled registry — every record call is a no-op
NULL_REGISTRY = MetricsRegistry(enabled=False)
