"""Port of ``repro.obs``: metrics registry, per-request span tracing,
rebuild detection and NAND cost-accounting export.

    obs = Observability.on()                    # metrics + tracing + billing
    eng = ServingEngine(idx, obs=obs)
    ... serve ...
    obs.metrics.snapshot()                      # percentiles, counters, pJ/q
    obs.tracer.export("trace.json")             # open in ui.perfetto.dev

Everything is **off by default** (``NULL_OBS``): a disabled registry/tracer
is a shared no-op object and the instrumented call sites pay one branch.
With the hooks installed, the kernel wrappers (``kernels.ops``) count
calls and time every launch on the card with a pair of CUDA events, read
only after the batch's ids reached the host — observability adds no
synchronisation to a round.  Names that differ from the reference's:
``kernel_builds`` / ``kernel_build_growth`` (for ``jit_cache_entries`` /
``jit_cache_growth``) and ``kernel_launches{entry=}`` (for
``kernel_traces``); every other metric, span and label is the reference's.
"""
from __future__ import annotations

import dataclasses

from typing import Optional

from repro_torch.obs.convergence import ConvergenceLog, trace_session
from repro_torch.obs.kernelwatch import (
    KernelWatch, RecompileWarning, default_kernel_sources,
)
from repro_torch.obs.nand_bridge import record_plan_execution
from repro_torch.obs.quality import (
    QualityMonitor, SLOTarget, SLOTracker, wilson_interval,
)
from repro_torch.obs.registry import Histogram, MetricsRegistry, NULL_REGISTRY
from repro_torch.obs.tracing import NULL_SPAN, NULL_TRACER, Span, Tracer


@dataclasses.dataclass
class Observability:
    """The bundle every instrumented layer takes: one registry + one tracer
    (+ the per-batch NAND billing switch, + the optional quality layer: a
    shadow-recall :class:`QualityMonitor` and a per-round
    :class:`ConvergenceLog`).  Use :meth:`on` / :meth:`off`, or
    :meth:`resolve` to accept user input (None, a bundle, or a
    ``configs.base.ObsConfig``)."""
    metrics: MetricsRegistry
    tracer: Tracer
    nand_billing: bool = False
    quality: Optional[QualityMonitor] = None
    convergence: Optional[ConvergenceLog] = None

    @property
    def enabled(self) -> bool:
        return self.metrics.enabled or self.tracer.enabled

    @classmethod
    def on(cls, tracing: bool = True, nand_billing: bool = True,
           quality: bool = False, quality_sample_rate: float = 0.05,
           quality_seed: int = 0, convergence: bool = False,
           convergence_capacity: int = 1 << 16) -> "Observability":
        m = MetricsRegistry(enabled=True)
        return cls(metrics=m,
                   tracer=Tracer(enabled=tracing),
                   nand_billing=nand_billing,
                   quality=QualityMonitor(
                       m, sample_rate=quality_sample_rate,
                       seed=quality_seed) if quality else None,
                   convergence=ConvergenceLog(convergence_capacity)
                   if convergence else None)

    @classmethod
    def off(cls) -> "Observability":
        return NULL_OBS

    @classmethod
    def resolve(cls, obj) -> "Observability":
        """None -> the shared disabled bundle; an ``ObsConfig`` -> a fresh
        bundle per its flags; a bundle passes through."""
        if obj is None:
            return NULL_OBS
        if isinstance(obj, cls):
            return obj
        # configs.base.ObsConfig (duck-typed match; the import stays local
        # so the obs package keeps no top-level config dependency)
        if hasattr(obj, "metrics") and isinstance(obj.metrics, bool):
            from repro_torch.configs.base import upgrade_config

            # pre-quality pickled configs gain the newer fields here, with
            # schema-owned defaults instead of per-site getattr fallbacks
            obj = upgrade_config(obj)
            if not (obj.metrics or obj.tracing or obj.quality
                    or obj.convergence):
                return NULL_OBS
            # the quality monitor publishes into the registry, so enabling
            # it implies a live registry even when metrics was left False
            m = MetricsRegistry(enabled=obj.metrics or obj.quality)
            return cls(metrics=m,
                       tracer=Tracer(enabled=obj.tracing),
                       nand_billing=obj.nand_billing,
                       quality=QualityMonitor(
                           m,
                           sample_rate=obj.quality_sample_rate,
                           seed=obj.quality_seed)
                       if obj.quality else None,
                       convergence=ConvergenceLog(obj.convergence_capacity)
                       if obj.convergence else None)
        raise TypeError(
            f"obs= takes an Observability, an ObsConfig or None, "
            f"got {type(obj).__name__}"
        )

    def install_kernel_hooks(self) -> None:
        """Point the module-level kernel instrumentation hooks (the CUDA
        kernel wrappers of ``kernels.ops``, the sharded fan-out) at this
        bundle's registry; a disabled bundle clears them.  Process-wide by
        necessity — the kernels are module functions, not objects."""
        from repro_torch.kernels import ops
        from repro_torch.shard import search as shard_search

        ops.set_observability(self if self.enabled else None)
        shard_search.set_observability(self if self.enabled else None)


#: the default: everything off, all record calls are no-ops
NULL_OBS = Observability(metrics=NULL_REGISTRY, tracer=NULL_TRACER,
                         nand_billing=False)

__all__ = [
    "ConvergenceLog",
    "Histogram",
    "KernelWatch",
    "MetricsRegistry",
    "NULL_OBS",
    "NULL_REGISTRY",
    "NULL_SPAN",
    "NULL_TRACER",
    "Observability",
    "QualityMonitor",
    "RecompileWarning",
    "SLOTarget",
    "SLOTracker",
    "Span",
    "Tracer",
    "default_kernel_sources",
    "record_plan_execution",
    "trace_session",
    "wilson_interval",
]
