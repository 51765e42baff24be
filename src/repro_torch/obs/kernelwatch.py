"""Rebuild detector — the port's twin of ``src/repro/obs/kernelwatch.py``.

The reference watches JAX's jit executable caches, which grow silently
when a batch shape or static argument defeats them.  The port has no jit
cache: its kernels are four shared libraries that ``kernels/loader.py``
compiles with ``nvcc`` once each and then reuses.  ``KernelWatch`` samples
each library's build count (``loader.BUILDS``) into the metrics registry as
``kernel_builds{kernel=...}`` and ``kernel_build_growth{kernel=...}`` — the
twins of ``jit_cache_entries`` / ``jit_cache_growth`` — and warns,
:class:`RecompileWarning`, when a kernel was rebuilt more often than
expected since the watch was constructed (the serving engine constructs
it after its warm-up and expects no growth: any build after warm-up is a
rebuild in the serving loop).
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional

from repro_torch.obs.registry import MetricsRegistry


class RecompileWarning(UserWarning):
    """A watched kernel library was rebuilt more often than expected."""


def default_kernel_sources() -> Dict[str, Callable[[], int]]:
    """Build-count probes for the port's four kernel libraries."""
    from repro_torch.kernels import loader

    return {name: (lambda n=name: loader.BUILDS[n])
            for name in loader.KERNELS}


class KernelWatch:
    def __init__(self, registry: MetricsRegistry,
                 sources: Optional[Dict[str, Callable[[], int]]] = None,
                 warn: bool = True):
        self.registry = registry
        self.sources = dict(sources) if sources is not None \
            else default_kernel_sources()
        self.warn = warn
        self._warned: set = set()
        # builds before construction are warm-up (first use) — budgets
        # apply to growth observed by THIS watch
        self.baseline = {n: int(fn()) for n, fn in self.sources.items()}

    def sample(self) -> Dict[str, int]:
        """Record every kernel's build count as a gauge; returns
        ``{kernel: builds}``."""
        out = {}
        for name, fn in self.sources.items():
            n = int(fn())
            out[name] = n
            self.registry.gauge("kernel_builds", n, kernel=name)
            self.registry.gauge("kernel_build_growth",
                                n - self.baseline[name], kernel=name)
        return out

    def check(self, expected_growth: int = 0) -> Dict[str, int]:
        """Sample, then warn (once per kernel) if any kernel was built more
        than ``expected_growth`` times since this watch was constructed.
        Returns the sampled counts."""
        sizes = self.sample()
        for name, n in sizes.items():
            grew = n - self.baseline[name]
            if grew > expected_growth and name not in self._warned:
                self._warned.add(name)
                self.registry.counter("unexpected_recompiles",
                                      grew - expected_growth, kernel=name)
                if self.warn:
                    warnings.warn(
                        f"kernel '{name}' was built {grew} more times "
                        f"(expected <= {expected_growth}) — its library was "
                        f"rebuilt after warm-up (source changed, or the "
                        f"build directory was cleared)",
                        RecompileWarning, stacklevel=2,
                    )
        return sizes
