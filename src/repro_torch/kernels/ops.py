"""Dispatch layer for the hand-written kernels — port of
``src/repro/kernels/ops.py``.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
PyTorch version.  Nothing catches a failed build or launch and carries on.
The build-and-load step and the launch counters live in
``repro_torch.kernels.loader`` and are re-exported here.

Observability (``repro_torch.obs``): ``set_observability`` points a
module-level hook at a bundle; each entry then reports, labelled by the TPU
kernel it ports (``pq_lookup_gather`` -> ``pq_lookup``,
``bitonic_merge_topl`` -> ``bitonic_sort_pairs``, ``l2_rerank_masked`` ->
``l2_rerank``):

* ``kernel_calls{kernel=...}`` — one per call (on the card: one per launch);
* ``kernel_wall_ms{kernel=...}`` — on the CPU the wall time of the plain
  version; on the card the device time between two CUDA events recorded
  around the launch on its stream (``loader.TIMING``), read by
  ``flush_kernel_timings`` once the batch's ids reached the host, so no
  launch waits for the device;
* ``kernel_launches{entry=...}`` — launches by C entry point (port only;
  the reference counted ``kernel_traces`` under a JAX trace instead).

The hook defaults to None and every entry checks it with one branch; with
it off the launch path creates no CUDA event.
"""
from __future__ import annotations

import functools
import time

from repro_torch.kernels import loader
from repro_torch.kernels.bitonic_topk import (
    bitonic_merge_topl_cuda, bitonic_merge_topl_plain, bitonic_sort_pairs_cuda,
    bitonic_sort_pairs_plain,
)
from repro_torch.kernels.l2_rerank import (
    l2_rerank_cuda, l2_rerank_masked_cuda, l2_rerank_masked_plain,
    l2_rerank_plain,
)
from repro_torch.kernels.loader import (  # noqa: F401  (re-exports)
    LAUNCHES, build_all, reset_launch_counts,
)
from repro_torch.kernels.pq_adt import pq_adt_cuda, pq_adt_plain
from repro_torch.kernels.pq_lookup import (
    pq_lookup_cuda, pq_lookup_gather_cuda, pq_lookup_gather_plain,
    pq_lookup_plain,
)

_obs = None     # Observability bundle (repro_torch.obs) or None


def set_observability(obs) -> None:
    """Install (or clear, with None or a disabled bundle) the kernel
    instrumentation sink.  Usually called via
    ``Observability.install_kernel_hooks()``.  Event pairs still pending
    are read into the bundle they were recorded for first."""
    global _obs
    flush_kernel_timings()
    _obs = obs if obs is not None and getattr(obs, "enabled", False) \
        else None
    loader.TIMING = [] if _obs is not None else None


def flush_kernel_timings() -> None:
    """Record ``kernel_wall_ms`` and ``kernel_launches`` for every launch
    whose end event the device has passed; pairs it has not passed stay
    pending.  Queries events, never waits on them: call it after the
    batch's ids reached the host (the planner and the engine do)."""
    pending = loader.TIMING
    if not pending or _obs is None:
        return
    m = _obs.metrics
    keep = []
    for rec in pending:
        kernel, entry, start, end = rec
        if not end.query():
            keep.append(rec)
            continue
        m.observe("kernel_wall_ms", start.elapsed_time(end), kernel=kernel)
        m.counter("kernel_launches", entry=entry)
    pending[:] = keep


def _hooked(kernel: str):
    """Decorate an entry with the observability hook: one branch when it is
    off; else a ``kernel_calls`` count, and on the CPU the plain version's
    wall time (on the card the loader records the launch's event pair)."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(first, *args, **kwargs):
            if _obs is None:
                return fn(first, *args, **kwargs)
            _obs.metrics.counter("kernel_calls", kernel=kernel)
            if first.is_cuda:
                return fn(first, *args, **kwargs)
            t0 = time.perf_counter()
            out = fn(first, *args, **kwargs)
            _obs.metrics.observe("kernel_wall_ms",
                                 (time.perf_counter() - t0) * 1e3,
                                 kernel=kernel)
            return out
        return entry
    return wrap


def _check_ids(ids, mask=None) -> None:
    """CPU path: the kernels trap on a negative id they read (with a mask,
    one the mask asks for), so the plain versions refuse one too instead of
    wrapping it."""
    neg = ids < 0 if mask is None else (ids < 0) & mask
    if bool(neg.any()):
        raise ValueError("negative id passed to a gather: clamp -1 padding "
                         "first")


@_hooked("pq_adt")
def pq_adt(queries, centroids, metric="l2"):
    if queries.is_cuda:
        return pq_adt_cuda(queries, centroids, metric)
    return pq_adt_plain(queries, centroids, metric)


@_hooked("pq_lookup")
def pq_lookup(codes, adt):
    if codes.is_cuda:
        return pq_lookup_cuda(codes, adt)
    return pq_lookup_plain(codes, adt)


@_hooked("pq_lookup")
def pq_lookup_gather(ids, codes, adts, mask=None):
    if ids.is_cuda:
        return pq_lookup_gather_cuda(ids, codes, adts, mask)
    _check_ids(ids)
    return pq_lookup_gather_plain(ids, codes, adts, mask)


@_hooked("bitonic_sort_pairs")
def bitonic_sort_pairs(keys, vals):
    if keys.is_cuda:
        return bitonic_sort_pairs_cuda(keys, vals)
    return bitonic_sort_pairs_plain(keys, vals)


@_hooked("bitonic_sort_pairs")
def bitonic_merge_topl(ids, dists, acc, evaluated, n_ids, n_dists):
    if ids.is_cuda:
        return bitonic_merge_topl_cuda(ids, dists, acc, evaluated, n_ids,
                                       n_dists)
    return bitonic_merge_topl_plain(ids, dists, acc, evaluated, n_ids, n_dists)


@_hooked("l2_rerank")
def l2_rerank(queries, candidates, metric="l2"):
    if queries.is_cuda:
        return l2_rerank_cuda(queries, candidates, metric)
    return l2_rerank_plain(queries, candidates, metric)


@_hooked("l2_rerank")
def l2_rerank_masked(queries, ids, base, acc, mask, metric="l2"):
    if queries.is_cuda:
        return l2_rerank_masked_cuda(queries, ids, base, acc, mask, metric)
    _check_ids(ids, mask)
    return l2_rerank_masked_plain(queries, ids, base, acc, mask, metric)
