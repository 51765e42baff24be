"""Accurate-distance reranking (paper §III-C / Alg.1 l.12+19).

Replaces the TPU kernel ``src/repro/kernels/l2_rerank.py::l2_rerank``
(``pl.pallas_call`` at ``l2_rerank.py:51``) with the CUDA kernels of
``csrc/l2_rerank.cu``, one warp per (query, candidate):

    l2: ||q||^2 - 2 q.x + ||x||^2      ip/angular: -q.x

* ``l2_rerank``: (Q, D) queries, (Q, K, D) gathered rows -> (Q, K) — the
  reference signature, kept for the parity tests;
* ``l2_rerank_gather``: (Q, D) queries, (Q, K) int32 ids, (N, D) base ->
  (Q, K), gathering the rows inside the kernel so the (Q, K, D) copy the
  reference makes (``search.py:411``) is never written.  The search's final
  rerank calls this one.

What bounds it on the card: reading the Q*K candidate rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import loader


def l2_rerank_plain(queries: torch.Tensor, candidates: torch.Tensor,
                    metric: str = "l2") -> torch.Tensor:
    """(Q, D), (Q, K, D) -> (Q, K)."""
    dot = torch.einsum("qd,qkd->qk", queries, candidates)
    if metric == "l2":
        return ((queries * queries).sum(-1)[:, None] - 2.0 * dot
                + (candidates * candidates).sum(-1))
    return -dot


def l2_rerank_gather_plain(queries: torch.Tensor, ids: torch.Tensor,
                           base: torch.Tensor, metric: str = "l2"):
    """(Q, D), (Q, K) ids, (N, D) -> (Q, K)."""
    return l2_rerank_plain(queries, base[ids.long()], metric)


def l2_rerank_cuda(queries: torch.Tensor, candidates: torch.Tensor,
                   metric: str = "l2") -> torch.Tensor:
    """Launch the CUDA kernel: (Q, D) f32, (Q, K, D) f32 -> (Q, K) f32."""
    loader.check(queries, "l2_rerank queries", torch.float32, 2)
    loader.check(candidates, "l2_rerank candidates", torch.float32, 3)
    q, k, d = candidates.shape
    if queries.shape != (q, d) or queries.device != candidates.device:
        raise ValueError(f"l2_rerank: queries {tuple(queries.shape)} do not "
                         f"fit candidates {tuple(candidates.shape)}")
    out = torch.empty((q, k), dtype=torch.float32, device=queries.device)
    loader.launch(
        "l2_rerank", "l2_rerank_launch", "l2_rerank", queries.device,
        loader.ptr(queries), loader.ptr(candidates), loader.ptr(out),
        loader.c_int(q), loader.c_int(k), loader.c_int(d),
        loader.c_int(metric == "l2"), loader.stream(queries),
    )
    return out


def l2_rerank_gather_cuda(queries: torch.Tensor, ids: torch.Tensor,
                          base: torch.Tensor, metric: str = "l2"):
    """Launch the CUDA kernel: (Q, D) f32, (Q, K) i32, (N, D) f32 -> (Q, K).
    An id outside [0, N) traps in the kernel; callers clamp -1 padding
    first, like the reference."""
    loader.check(queries, "l2_rerank_gather queries", torch.float32, 2)
    loader.check(ids, "l2_rerank_gather ids", torch.int32, 2)
    loader.check(base, "l2_rerank_gather base", torch.float32, 2)
    q, k = ids.shape
    n, d = base.shape
    if queries.shape != (q, d) or not (queries.device == ids.device
                                       == base.device):
        raise ValueError(f"l2_rerank_gather: queries {tuple(queries.shape)},"
                         f" ids {tuple(ids.shape)}, base {tuple(base.shape)}")
    out = torch.empty((q, k), dtype=torch.float32, device=queries.device)
    loader.launch(
        "l2_rerank", "l2_rerank_gather_launch", "l2_rerank", queries.device,
        loader.ptr(queries), loader.ptr(ids), loader.ptr(base),
        loader.ptr(out), loader.c_int(q), loader.c_int(k), loader.c_int(d),
        loader.c_int(n), loader.c_int(metric == "l2"), loader.stream(queries),
    )
    return out
