"""Accurate-distance reranking (paper §III-C / Alg.1 l.12+19).

Replaces the TPU kernel ``src/repro/kernels/l2_rerank.py::l2_rerank``
(``pl.pallas_call`` at ``l2_rerank.py:51``) with the CUDA kernels of
``csrc/l2_rerank.cu``: one warp per 8 candidates of a query, the query row
in registers, the rows the caller asks for loaded several at a time; the
masked entry's rows wider than 128 (the image retriever's 2,048) take the
wide kernel, ``l2_rerank_wide_kernel``: a block per window of candidates
whose threads each own a slice of every asked-for row, so all of a row is
in flight after one ids -> rows latency.  The C launcher alone picks the
kernel; both names hold ``l2_rerank``, which is how a profile finds them.

* ``l2_rerank``: (Q, D) queries, (Q, K, D) gathered rows -> (Q, K) in the
  TPU kernel's expanded form, l2 ||q||^2 - 2 q.x + ||x||^2, ip -q.x — the
  reference signature, kept for the parity tests;
* ``l2_rerank_masked``: (Q, D) queries, (Q, K) int32 ids, (N, D) base,
  (Q, K) acc, (Q, K) bool mask -> (Q, K): where the mask holds, the exact
  distance of ``base[id]`` in the direct form of the reference search's jnp
  path (``exact_dist``); elsewhere ``acc``, bit for bit.  The kernel reads
  only the rows the mask asks for, so the search's round (the entries that
  just entered the top-T) and its beta-margin rerank both call it, on the
  CPU and on the card alike.

What bounds it on the card: the bytes of the rows asked for and, at a
round's few percent of them, the latency of the ids -> rows chain.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import loader

def exact_dist(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """q (Q, D), x (Q, K, D) -> (Q, K), direct form (the reference search's
    ``_exact_dist``).  Angular assumes pre-normalized inputs."""
    if metric == "l2":
        diff = x - q[:, None, :]
        return (diff * diff).sum(-1)
    return -torch.bmm(x, q[:, :, None])[..., 0]


def l2_rerank_plain(queries: torch.Tensor, candidates: torch.Tensor,
                    metric: str = "l2") -> torch.Tensor:
    """(Q, D), (Q, K, D) -> (Q, K), expanded form."""
    dot = torch.einsum("qd,qkd->qk", queries, candidates)
    if metric == "l2":
        return ((queries * queries).sum(-1)[:, None] - 2.0 * dot
                + (candidates * candidates).sum(-1))
    return -dot


def l2_rerank_masked_plain(queries: torch.Tensor, ids: torch.Tensor,
                           base: torch.Tensor, acc: torch.Tensor,
                           mask: torch.Tensor, metric: str = "l2"):
    """(Q, D), (Q, K) ids, (N, D), (Q, K) acc, (Q, K) bool -> (Q, K):
    ``exact_dist`` of the rows where ``mask`` holds, ``acc`` elsewhere."""
    rows = base[ids.clamp(min=0).long()]
    return torch.where(mask, exact_dist(queries, rows, metric), acc)


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


def l2_rerank_masked_cuda(queries: torch.Tensor, ids: torch.Tensor,
                          base: torch.Tensor, acc: torch.Tensor,
                          mask: torch.Tensor, metric: str = "l2"):
    """Launch the CUDA kernel: (Q, D) f32, (Q, K) i32, (N, D) f32, (Q, K)
    f32, (Q, K) bool -> (Q, K) f32.  A masked id outside [0, N) traps in the
    kernel; an id the mask does not ask for is never read, so -1 padding
    needs no clamp."""
    loader.check(queries, "l2_rerank_masked queries", torch.float32, 2)
    loader.check(ids, "l2_rerank_masked ids", torch.int32, 2)
    loader.check(base, "l2_rerank_masked base", torch.float32, 2)
    loader.check(acc, "l2_rerank_masked acc", torch.float32, 2)
    loader.check(mask, "l2_rerank_masked mask", torch.bool, 2)
    q, k = ids.shape
    n, d = base.shape
    if (queries.shape != (q, d) or acc.shape != (q, k)
            or mask.shape != (q, k)
            or len({t.device for t in (queries, ids, base, acc, mask)}) != 1):
        raise ValueError(f"l2_rerank_masked: queries {tuple(queries.shape)}, "
                         f"ids {tuple(ids.shape)}, base {tuple(base.shape)}, "
                         f"acc {tuple(acc.shape)}, mask {tuple(mask.shape)}")
    out = torch.empty((q, k), dtype=torch.float32, device=queries.device)
    loader.launch(
        "l2_rerank", "l2_rerank_masked_launch", "l2_rerank", queries.device,
        loader.ptr(queries), loader.ptr(ids), loader.ptr(base),
        loader.ptr(acc), loader.ptr(mask), loader.ptr(out),
        loader.c_int(q), loader.c_int(k), loader.c_int(d), loader.c_int(n),
        loader.c_int(metric == "l2"), loader.stream(queries),
    )
    return out
