"""Asymmetric Distance Table construction (paper §IV-D, "PQ Module").

Replaces the TPU kernel ``src/repro/kernels/pq_adt.py::pq_adt``
(``pl.pallas_call`` at ``pq_adt.py:54``) with the CUDA kernel
``csrc/pq_adt.cu``.  For queries (Q, D) and a codebook (M, C, dsub):

    l2:  ADT[q, m, c] = sum_d (query[q,m,d] - cent[m,c,d])^2
    ip:  ADT[q, m, c] = -sum_d  query[q,m,d] * cent[m,c,d]

the direct form, like the TPU kernel.  What bounds it on the card: writing
the (Q, M, C) float32 tables — the codebook is read once into L2 — at the
search's dsub=4; its operations at a wide dsub (the image retriever's 64),
which the kernel's second form, a tiled product over the subspaces, serves.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import loader


def pq_adt_plain(queries: torch.Tensor, centroids: torch.Tensor,
                 metric: str = "l2") -> torch.Tensor:
    """Plain PyTorch version: (Q, D), (M, C, dsub) -> (Q, M, C)."""
    m, c, dsub = centroids.shape
    qs = queries.reshape(queries.shape[0], m, dsub)
    if metric == "l2":
        diff = qs[:, :, None, :] - centroids[None]
        return (diff * diff).sum(-1)
    return -torch.einsum("qmd,mcd->qmc", qs, centroids)


def pq_adt_cuda(queries: torch.Tensor, centroids: torch.Tensor,
                metric: str = "l2") -> torch.Tensor:
    """Launch the CUDA kernel: (Q, D) f32, (M, C, dsub) f32 -> (Q, M, C)."""
    loader.check(queries, "pq_adt queries", torch.float32, 2)
    loader.check(centroids, "pq_adt centroids", torch.float32, 3)
    q, d = queries.shape
    m, c, dsub = centroids.shape
    if d != m * dsub or centroids.device != queries.device:
        raise ValueError(f"pq_adt: queries {tuple(queries.shape)} do not fit "
                         f"codebook {tuple(centroids.shape)}")
    out = torch.empty((q, m, c), dtype=torch.float32, device=queries.device)
    loader.launch(
        "pq_adt", "pq_adt_launch", "pq_adt", queries.device,
        loader.ptr(queries), loader.ptr(centroids), loader.ptr(out),
        loader.c_int(q), loader.c_int(m), loader.c_int(c), loader.c_int(dsub),
        loader.c_int(metric == "l2"), loader.stream(queries),
    )
    return out
