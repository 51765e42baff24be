"""Product quantization (paper §III-B) — port of ``src/repro/core/pq.py``
(``train_pq``, ``encode``, ``compute_adt``, ``pq_distance``, ``decode``,
``calibrate_beta``).

``compute_adt`` and ``pq_distance`` are the reference's jnp-path forms: the
ADT in the expanded form ||q||^2 - 2 q.c + ||c||^2 (``pq.py:123-128``) and a
gather-and-sum lookup.  The CPU search uses them, so it rounds like the
reference traversal.  The CUDA search uses the hand-written kernels of
``repro_torch.kernels`` instead (``pq_adt``, ``pq_lookup``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import PQConfig
from repro_torch.core.dataset import full_precision


@dataclass
class PQCodebook:
    centroids: np.ndarray   # (M, C, dsub) float32
    metric: str

    @property
    def num_subvectors(self) -> int:
        return self.centroids.shape[0]

    @property
    def num_centroids(self) -> int:
        return self.centroids.shape[1]

    @property
    def dim(self) -> int:
        return self.centroids.shape[0] * self.centroids.shape[2]


def _split(x: torch.Tensor, m: int) -> torch.Tensor:
    """(..., D) -> (..., M, dsub)."""
    return x.reshape(*x.shape[:-1], m, x.shape[-1] // m)


# rows per device chunk of the (M, rows, C) distance block in k-means and
# encoding: 32 x 32768 x 256 float32 is 1 GiB
_CHUNK = 32768


def train_pq(data: np.ndarray, cfg: PQConfig, metric: str = "l2",
             device: str = "cuda") -> PQCodebook:
    """Lloyd k-means per subspace, all M subspaces batched, the points
    chunked on the device.  The initial centroids are the reference's numpy
    draw; each step is the reference's: squared distances in the expanded
    form, first-minimum assignment, one-hot sums (a matrix product, so the
    result does not depend on atomic ordering), empty clusters kept."""
    n, d = data.shape
    m, c = cfg.num_subvectors, cfg.num_centroids
    if d % m != 0:
        raise ValueError(f"dim {d} not divisible by M={m}")
    rng = np.random.default_rng(cfg.seed)
    x = np.asarray(data, np.float32)
    if metric == "angular":
        x = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    subs_np = x.reshape(n, m, d // m).transpose(1, 0, 2)       # (M, N, dsub)
    init_idx = np.stack(
        [rng.choice(n, size=min(c, n), replace=n < c) for _ in range(m)]
    )
    init = subs_np[np.arange(m)[:, None], init_idx]            # (M, C, dsub)
    subs = torch.as_tensor(np.ascontiguousarray(subs_np), device=device)
    cent = torch.as_tensor(np.ascontiguousarray(init), device=device)
    kc = cent.shape[1]
    with full_precision():
        for _ in range(cfg.kmeans_iters):
            sums = torch.zeros_like(cent)
            counts = torch.zeros(m, kc, device=device)
            c2 = (cent * cent).sum(-1)[:, None, :]
            for s in range(0, n, _CHUNK):
                sub = subs[:, s : s + _CHUNK]
                dist = ((sub * sub).sum(-1)[:, :, None]
                        - 2.0 * torch.bmm(sub, cent.transpose(1, 2)) + c2)
                assign = torch.argmin(dist, dim=2, keepdim=True)
                onehot = torch.zeros_like(dist).scatter_(2, assign, 1.0)
                counts += onehot.sum(1)
                sums += torch.bmm(onehot.transpose(1, 2), sub)
            cent = torch.where(counts[:, :, None] > 0,
                               sums / torch.clamp(counts, min=1)[:, :, None],
                               cent)
    return PQCodebook(centroids=cent.cpu().numpy(), metric=metric)


def encode(data: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N, M) uint8 codes (nearest centroid per subspace)."""
    m = centroids.shape[0]
    c2 = (centroids * centroids).sum(-1)[None]
    out = []
    with full_precision():
        for s in range(0, data.shape[0], _CHUNK):
            subs = _split(data[s : s + _CHUNK], m)             # (n, M, dsub)
            d = ((subs * subs).sum(-1)[..., None]
                 - 2.0 * torch.einsum("nmd,mcd->nmc", subs, centroids) + c2)
            out.append(torch.argmin(d, dim=-1).to(torch.uint8))
    return torch.cat(out)


def compute_adt(queries: torch.Tensor, centroids: torch.Tensor,
                metric: str = "l2") -> torch.Tensor:
    """(Q, D) queries -> (Q, M, C) asymmetric distance tables, expanded form.

    l2: ADT[m,c] = ||q_m - cent[m,c]||^2; ip/angular: -<q_m, cent[m,c]>."""
    m = centroids.shape[0]
    qs = _split(queries, m)                                    # (Q, M, dsub)
    dots = torch.einsum("qmd,mcd->qmc", qs, centroids)
    if metric == "l2":
        return ((qs * qs).sum(-1)[..., None] - 2.0 * dots
                + (centroids * centroids).sum(-1)[None])
    return -dots


def pq_distance(codes: torch.Tensor, adt: torch.Tensor) -> torch.Tensor:
    """Eq. (3), batched over lanes: codes (Q, n, M) uint8 and adt (Q, M, C)
    -> (Q, n).  uint8 codes are widened first: torch reads a uint8 index
    tensor as a boolean mask."""
    q, n, m = codes.shape
    idx = codes.long() + torch.arange(m, device=codes.device) * adt.shape[2]
    flat = adt.reshape(q, 1, -1).expand(q, n, -1)
    return flat.gather(2, idx).sum(-1)


def decode(codes: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Reconstruct approximate vectors from codes (host-side helper)."""
    m, _, dsub = centroids.shape
    out = centroids[np.arange(m)[None, :], codes.astype(np.int64)]  # (N, M, dsub)
    return out.reshape(codes.shape[0], m * dsub)


def calibrate_beta(
    codebook: PQCodebook,
    codes: np.ndarray,
    base: np.ndarray,
    rng: np.random.Generator,
    num_samples: int = 256,
    num_targets: int = 512,
    quantile: float = 0.99,
    device="cuda",
) -> float:
    """Empirical PQ error ratio beta (paper §III-C: 99% of PQ distances are
    within beta x of accurate distances) — port of the reference's
    ``calibrate_beta`` (``src/repro/core/pq.py:146-181``): the same numpy
    draws of sampled queries and targets and the same numpy accurate
    distances; the PQ distances on ``device`` (on CUDA one ``pq_adt`` launch
    for the (S, M, C) tables and one lookup launch for the (S, T) pairs).
    Returns the ``quantile`` of max(accurate/PQ, PQ/accurate)."""
    from repro_torch.core.dataset import pairwise_dist
    from repro_torch.kernels import ops

    n = base.shape[0]
    qi = rng.choice(n, size=min(num_samples, n), replace=False)
    ti = rng.choice(n, size=min(num_targets, n), replace=False)
    q = base[qi]
    if codebook.metric == "angular":
        q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    acc = pairwise_dist(q, base[ti], codebook.metric)          # (S, T)
    qt = torch.as_tensor(np.ascontiguousarray(q, np.float32), device=device)
    cents = torch.as_tensor(codebook.centroids, device=device)
    adts = ops.pq_adt(qt, cents, codebook.metric) if qt.is_cuda \
        else compute_adt(qt, cents, codebook.metric)
    sub_codes = torch.as_tensor(np.ascontiguousarray(codes[ti]), device=device)
    ids = torch.arange(len(ti), dtype=torch.int32, device=device)
    approx = ops.pq_lookup_gather(
        ids.expand(len(qi), len(ti)).contiguous(), sub_codes,
        adts).cpu().numpy()
    # shift to positive for ratio stability (ip/angular distances are negative)
    shift = min(acc.min(), approx.min())
    acc_s = acc - shift + 1e-3
    app_s = approx - shift + 1e-3
    ratio = np.maximum(acc_s / app_s, app_s / acc_s)
    return float(np.quantile(ratio, quantile))
