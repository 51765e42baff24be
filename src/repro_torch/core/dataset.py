"""Synthetic ANN corpora + exact ground truth — port of
``src/repro/core/dataset.py`` (``make_dataset``, ``pairwise_dist``,
``exact_knn``, ``recall_at_k``, the segment sources ``Dataset.as_source``,
``ArraySegmentSource`` and ``SyntheticSegmentSource``).

The generators are the reference's numpy code, kept as numpy so that the
same config yields bit-identical base and query arrays.  ``exact_knn`` routes
by device: on the CPU it is the reference's chunked numpy scan; on a CUDA
device it is a chunked full-float32 ``torch.matmul`` plus a stable top-k, the
only way to get the ground truth of a 1M-vector corpus in seconds.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import DatasetConfig


@dataclass
class Dataset:
    base: np.ndarray      # (N, D) float32
    queries: np.ndarray   # (Q, D) float32
    gt: np.ndarray        # (Q, k_gt) int32 exact nearest neighbours
    metric: str
    config: DatasetConfig

    @property
    def num_base(self) -> int:
        return self.base.shape[0]

    @property
    def dim(self) -> int:
        return self.base.shape[1]

    def as_source(self, segment_size: int = 0) -> "ArraySegmentSource":
        """View this (host-resident) corpus as a segment stream for the
        segmented builder; ``segment_size == 0`` -> one segment."""
        return ArraySegmentSource(self.base, segment_size)


def normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def pairwise_dist(q: np.ndarray, x: np.ndarray, metric: str) -> np.ndarray:
    """(Q, N) distances; smaller is closer for every metric."""
    if metric == "l2":
        # squared L2 (monotone in L2; matches PQ table construction)
        q2 = (q * q).sum(-1, keepdims=True)
        x2 = (x * x).sum(-1)
        return q2 + x2[None, :] - 2.0 * q @ x.T
    if metric == "ip":
        return -(q @ x.T)
    if metric == "angular":
        return -(normalize(q) @ normalize(x).T)
    raise ValueError(f"unknown metric {metric!r}")


def pairwise_dist_torch(q: torch.Tensor, x: torch.Tensor, metric: str,
                        x2: torch.Tensor | None = None) -> torch.Tensor:
    """``pairwise_dist`` on tensors, in the same expression order.  ``x2``
    (the rows' squared norms) may be passed in when the caller reuses it
    across chunks.  Callers turn TF32 off (``full_precision``)."""
    if metric == "l2":
        q2 = (q * q).sum(-1, keepdim=True)
        if x2 is None:
            x2 = (x * x).sum(-1)
        return q2 + x2[None, :] - 2.0 * (q @ x.T)
    if metric == "ip":
        return -(q @ x.T)
    if metric == "angular":
        return -(l2_normalize(q) @ l2_normalize(x).T)
    raise ValueError(f"unknown metric {metric!r}")


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Unit-normalize rows — the angular-metric normalization."""
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


class full_precision:
    """Context manager: float32 matrix products in full float32 (no TF32)
    for the build and the ground truth, restoring the previous flags."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False


def sorted_smallest(d: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k smallest entries of each row, ascending by
    (value, column) — a stable top-k: ``torch.topk`` alone promises no order
    among ties on CUDA, so its pick is re-sorted by column, then stably by
    value."""
    vals, idx = torch.topk(d, k, dim=1, largest=False, sorted=False)
    idx, order = torch.sort(idx, dim=1)
    vals = vals.gather(1, order)
    vals, order = torch.sort(vals, dim=1, stable=True)
    return vals, idx.gather(1, order)


def exact_knn(
    queries: np.ndarray, base: np.ndarray, k: int, metric: str,
    chunk: int = 512, device: str = "cuda",
) -> np.ndarray:
    """(Q, k) int32 exact nearest neighbours, sorted by distance.  On the
    CPU: the reference's numpy scan.  On CUDA: ``chunk`` queries at a time
    against the whole base held on the device."""
    k = min(k, base.shape[0])
    if torch.device(device).type == "cpu":
        return _exact_knn_numpy(queries, base, k, metric, chunk)
    with full_precision():
        xb = torch.as_tensor(base, device=device)
        x2 = (xb * xb).sum(-1) if metric == "l2" else None
        out = []
        for s in range(0, queries.shape[0], chunk):
            q = torch.as_tensor(queries[s : s + chunk], device=device)
            _, idx = sorted_smallest(pairwise_dist_torch(q, xb, metric, x2), k)
            out.append(idx.to(torch.int32).cpu())
    return torch.cat(out).numpy()


def _exact_knn_numpy(queries, base, k, metric, chunk):
    out = np.empty((queries.shape[0], k), dtype=np.int32)
    for s in range(0, queries.shape[0], chunk):
        d = pairwise_dist(queries[s : s + chunk], base, metric)
        if k < d.shape[1]:
            idx = np.argpartition(d, k, axis=1)[:, :k]
        else:                   # argpartition needs kth < n; full sort below
            idx = np.broadcast_to(np.arange(k), d.shape[:1] + (k,))
        row = np.take_along_axis(d, idx, axis=1)
        order = np.argsort(row, axis=1, kind="stable")
        out[s : s + chunk] = np.take_along_axis(idx, order, axis=1)
    return out


def generate(cfg: DatasetConfig) -> tuple:
    """(base, queries, metric) of ``make_dataset`` without the ground
    truth — the reference's generators, draw for draw."""
    rng = np.random.default_rng(cfg.seed)
    n, d, q = cfg.num_base, cfg.dim, cfg.num_queries

    if cfg.name.startswith("glove"):
        # heavy-tailed directions: cluster centres on sphere, power-law sizes
        centers = normalize(rng.standard_normal((cfg.num_clusters, d)))
        weights = 1.0 / np.arange(1, cfg.num_clusters + 1) ** 0.8
        weights /= weights.sum()
        assign = rng.choice(cfg.num_clusters, size=n, p=weights)
        base = normalize(centers[assign] + cfg.cluster_std * rng.standard_normal((n, d)))
        qa = rng.choice(cfg.num_clusters, size=q, p=weights)
        queries = normalize(centers[qa] + cfg.cluster_std * rng.standard_normal((q, d)))
        metric = "angular"
    elif cfg.name.startswith("deep"):
        scales = np.exp(-np.linspace(0.0, 3.0, d))  # anisotropic spectrum
        centers = rng.standard_normal((cfg.num_clusters, d)) * scales
        assign = rng.integers(0, cfg.num_clusters, size=n)
        base = (centers[assign] + cfg.cluster_std * rng.standard_normal((n, d)) * scales)
        qa = rng.integers(0, cfg.num_clusters, size=q)
        queries = centers[qa] + cfg.cluster_std * rng.standard_normal((q, d)) * scales
        metric = "ip"
    else:  # sift-like
        centers = rng.standard_normal((cfg.num_clusters, d))
        assign = rng.integers(0, cfg.num_clusters, size=n)
        base = centers[assign] + cfg.cluster_std * rng.standard_normal((n, d))
        qa = rng.integers(0, cfg.num_clusters, size=q)
        queries = centers[qa] + cfg.cluster_std * rng.standard_normal((q, d))
        metric = cfg.metric if cfg.metric else "l2"
    return base.astype(np.float32), queries.astype(np.float32), metric


def make_dataset(cfg: DatasetConfig, k_gt: int = 100,
                 device: str = "cuda") -> Dataset:
    base, queries, metric = generate(cfg)
    gt = exact_knn(queries, base, min(k_gt, cfg.num_base), metric,
                   device=device)
    return Dataset(base=base, queries=queries, gt=gt, metric=metric, config=cfg)


def recall_hits_per_query(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(Q,) per-row |pred∩gt|.  Negative ids (-1 padding) never match."""
    out = np.zeros(pred.shape[0], np.int64)
    for i, (p, g) in enumerate(zip(pred, gt)):
        out[i] = len(set(int(x) for x in p if x >= 0)
                     & set(int(x) for x in g if x >= 0))
    return out


def recall_at_k(pred: np.ndarray, gt: np.ndarray, k: int) -> float:
    """Paper Eq. (2): |pred∩gt|/k averaged over queries."""
    return int(recall_hits_per_query(pred[:, :k], gt[:, :k]).sum()) \
        / (pred.shape[0] * k)


class ArraySegmentSource:
    """Fixed-size segment view over a host-resident array — the trivial
    segment source.  The segmented builder (``core.segmented``) consumes any
    object with this surface (``num_base``, ``dim``, ``num_segments``,
    ``bounds(s)``, ``segment(s)``)."""

    def __init__(self, base: np.ndarray, segment_size: int = 0):
        self.base = base
        self.segment_size = segment_size if segment_size > 0 else base.shape[0]

    @property
    def num_base(self) -> int:
        return self.base.shape[0]

    @property
    def dim(self) -> int:
        return self.base.shape[1]

    @property
    def num_segments(self) -> int:
        return max(1, -(-self.num_base // self.segment_size))

    def bounds(self, s: int) -> tuple[int, int]:
        lo = s * self.segment_size
        return lo, min(lo + self.segment_size, self.num_base)

    def segment(self, s: int) -> np.ndarray:
        lo, hi = self.bounds(s)
        return self.base[lo:hi]

    def __iter__(self):
        for s in range(self.num_segments):
            yield self.segment(s)


class SyntheticSegmentSource:
    """Out-of-core synthetic corpus: segment ``s`` is a pure function of
    ``(config, s)`` — a per-segment RNG stream seeded ``(seed, s)`` draws
    the cluster assignments and noise — so only the (num_clusters, dim)
    centre matrix plus one segment is ever resident.  Gaussian-mixture
    (sift-like) geometry only; queries come from the same mixture via
    :meth:`queries`.  The reference's draws, bit for bit."""

    def __init__(self, cfg: DatasetConfig, segment_size: int):
        if segment_size <= 0:
            raise ValueError("SyntheticSegmentSource needs segment_size > 0")
        self.config = cfg
        self.segment_size = segment_size
        self.metric = cfg.metric if cfg.metric else "l2"
        rng = np.random.default_rng(cfg.seed)
        self.centers = rng.standard_normal(
            (cfg.num_clusters, cfg.dim)
        ).astype(np.float32)

    @property
    def num_base(self) -> int:
        return self.config.num_base

    @property
    def dim(self) -> int:
        return self.config.dim

    @property
    def num_segments(self) -> int:
        return max(1, -(-self.num_base // self.segment_size))

    def bounds(self, s: int) -> tuple[int, int]:
        lo = s * self.segment_size
        return lo, min(lo + self.segment_size, self.num_base)

    def segment(self, s: int) -> np.ndarray:
        cfg = self.config
        lo, hi = self.bounds(s)
        rng = np.random.default_rng((cfg.seed, s))
        assign = rng.integers(0, cfg.num_clusters, size=hi - lo)
        noise = cfg.cluster_std * rng.standard_normal((hi - lo, cfg.dim))
        return (self.centers[assign] + noise).astype(np.float32)

    def __iter__(self):
        for s in range(self.num_segments):
            yield self.segment(s)

    def queries(self, num_queries: int) -> np.ndarray:
        cfg = self.config
        rng = np.random.default_rng((cfg.seed, -1))
        qa = rng.integers(0, cfg.num_clusters, size=num_queries)
        noise = cfg.cluster_std * rng.standard_normal((num_queries, cfg.dim))
        return (self.centers[qa] + noise).astype(np.float32)
