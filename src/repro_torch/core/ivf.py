"""IVF-PQ baseline (the paper's non-graph comparison, FAISS-IVF in Fig. 11)
— port of ``src/repro/core/ivf.py`` (``IVFIndex``, ``build_ivf``,
``search_ivf``).

Classic inverted-file index: a coarse k-means quantizer partitions the
corpus into nlist buckets; at query time the nprobe nearest buckets are
scanned and candidates are scored with PQ (optionally on residuals, as
FAISS IVFPQ does).  No reranking, as in the reference: lossy PQ saturates
recall where graph + rerank keeps climbing.

The build runs on the device: the reference's coarse k-means (its numpy
init, 10 Lloyd steps in the expanded form), the port's ``pq.train_pq`` and
``encode``, and the lists filled from one stable sort of the assignment
(the reference's Python loop over N, in the same layout: ascending ids
within a list, -1 padding).

The search is batched where the reference runs one jitted call per query
and one ``pq_lookup`` per probed list: the probes of a chunk of queries
are one ``pq_adt`` launch over the (Q*nprobe, D) residuals and one
``pq_lookup_lists`` launch over the chunk's (Q, nprobe) probed lists
(without residuals: one ADT a query, shared by its probes).  The lookup
scores each probed list as the reference does, its ``lengths[list]`` rows
of ``list_codes`` as one contiguous run against that probe's ADT, and puts
+inf on the -1 padding, which it never reads; the index keeps the
reference's layout (padding trailing in every list) plus the lengths.  The
top k is a stable sort over the (Q, nprobe*max_len) distances
(``lax.top_k``'s tie order: the lower candidate position first).  On the
CPU the plain versions run (``compute_adt``, the plain lookup); on CUDA the
kernels, with no fallback.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import PQConfig
from repro_torch.core.dataset import full_precision, pairwise_dist
from repro_torch.core.graph import StageTimer
from repro_torch.core.pq import PQCodebook, compute_adt, encode, train_pq
from repro_torch.kernels import ops

COARSE_ITERS = 10           # the reference's coarse Lloyd steps
# elements of one (queries, scanned rows) buffer of a search chunk: the
# distances, candidate ids and sort of a chunk stay under ~1 GB together
_CHUNK_ELEMS = 1 << 25


@dataclass
class IVFIndex:
    coarse_centroids: torch.Tensor   # (nlist, D) f32
    lists: torch.Tensor              # (nlist, max_len) int32, -1 padded
    list_codes: torch.Tensor         # (nlist, max_len, M) uint8
    lengths: torch.Tensor            # (nlist,) int32: ids before the padding
    codebook: PQCodebook
    residual: bool
    metric: str

    @property
    def device(self) -> torch.device:
        return self.lists.device


def fill_lists(assign: torch.Tensor, codes: torch.Tensor, nlist: int):
    """(N,) list of each row and its (N, M) codes -> (lists, list_codes,
    lengths): the reference's layout, rows in ascending id order within a
    list, padded with -1 ids and zero codes, from one stable sort; lengths
    (nlist,) int32."""
    n = assign.shape[0]
    counts = torch.bincount(assign, minlength=nlist)
    max_len = int(counts.max())
    order = torch.sort(assign, stable=True).indices
    owner = assign[order]
    slot = (torch.arange(n, device=assign.device)
            - (torch.cumsum(counts, 0) - counts)[owner])
    lists = torch.full((nlist, max_len), -1, dtype=torch.int32,
                       device=assign.device)
    lists[owner, slot] = order.to(torch.int32)
    list_codes = torch.zeros((nlist, max_len, codes.shape[1]),
                             dtype=torch.uint8, device=assign.device)
    list_codes[owner, slot] = codes[order]
    return lists, list_codes, counts.to(torch.int32)


def build_ivf(base: np.ndarray, pq_cfg: PQConfig, metric: str = "l2",
              nlist: int = 64, residual: bool = True, seed: int = 0,
              device="cuda", stage_times: dict | None = None) -> IVFIndex:
    """Coarse k-means into ``nlist`` lists, PQ on the residuals (or the raw
    vectors), lists filled in id order.  ``stage_times``, if given,
    receives the seconds of each stage."""
    timer = StageTimer(stage_times, device)
    rng = np.random.default_rng(seed)
    x = np.asarray(base, np.float32)
    if metric == "angular":
        x = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    n = x.shape[0]
    init = x[rng.choice(n, size=nlist, replace=False)]
    xs = torch.as_tensor(x, device=device)
    cent = torch.as_tensor(init, device=device)
    with full_precision():
        x2 = (xs * xs).sum(-1)[:, None]
        for _ in range(COARSE_ITERS):
            d = x2 - 2.0 * xs @ cent.T + (cent * cent).sum(-1)[None, :]
            assign = torch.argmin(d, dim=1)
            del d
            onehot = torch.zeros((n, nlist), device=xs.device).scatter_(
                1, assign[:, None], 1.0)
            counts = onehot.sum(0)
            cent = torch.where(
                counts[:, None] > 0,
                (onehot.T @ xs) / torch.clamp(counts, min=1)[:, None], cent)
            del onehot
    timer.mark("coarse_kmeans")
    enc_input = xs - cent[assign] if residual else xs
    codebook = train_pq(enc_input.cpu().numpy(), pq_cfg,
                        "l2" if residual else metric, device=device)
    timer.mark("train_pq")
    codes = encode(enc_input, torch.as_tensor(codebook.centroids,
                                              device=xs.device))
    timer.mark("encode")
    lists, list_codes, lengths = fill_lists(assign, codes, nlist)
    timer.mark("fill_lists")
    return IVFIndex(coarse_centroids=cent, lists=lists, list_codes=list_codes,
                    lengths=lengths, codebook=codebook, residual=residual,
                    metric=metric)


def ivf_from_arrays(*, coarse_centroids, lists, list_codes, centroids,
                    residual: bool, metric: str, device="cuda") -> IVFIndex:
    """An ``IVFIndex`` over copies of a reference index's numpy arrays
    (``centroids``: its codebook's (M, C, dsub)).  Raises if a list's -1
    padding is not trailing: the lookup scores a list's first
    ``lengths[list]`` rows."""
    def on(a, dtype):
        return torch.tensor(np.array(a, copy=True), dtype=dtype,
                            device=device)

    valid = np.asarray(lists) >= 0
    lengths = valid.sum(1)
    if not (valid == (np.arange(valid.shape[1]) < lengths[:, None])).all():
        raise ValueError("ivf_from_arrays: a list's -1 padding is not "
                         "trailing")
    cb_metric = "l2" if residual else metric
    return IVFIndex(
        coarse_centroids=on(coarse_centroids, torch.float32),
        lists=on(lists, torch.int32), list_codes=on(list_codes, torch.uint8),
        lengths=on(lengths, torch.int32),
        codebook=PQCodebook(centroids=np.array(centroids, np.float32,
                                               copy=True), metric=cb_metric),
        residual=bool(residual), metric=metric)


def search_ivf(index: IVFIndex, queries: np.ndarray, k: int, nprobe: int = 8,
               use_pallas: bool = False):
    """Returns (ids (Q,k), dists (Q,k), n_pq_scored (Q,)) as numpy.  The
    probes are the reference's: host distances to the coarse centroids,
    first ``nprobe`` of a stable sort.  ``use_pallas`` is kept for parity;
    the device of the index decides (CUDA: the kernels)."""
    q = np.atleast_2d(np.asarray(queries, np.float32))
    if index.metric == "angular":
        q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    coarse = index.coarse_centroids
    d_coarse = pairwise_dist(q, coarse.cpu().numpy(), index.metric)
    probes = np.argsort(d_coarse, axis=1, kind="stable")[:, :nprobe]

    dev = index.device
    metric = "l2" if index.residual else index.metric
    cents = torch.as_tensor(index.codebook.centroids, device=dev)
    max_len = index.list_codes.shape[1]
    adt = ops.pq_adt if dev.type == "cuda" else compute_adt
    nprobe = probes.shape[1]
    chunk = max(1, _CHUNK_ELEMS // (nprobe * max_len))
    out_ids, out_d, out_n = [], [], []
    for s in range(0, q.shape[0], chunk):
        qc = torch.as_tensor(q[s : s + chunk], device=dev)
        pc = torch.as_tensor(probes[s : s + chunk], device=dev,
                             dtype=torch.int32)
        b = qc.shape[0]
        if index.residual:
            res = (qc[:, None, :] - coarse[pc.long()]).reshape(b * nprobe, -1)
            adts = adt(res.contiguous(), cents, metric)    # one a probe
        else:
            adts = adt(qc, cents, metric)                   # one a query
        d = ops.pq_lookup_lists(pc, index.lengths, index.list_codes, adts)
        d = d.reshape(b, nprobe * max_len)
        cand = index.lists[pc.long()].reshape(b, nprobe * max_len)
        order = torch.sort(d, dim=1, stable=True).indices[:, :k]
        out_ids.append(cand.gather(1, order))
        out_d.append(d.gather(1, order))
        out_n.append(index.lengths[pc.long()].sum(1))
    return (torch.cat(out_ids).cpu().numpy(), torch.cat(out_d).cpu().numpy(),
            torch.cat(out_n).cpu().numpy())
