"""Batched sort of (distance, id) pairs — the paper's shared Bitonic Sorter
(§IV-D), which sorts the merged candidate list every traversal round.

Replaces the TPU kernel ``src/repro/kernels/bitonic_topk.py::
bitonic_sort_pairs`` (``pl.pallas_call`` at ``bitonic_topk.py:71``) with the
CUDA kernel ``csrc/bitonic_topk.cu``: one block per row, the network in
shared memory.  The port's network compares (key, original position), so it
is stable — ties keep their input order, exactly like the plain version's
``torch.sort(stable=True)``.  (The Pallas network is not stable,
``search.py:171-172``.)  What bounds it on the card: the latency of its
log2(P)(log2(P)+1)/2 synchronised stages, not bytes.

Ascending order; rows must be a power of two long (pad with +inf keys).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import loader

MAX_ROW = 1 << 14        # keys + positions of one row in shared memory


def bitonic_sort_pairs_plain(keys: torch.Tensor, vals: torch.Tensor):
    """(Q, L) keys, (Q, L) payload -> row-wise stable ascending sort."""
    sk, order = torch.sort(keys, dim=1, stable=True)
    return sk, vals.gather(1, order)


def bitonic_sort_pairs_cuda(keys: torch.Tensor, vals: torch.Tensor):
    """Launch the CUDA kernel: (Q, P) f32 keys, (Q, P) i32 payload."""
    loader.check(keys, "bitonic_sort_pairs keys", torch.float32, 2)
    loader.check(vals, "bitonic_sort_pairs vals", torch.int32, 2)
    q, p = keys.shape
    if vals.shape != keys.shape or vals.device != keys.device:
        raise ValueError("bitonic_sort_pairs: keys and vals differ in shape")
    if p & (p - 1) or not 2 <= p <= MAX_ROW:
        raise ValueError(f"bitonic_sort_pairs: row length {p} is not a power "
                         f"of two in [2, {MAX_ROW}]")
    out_k = torch.empty_like(keys)
    out_v = torch.empty_like(vals)
    loader.launch(
        "bitonic_topk", "bitonic_sort_launch", "bitonic_sort_pairs",
        keys.device, loader.ptr(keys), loader.ptr(vals), loader.ptr(out_k),
        loader.ptr(out_v), loader.c_int(q), loader.c_int(p),
        loader.stream(keys),
    )
    return out_k, out_v
