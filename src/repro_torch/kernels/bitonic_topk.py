"""Batched sort of (distance, id) pairs — the paper's shared Bitonic Sorter
(§IV-D), which sorts the merged candidate list every traversal round.

Replaces the TPU kernel ``src/repro/kernels/bitonic_topk.py::
bitonic_sort_pairs`` (``pl.pallas_call`` at ``bitonic_topk.py:71``) with the
CUDA kernels of ``csrc/bitonic_topk.cu``.  Each element is one 64-bit word,
(order-preserving key, original position), so the network is stable — ties
keep their input order, exactly like the plain versions'
``torch.sort(stable=True)``.  (The Pallas network is not stable,
``search.py:171-172``.)  A row of up to 1024 elements sorts in one warp's
registers, exchanging by shuffles; a longer one in one block's shared memory.
What bounds it on the card: the latency of its log2(P)(log2(P)+1)/2
dependent stages, not bytes; the merge cuts them by sorting only the fresh
keys and merging them into the already sorted list in log2(P) stages, or,
for lists of 256 or more and rows longer than a warp holds, by ranking:
every element's slot is its index plus its rank in the other sorted run,
by binary search, with one barrier (``merge_kernel`` names the kernel a
shape takes).

Two functions, each with its plain version:

* ``bitonic_sort_pairs``: (Q, P) keys and payload, ascending; rows must be a
  power of two long (pad with +inf keys);
* ``bitonic_merge_topl``: the search's merge of a lane's candidate list with
  its fresh candidates, keeping the top L — the reference's
  ``_merge_sort_topl`` (``src/repro/core/search.py:130-143``) in one launch,
  with the concatenation, padding and gathers inside the kernel.  The
  kernel needs the list's distances sorted ascending, as every round leaves
  them, and traps otherwise; the plain version sorts the whole row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import loader

MAX_ROW = 1 << 14        # one row's 64-bit words in shared memory
WARP_ROW = 1024          # the longest merge row (list + fresh slots) of a warp
RANK_FROM = 256          # the shortest list the rank merge takes
INF = float("inf")


def merge_kernel(l: int, n: int) -> str:
    """The device kernel a merge of a list of ``l`` with ``n`` fresh
    candidates launches, as ``bitonic_merge_launch`` routes it: the warp
    merge for a list shorter than RANK_FROM whose row (the list and the
    fresh slots, next_pow2(n) and at least 32) fits one warp's WARP_ROW
    elements, the rank merge otherwise."""
    fresh = 1 << max(n - 1, 31).bit_length()
    return ("warp_merge_kernel" if l < RANK_FROM and l + fresh <= WARP_ROW
            else "rank_merge_kernel")


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


def bitonic_merge_topl_plain(ids, dists, acc, evaluated, n_ids, n_dists):
    """A lane's list (Q, L) ids / dists / acc / evaluated and its (Q, n)
    fresh ids / dists -> the top L of the L + n entries by a stable sort on
    the distance, all four columns.  Fresh entries come after the list and
    get acc = +inf, evaluated = False."""
    l = ids.shape[1]
    all_d = torch.cat([dists, n_dists], 1)
    order = torch.sort(all_d, dim=1, stable=True).indices[:, :l]
    return (torch.cat([ids, n_ids], 1).gather(1, order),
            all_d.gather(1, order),
            torch.cat([acc, torch.full_like(n_dists, INF)], 1).gather(1, order),
            torch.cat([evaluated, torch.zeros_like(n_ids, dtype=torch.bool)],
                      1).gather(1, order))


def bitonic_merge_topl_cuda(ids, dists, acc, evaluated, n_ids, n_dists):
    """Launch the CUDA merge: (Q, L) i32 / f32 / f32 / bool list columns,
    (Q, n) i32 / f32 fresh columns -> the four (Q, L) columns of the new
    list.  Counts as a ``bitonic_sort_pairs`` launch.  Both merge kernels
    (``merge_kernel``) need the list's distances ascending and trap
    otherwise."""
    loader.check(ids, "bitonic_merge_topl ids", torch.int32, 2)
    loader.check(dists, "bitonic_merge_topl dists", torch.float32, 2)
    loader.check(acc, "bitonic_merge_topl acc", torch.float32, 2)
    loader.check(evaluated, "bitonic_merge_topl evaluated", torch.bool, 2)
    loader.check(n_ids, "bitonic_merge_topl n_ids", torch.int32, 2)
    loader.check(n_dists, "bitonic_merge_topl n_dists", torch.float32, 2)
    q, l = ids.shape
    n = n_ids.shape[1]
    cols = (ids, dists, acc, evaluated, n_ids, n_dists)
    if (any(t.shape != (q, l) for t in cols[:4])
            or n_dists.shape != (q, n)
            or any(t.device != ids.device for t in cols)):
        raise ValueError("bitonic_merge_topl: list columns must be (Q, L) "
                         "and fresh columns (Q, n), on one device; got "
                         f"{[tuple(t.shape) for t in cols]}")
    if l + n > MAX_ROW:                  # MAX_ROW is a power of two
        raise ValueError(f"bitonic_merge_topl: L + n = {l + n} exceeds "
                         f"{MAX_ROW}")
    out_ids = torch.empty_like(ids)
    out_d = torch.empty_like(dists)
    out_acc = torch.empty_like(acc)
    out_ev = torch.empty_like(evaluated)
    loader.launch(
        "bitonic_topk", "bitonic_merge_launch", "bitonic_sort_pairs",
        ids.device, *(loader.ptr(t) for t in cols),
        loader.ptr(out_ids), loader.ptr(out_d), loader.ptr(out_acc),
        loader.ptr(out_ev), loader.c_int(q), loader.c_int(l), loader.c_int(n),
        loader.stream(ids),
    )
    return out_ids, out_d, out_acc, out_ev
