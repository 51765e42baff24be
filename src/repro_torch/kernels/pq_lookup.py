"""PQ distance evaluation, Eq. (3) of the paper.

Replaces the TPU kernel ``src/repro/kernels/pq_lookup.py::pq_lookup``
(``pl.pallas_call`` at ``pq_lookup.py:55``) with the CUDA kernels of
``csrc/pq_lookup.cu``.  The TPU kernel is a one-hot MXU product because a
TPU has no fast gather; on Hopper it is a gather: one warp per scored row,
lane m reading code byte m and then ADT[m, code] straight from device memory
(L2), the warp summing by shuffles.  The lists entry is the exception: one
probe's ADT staged in shared memory for a run of that list's rows.

Three functions, each with its plain version:

* ``pq_lookup``: (N, M) uint8 codes, one (M, C) ADT -> (N,) — the reference
  signature, kept for the parity tests;
* ``pq_lookup_gather``: (Q, n) int32 neighbour ids, the (N, M) uint8 code
  table, (Q, M, C) ADTs and an optional (Q, n) bool mask -> (Q, n); the
  kernel gathers the code rows itself, and a masked-off pair reads nothing
  and gets +inf.  The search calls this one every round, masked by "fresh".
* ``pq_lookup_lists``: (Q, P) int32 probed lists, (nlist,) int32 list
  lengths, the (nlist, max_len, M) uint8 list codes and (A, M, C) ADTs (A =
  Q*P: one a probe; A = Q: one a query, shared by its P probes) -> (Q, P,
  max_len): each probe's list scored as the reference's ``pq_lookup`` of
  ``list_codes[probe]`` against its ADT, +inf at each slot >= the list's
  length.  IVF-PQ's search calls this one.

What bounds it on the card: the bytes of the rows it scores (id, M code
bytes, M ADT entries each) and, at a round's size, the latency of the
dependent id -> code -> ADT loads.  The warp's tree sum adds in another order
than the plain version, hence the tolerance rtol/atol 1e-4.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import loader

INF = float("inf")
SMEM_MAX = 232448     # bytes of shared memory a block may ask for (227 KB)


def pq_lookup_plain(codes: torch.Tensor, adt: torch.Tensor) -> torch.Tensor:
    """(N, M) uint8, (M, C) -> (N,).  Codes are widened before indexing:
    torch reads a uint8 index tensor as a boolean mask."""
    m = adt.shape[0]
    return adt[torch.arange(m, device=adt.device)[None, :], codes.long()].sum(-1)


def pq_lookup_gather_plain(ids: torch.Tensor, codes: torch.Tensor,
                           adts: torch.Tensor,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, n) ids, (N, M) uint8 table, (Q, M, C), optional (Q, n) bool mask
    -> (Q, n), +inf where the mask is False."""
    q, n = ids.shape
    m, c = adts.shape[1:]
    rows = codes[ids.long()].long()                            # (Q, n, M)
    flat = adts.reshape(q, 1, m * c).expand(q, n, m * c)
    d = flat.gather(2, rows + torch.arange(m, device=ids.device) * c).sum(-1)
    return d if mask is None else torch.where(mask, d, INF)


def pq_lookup_lists_plain(probes: torch.Tensor, lengths: torch.Tensor,
                          list_codes: torch.Tensor,
                          adts: torch.Tensor) -> torch.Tensor:
    """(Q, P) probes, (nlist,) lengths, (nlist, max_len, M) uint8, (Q*P or
    Q, M, C) -> (Q, P, max_len), +inf at each slot >= the list's length.
    The gather and sum of ``pq_lookup_gather_plain``."""
    q, p = probes.shape
    max_len, m = list_codes.shape[1:]
    c = adts.shape[2]
    lists = probes.long()
    rows = list_codes[lists].long()                    # (Q, P, max_len, M)
    lanes = adts.reshape(q, -1, 1, m * c)              # (Q, P or 1, 1, M*C)
    flat = lanes.expand(q, p, max_len, m * c)
    d = flat.gather(3, rows + torch.arange(m, device=probes.device) * c)
    slots = torch.arange(max_len, device=probes.device)
    return torch.where(slots < lengths[lists][..., None], d.sum(-1), INF)


def pq_lookup_cuda(codes: torch.Tensor, adt: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: (N, M) u8, (M, C) f32 -> (N,) f32."""
    loader.check(codes, "pq_lookup codes", torch.uint8, 2)
    loader.check(adt, "pq_lookup adt", torch.float32, 2)
    n, m = codes.shape
    if adt.shape[0] != m or adt.device != codes.device:
        raise ValueError(f"pq_lookup: codes {tuple(codes.shape)} do not fit "
                         f"ADT {tuple(adt.shape)}")
    out = torch.empty((n,), dtype=torch.float32, device=codes.device)
    loader.launch(
        "pq_lookup", "pq_lookup_launch", "pq_lookup", codes.device,
        loader.ptr(codes), loader.ptr(adt), loader.ptr(out),
        loader.c_int(n), loader.c_int(m), loader.c_int(adt.shape[1]),
        loader.stream(codes),
    )
    return out


def pq_lookup_gather_cuda(ids: torch.Tensor, codes: torch.Tensor,
                          adts: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: (Q, n) i32 ids, (N, M) u8, (Q, M, C) f32,
    optional (Q, n) bool mask -> (Q, n) f32, +inf where the mask is False.
    An id outside [0, N), masked or not, traps in the kernel (a raw pointer
    does not wrap -1 padding): callers clamp first, like the reference."""
    loader.check(ids, "pq_lookup_gather ids", torch.int32, 2)
    loader.check(codes, "pq_lookup_gather codes", torch.uint8, 2)
    loader.check(adts, "pq_lookup_gather adts", torch.float32, 3)
    if mask is not None:
        loader.check(mask, "pq_lookup_gather mask", torch.bool, 2)
    q, n = ids.shape
    big_n, m = codes.shape
    if adts.shape[:2] != (q, m) or not (ids.device == codes.device
                                        == adts.device):
        raise ValueError(f"pq_lookup_gather: ids {tuple(ids.shape)}, codes "
                         f"{tuple(codes.shape)}, ADTs {tuple(adts.shape)}")
    if mask is not None and (mask.shape != ids.shape
                             or mask.device != ids.device):
        raise ValueError(f"pq_lookup_gather: mask {tuple(mask.shape)} does "
                         f"not fit ids {tuple(ids.shape)}")
    out = torch.empty((q, n), dtype=torch.float32, device=ids.device)
    loader.launch(
        "pq_lookup", "pq_lookup_gather_launch", "pq_lookup", ids.device,
        loader.ptr(ids), loader.ptr(mask), loader.ptr(codes), loader.ptr(adts),
        loader.ptr(out),
        loader.c_int(q), loader.c_int(n), loader.c_int(big_n), loader.c_int(m),
        loader.c_int(adts.shape[2]), loader.stream(ids),
    )
    return out


def pq_lookup_lists_cuda(probes: torch.Tensor, lengths: torch.Tensor,
                         list_codes: torch.Tensor,
                         adts: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: (Q, P) i32 probes, (nlist,) i32 lengths,
    (nlist, max_len, M) u8, (Q*P or Q, M, C) f32 -> (Q, P, max_len) f32,
    +inf past each list's length.  A probe outside [0, nlist), a length
    outside [0, max_len] or a code >= C traps in the kernel."""
    loader.check(probes, "pq_lookup_lists probes", torch.int32, 2)
    loader.check(lengths, "pq_lookup_lists lengths", torch.int32, 1)
    loader.check(list_codes, "pq_lookup_lists list_codes", torch.uint8, 3)
    loader.check(adts, "pq_lookup_lists adts", torch.float32, 3)
    q, p = probes.shape
    nlist, max_len, m = list_codes.shape
    a, am, c = adts.shape
    if (a not in (q * p, q) or am != m or lengths.shape[0] != nlist
            or not (probes.device == lengths.device == list_codes.device
                    == adts.device)):
        raise ValueError(f"pq_lookup_lists: probes {tuple(probes.shape)}, "
                         f"lengths {tuple(lengths.shape)}, list codes "
                         f"{tuple(list_codes.shape)}, ADTs {tuple(adts.shape)}")
    if 4 * m * c > SMEM_MAX:
        raise ValueError(f"pq_lookup_lists: an ({m}, {c}) ADT is {4 * m * c} "
                         f"bytes, more than a block's {SMEM_MAX} of shared "
                         "memory")
    out = torch.empty((q, p, max_len), dtype=torch.float32,
                      device=probes.device)
    loader.launch(
        "pq_lookup", "pq_lookup_lists_launch", "pq_lookup", probes.device,
        loader.ptr(probes), loader.ptr(lengths), loader.ptr(list_codes),
        loader.ptr(adts), loader.ptr(out),
        loader.c_int(q), loader.c_int(p), loader.c_int(nlist),
        loader.c_int(max_len), loader.c_int(m), loader.c_int(c),
        loader.c_int(a), loader.stream(probes),
    )
    return out
