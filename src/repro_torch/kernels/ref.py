"""Plain PyTorch oracles for every kernel — port of
``src/repro/kernels/ref.py``, under the reference's names.  Each is the plain
version that lives beside its kernel."""
from repro_torch.kernels.bitonic_topk import (
    bitonic_sort_pairs_plain as bitonic_sort_pairs_ref,
)
from repro_torch.kernels.l2_rerank import l2_rerank_plain as l2_rerank_ref
from repro_torch.kernels.pq_adt import pq_adt_plain as pq_adt_ref
from repro_torch.kernels.pq_lookup import pq_lookup_plain as pq_lookup_ref

__all__ = ["bitonic_sort_pairs_ref", "l2_rerank_ref", "pq_adt_ref",
           "pq_lookup_ref"]
