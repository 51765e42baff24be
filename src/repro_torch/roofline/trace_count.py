"""Per-device dot FLOPs and collective bytes of a traced step — twin of
``src/repro/roofline/hlo_parse.py``.

The reference parses the compiled per-device HLO, multiplying loop bodies
by their trip counts.  The port has no compiled artifact: its step is
eager PyTorch on each rank's local tensors, so a ``TorchDispatchMode``
sees every aten op the rank runs (loops unrolled, the backward and the
remat recompute included) with its real shapes, and counts:

  * dot FLOPs of ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` / convolutions,
    at ``torch.utils.flop_counter``'s formulas, on the operands the op got
    (local tensors, so per device; a ``FlopCounterMode`` above DTensors
    would count the whole logical op);
  * collective bytes by kind (all-gather, all-reduce, reduce-scatter,
    all-to-all): each collective's output bytes on the rank, as
    ``hlo_parse`` counts the output shapes, whether it came through
    ``torch.distributed`` (``c10d.*``, whose all-reduce holds its tensors
    in a list) or the functional collectives (``_c10d_functional.*``).

``LiveBytes`` is the trace's memory twin of XLA's ``memory_analysis``: the
peak of the bytes that the ops' outputs hold alive (``torch.distributed.
_tools.MemTracker`` refuses a module that runs forward more than once a
trace, as the microbatched step does).

Under ``FakeTensorMode`` over a fake process group (``launch.dryrun``) the
same trace costs no memory and no communication.
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten
DOT_OPS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm,
           _aten.convolution, _aten._convolution,
           _aten.convolution_backward}

# (op name without the namespace's prefix) -> (kind, which output)
_COLLECTIVES = {
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "all_to_all_single": "all-to-all",
}


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(t) for t in x)
    return 0


class TraceCount(TorchDispatchMode):
    """Counts what the ops dispatched under it do on this rank:
    ``flops`` (dot FLOPs), ``coll_bytes`` and ``coll_by_kind`` (bytes by
    kind), ``coll_calls`` (collectives by kind)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.coll_bytes = 0.0
        self.coll_by_kind: Dict[str, float] = {}
        self.coll_calls: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in DOT_OPS:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        elif func.namespace in ("c10d", "_c10d_functional"):
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is not None:
                self._collective(kind, packet.__name__, args, out)
        return out

    def _collective(self, kind, name, args, out):
        # the c10d ops (``allreduce_``, ``_allgather_base_``, ...) write
        # into their first argument (a tensor, or a list of them); the
        # functional ones return their output
        n = _bytes(args[0] if name.endswith("_") else out)
        self.coll_bytes += n
        self.coll_by_kind[kind] = self.coll_by_kind.get(kind, 0.0) + n
        self.coll_calls[kind] = self.coll_calls.get(kind, 0) + 1


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages that ops dispatched under it create, alive
    now (``live``) and at most (``peak``).  A storage counts once however
    many views it has, and stops counting when its last view is freed;
    storages made before (``exclude``: the state, the batch) never
    count."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}

    def exclude(self, tensors) -> None:
        for t in tensors:
            self._seen[t.untyped_storage()._cdata] = 0

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out
