"""Logical-axis -> mesh-axis sharding rules — port of
``src/repro/distributed/sharding.py`` (lines 1-329).

Parameters carry *logical* axis names (``Model.specs``, models/layers.py);
this module resolves them against a mesh.  The default rules implement:

  * tensor parallelism on "model": heads / kv / mlp / vocab / experts dims
  * FSDP (ZeRO-3-style) on "data": the "embed" dim of weight matrices
  * "pod" (multi-pod) extends the batch axis only.

Every function is a pure function of a logical spec, a shape and the mesh's
axis sizes, which come from a ``DeviceMesh`` or from a plain ``{name:
size}`` map (``axis_sizes``).  A spec is a tuple whose entries are the
reference's ``PartitionSpec`` entries (None, an axis name, or a tuple of
axis names), so ``tuple(reference_spec) == port_spec``; ``NamedSharding``
pairs one with its mesh, and ``placements`` turns it into DTensor
``Shard`` / ``Replicate`` placements over a ``DeviceMesh``.

The hints (reference lines 46-120) are where sharded execution sets the
layout, with explicit collectives over the mesh's groups where GSPMD would
insert them.  Outside ``activation_hints`` every hint and every collective
below is the identity, and so is a collective over an axis of size 1, so
the one-device paths run the ops they ran before.  Inside it the model runs
on each rank's **local** tensors (``train.loop``'s sharded step):

  * ``param_hint`` all-gathers a weight's FSDP ("data") shard just before
    use and keeps its "model" shard; its backward reduce-scatters the
    cotangent back to the shard (the reference's custom-VJP constraint on
    the value and on its cotangent).  It reads the resolved spec from the
    local leaf (``tag``), since a local shape cannot say which dims were
    sharded.
  * ``hint(x, spec_fn)`` takes an activation that is batch-sharded and
    whole on every other dim to ``spec_fn``'s layout: the dims the spec
    names "model" are split (the backward all-gathers).
  * tensor parallelism is Megatron's: ``region_in`` / ``region_out`` around
    a layer whose work is split over "model" (identity / all-reduce of the
    cotangent in, all-reduce / identity out; with sequence parallelism an
    all-gather / reduce-scatter of the sequence dim instead), and
    ``gather`` / ``all_reduce`` / ``partial`` for what runs inside.  Inside
    a region each rank's cotangents are partial sums over "model", which
    the region's entry and every ``partial`` weight add up.

Serving runs the same way (``train.loop.make_serve_step`` /
``make_prefill_step``): the decode cache is placed by ``cache_shardings``
(``init_cache`` inside the hints makes each rank's leaves, ``shard_cache``
/ ``gather_cache`` place a whole one and gather it back), every local leaf
carries its resolved spec (``tag``), and the attention and SSM layers read
it.  A batch the batch axes do not divide is whole on every rank
(``activation_hints(mesh, batch_split=False)``): the cache's sequence
splits over "data" instead, and ``batch_axis`` is None.  On a gloo group a
tensor on the card goes through host memory; ``TRAFFIC`` counts the bytes
handed to the collectives, by kind.

``abstract_mesh`` is JAX's: a ``{name: size}`` map takes its place.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

Spec = Tuple

_HINT_MESH = None
_BATCH_SPLIT = True

# bytes handed to the collectives below, by kind (the output of a gather or
# a reduce-scatter, the tensor of an all-reduce), and their number
TRAFFIC: collections.Counter = collections.Counter()


class NamedSharding(NamedTuple):
    """A spec over a mesh (a ``DeviceMesh`` or ``{name: size}``)."""
    mesh: Any
    spec: Spec

    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of such a map."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return {a: n for a, (n, _, _) in mesh_info(mesh).items()}


_MESH_INFO: Dict[int, Tuple[Any, Dict]] = {}


def mesh_info(mesh) -> Dict[str, Tuple[int, int, Any]]:
    """``{axis: (size, this rank's index, process group or None)}`` of a
    ``DeviceMesh``, read once (outside any ``FakeTensorMode``: the mesh
    keeps its ranks in a real tensor) and kept with the mesh."""
    hit = _MESH_INFO.get(id(mesh))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        shape = tuple(mesh.mesh.shape)
        info = {a: (n, mesh.get_local_rank(a),
                    mesh.get_group(a) if n > 1 else None)
                for a, n in zip(mesh.mesh_dim_names, shape)}
    _MESH_INFO[id(mesh)] = (mesh, info)
    return info


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``, one per mesh axis:
    ``Shard(i)`` where the spec's dim i names the axis, else
    ``Replicate()``.  A dim named by several axes (``("pod", "data")``) is
    sharded over them in the mesh's order, major first, as in JAX.  Read
    from the resolved spec, never from the logical names: a dim the axis
    does not divide was resolved to None and stays replicated (DTensor
    would shard it unevenly without complaint)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for a in axis_sizes(mesh):
        dims = [i for i, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _entry(axes: Tuple[str, ...]):
    """A spec entry of ``axes``: one axis by its name (``PartitionSpec``
    keeps ``("data",)`` as ``"data"``)."""
    return axes[0] if len(axes) == 1 else axes


def _bspec_axes(mesh, dim: int):
    sizes = axis_sizes(mesh)
    baxes = batch_axes(mesh)
    bsize = int(np.prod([sizes[a] for a in baxes]))
    return _entry(baxes) if dim % bsize == 0 else None


def qkv_spec(mesh, shape) -> Spec:
    """Grouped-query activations (b, s, nkv, g, hd) / (b, s, h, hd):
    shard batch over (pod, data); shard kv heads over model when divisible,
    else shard the query-group dim (MQA: many groups per kv head)."""
    m = axis_sizes(mesh).get("model", 1)
    spec = [_bspec_axes(mesh, shape[0])] + [None] * (len(shape) - 1)
    if len(shape) >= 5:
        if shape[2] % m == 0:
            spec[2] = "model"
        elif shape[3] % m == 0:
            spec[3] = "model"
    elif len(shape) == 4:
        if shape[2] % m == 0:
            spec[2] = "model"
    return tuple(spec)


def heads_concat_spec(mesh, shape) -> Spec:
    """(b, s, h*hd) attention output before wo: shard the flattened head dim
    over model (row-parallel input)."""
    m = axis_sizes(mesh).get("model", 1)
    last = "model" if shape[-1] % m == 0 else None
    return (_bspec_axes(mesh, shape[0]), *([None] * (len(shape) - 2)), last)


def residual_spec(mesh, shape) -> Spec:
    """Residual stream (b, s, d): batch-sharded, d replicated."""
    return (_bspec_axes(mesh, shape[0]), *([None] * (len(shape) - 1)))


def seq_parallel_spec(mesh, shape) -> Spec:
    """Residual stream (b, s, d) with the SEQUENCE dim sharded over the
    model axis (Megatron-style sequence parallelism)."""
    m = axis_sizes(mesh).get("model", 1)
    seq = "model" if len(shape) >= 3 and shape[1] % m == 0 else None
    return (_bspec_axes(mesh, shape[0]), seq, None)


def moe_buffer_spec(mesh, shape) -> Spec:
    """(E*cap, d) expert dispatch buffer: shard slots over data."""
    d = axis_sizes(mesh).get("data", 1)
    return ("data" if shape[0] % d == 0 else None, None)


def moe_hidden_spec(mesh, shape) -> Spec:
    """(E, cap, f) expert hidden activations: capacity slots over data, the
    FFN hidden dim over model."""
    sizes = axis_sizes(mesh)
    d, m = sizes.get("data", 1), sizes.get("model", 1)
    cap = "data" if shape[1] % d == 0 else None
    hid = "model" if shape[2] % m == 0 else None
    return (None, cap, hid)


def moe_out_spec(mesh, shape) -> Spec:
    """(E, cap, d) expert outputs: capacity over data, d replicated."""
    d = axis_sizes(mesh).get("data", 1)
    return (None, "data" if shape[1] % d == 0 else None, None)


def ssm_state_spec(mesh, shape) -> Spec:
    """(b, s, di, ds) / (b, di, ds) scan tensors: batch + d_inner over
    model."""
    m = axis_sizes(mesh).get("model", 1)
    spec = [_bspec_axes(mesh, shape[0])] + [None] * (len(shape) - 1)
    di_axis = len(shape) - 2
    if shape[di_axis] % m == 0:
        spec[di_axis] = "model"
    return tuple(spec)


DEFAULT_RULES: Dict[Optional[str], Optional[Tuple[str, ...]]] = {
    "embed": ("data",),        # FSDP
    "heads": ("model",),
    "kv": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    None: None,
}


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def logical_to_spec(
    logical: Tuple[Optional[str], ...],
    rules: Dict[Optional[str], Optional[Tuple[str, ...]]] = None,
    shape: Optional[Tuple[int, ...]] = None,
    mesh=None,
) -> Spec:
    """Resolve one logical spec tuple to a spec.  If ``shape`` + ``mesh``
    are given, axes that don't divide evenly fall back to replication (e.g.
    kv=1 MQA heads can't be sharded 16-ways)."""
    rules = rules or DEFAULT_RULES
    sizes = axis_sizes(mesh) if mesh is not None else None
    out = []
    used = set()
    for i, name in enumerate(logical):
        mapped = rules.get(name)
        if mapped is None:
            out.append(None)
            continue
        mapped = tuple(m for m in mapped if m not in used)
        if not mapped:
            out.append(None)
            continue
        if shape is not None and sizes is not None:
            size = int(np.prod([sizes[m] for m in mapped]))
            if shape[i] % size != 0:
                out.append(None)
                continue
        used.update(mapped)
        out.append(mapped if len(mapped) > 1 else mapped[0])
    return tuple(out)


def param_shardings(specs: Dict, params: Dict, mesh, rules=None) -> Dict:
    """``NamedSharding`` of every parameter: ``specs`` maps names (or
    nested dicts) to logical tuples, ``params`` the same names to tensors
    (or anything with a ``shape``) or to shapes."""
    out = {}
    for k, spec in specs.items():
        if isinstance(spec, dict):
            out[k] = param_shardings(spec, params[k], mesh, rules)
        else:
            shape = tuple(getattr(params[k], "shape", params[k]))
            out[k] = NamedSharding(mesh, logical_to_spec(spec, rules, shape,
                                                         mesh))
    return out


def batch_sharding(mesh) -> NamedSharding:
    """Batch pytrees: leading dim over (pod, data)."""
    return NamedSharding(mesh, batch_spec(mesh))


def batch_spec(mesh) -> Spec:
    return (_entry(batch_axes(mesh)),)


def cache_shardings(mesh, cache, cfg, seq_shard: bool = False):
    """Decode-cache shardings: a ``DecodeCache`` of ``NamedSharding``s (None
    where the cache has no tensor).  KV caches (n_layers, B, cap, Hkv, hd):
    batch over (pod,data) when divisible; kv heads over model when
    divisible; the cap/sequence dim over model for MQA / small kv, over data
    when the batch is unshardable (sequence-parallel KV)."""
    sizes = axis_sizes(mesh)
    baxes = batch_axes(mesh)
    bsize = int(np.prod([sizes[a] for a in baxes]))
    baxes = _entry(baxes)
    msize = sizes["model"]

    def spec_for(name, arr) -> Spec:
        ndim, shape = np.ndim(arr), np.shape(arr)
        if ndim == 0:
            return ()
        if name in ("kv_k", "kv_v") and ndim == 5:
            b, cap, hkv = shape[1], shape[2], shape[3]
            pb = baxes if b % bsize == 0 else None
            ph = "model" if hkv % msize == 0 else None
            pseq = None
            if ph is None and cap % msize == 0:
                pseq = "model"
            if pb is None and cap % (sizes["data"] * (
                    msize if pseq == "model" else 1)) == 0:
                pseq = ("data", "model") if pseq == "model" else "data"
            return (None, pb, pseq, ph, None)
        if name == "enc_out" and ndim == 3:
            pb = baxes if shape[0] % bsize == 0 else None
            return (pb, None, None)
        if ndim >= 2:  # ssm/conv states: (n, B, ...)
            pb = baxes if shape[1] % bsize == 0 else None
            rest = [None] * (ndim - 2)
            # shard the widest state dim over model if divisible
            widths = list(shape[2:])
            if widths:
                j = int(np.argmax(widths))
                if widths[j] % msize == 0:
                    rest[j] = "model"
            return (None, pb, *rest)
        return ()

    return type(cache)(*(
        None if v is None else NamedSharding(mesh, spec_for(f, v))
        for f, v in zip(cache._fields, cache)))


# ---------------------------------------------------------------------------
# Hints: sharded execution on local tensors
# ---------------------------------------------------------------------------

class activation_hints:
    """Context manager under which the model runs sharded over ``mesh`` (a
    ``DeviceMesh``): the hints below set the layout with collectives over
    its groups.  Outside it they are the identity (one-device paths stay
    as they are).  The backward of a step must run inside it too: a block's
    recompute under remat runs its hints again.  ``batch_split``: each rank
    holds its rows of the batch (its block over the batch axes); False, the
    whole batch (a serving batch the axes do not divide)."""

    def __init__(self, mesh, batch_split: bool = True):
        self.mesh = mesh
        self.batch_split = batch_split

    def __enter__(self):
        global _HINT_MESH, _BATCH_SPLIT
        self._old = _HINT_MESH, _BATCH_SPLIT
        _HINT_MESH, _BATCH_SPLIT = self.mesh, self.batch_split
        return self.mesh

    def __exit__(self, *exc):
        global _HINT_MESH, _BATCH_SPLIT
        _HINT_MESH, _BATCH_SPLIT = self._old
        return False


def hint_mesh():
    """The mesh of the enclosing ``activation_hints``, or None."""
    return _HINT_MESH


def batch_entry():
    """The spec entry of the batch dim inside ``activation_hints``: the
    batch axes when each rank holds its rows, else None (also outside)."""
    if _HINT_MESH is None or not _BATCH_SPLIT:
        return None
    return _entry(batch_axes(_HINT_MESH))


def global_batch(rows: int) -> int:
    """The global batch of a rank's ``rows`` of it."""
    if batch_entry() is None:
        return rows
    sizes = axis_sizes(_HINT_MESH)
    return rows * int(np.prod([sizes[a] for a in batch_axes(_HINT_MESH)]))


class Axis(NamedTuple):
    group: Any
    size: int
    rank: int


def mesh_axis(name: str) -> Optional[Axis]:
    """(process group, size, this rank's index) of the hint mesh's axis
    ``name``; None outside ``activation_hints``, for an axis the mesh
    lacks, and for one of size 1, where there is nothing to communicate."""
    mesh = _HINT_MESH
    if mesh is None:
        return None
    size, rank, group = mesh_info(mesh).get(name, (1, 0, None))
    return None if size == 1 else Axis(group, size, rank)


def batch_axis(name: str) -> Optional[Axis]:
    """``mesh_axis(name)`` where the batch splits over it; None where every
    rank of the axis holds the same rows (``batch_split=False``)."""
    return mesh_axis(name) if _BATCH_SPLIT else None


def _staged(x: torch.Tensor, ax: Axis) -> bool:
    """Whether ``x`` goes through host memory: a tensor on the card over a
    gloo group."""
    return x.is_cuda and dist.get_backend(ax.group) == "gloo"


def _count(kind: str, t: torch.Tensor) -> None:
    TRAFFIC[kind] += t.numel() * t.element_size()
    TRAFFIC["collectives"] += 1


def _ag(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    dev = x.device
    x = x.movedim(dim, 0).contiguous()
    staged = _staged(x, ax)
    if staged:
        x = x.cpu()
    out = x.new_empty((ax.size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=ax.group)
    _count("all-gather", out)
    return (out.to(dev) if staged else out).movedim(0, dim)


def _rs(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    dev = x.device
    x = x.movedim(dim, 0).contiguous()
    staged = _staged(x, ax)
    if staged:
        x = x.cpu()
    out = x.new_empty((x.shape[0] // ax.size, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=ax.group)
    _count("reduce-scatter", out)
    return (out.to(dev) if staged else out).movedim(0, dim)


def _ar(x: torch.Tensor, ax: Axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    staged = _staged(x, ax)
    out = x.contiguous().cpu() if staged else x.contiguous().clone()
    dist.all_reduce(out, op=op, group=ax.group)
    _count("all-reduce", out)
    return out.to(x.device) if staged else out


def _chunk(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.rank * n, n).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax, grad_sum):
        ctx.dim, ctx.ax, ctx.grad_sum = dim, ax, grad_sum
        return _ag(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        g = (_rs(g, ctx.dim, ctx.ax) if ctx.grad_sum
             else _chunk(g, ctx.dim, ctx.ax))
        return g, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _rs(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _ag(g, ctx.dim, ctx.ax), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _chunk(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _ag(g, ctx.dim, ctx.ax), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, grad_sum):
        ctx.ax, ctx.grad_sum = ax, grad_sum
        return _ar(x, ax)

    @staticmethod
    def backward(ctx, g):
        return (_ar(g, ctx.ax) if ctx.grad_sum else g), None, None


class _Partial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ar(g, ctx.ax), None


def gather(x: torch.Tensor, dim: int, axis: str = "model",
           grad: str = "sum") -> torch.Tensor:
    """``x`` all-gathered along ``dim`` over ``axis``.  The cotangent is
    reduce-scattered (``grad="sum"``: each rank's use added a partial sum)
    or sliced (``"slice"``: every rank's use was the same whole
    computation)."""
    ax = mesh_axis(axis)
    return x if ax is None else _Gather.apply(x, dim, ax, grad == "sum")


def reduce_scatter(x: torch.Tensor, dim: int,
                   axis: str = "model") -> torch.Tensor:
    """The sum over ``axis`` of ``x``, this rank's slice of ``dim``; the
    cotangent is all-gathered."""
    ax = mesh_axis(axis)
    return x if ax is None else _ReduceScatter.apply(x, dim, ax)


def split(x: torch.Tensor, dim: int, axis: str = "model") -> torch.Tensor:
    """This rank's slice of ``dim`` of a tensor every rank of ``axis``
    holds whole; the cotangent is all-gathered."""
    ax = mesh_axis(axis)
    return x if ax is None else _Split.apply(x, dim, ax)


def all_reduce(x: torch.Tensor, axis: str = "model",
               grad: str = "identity") -> torch.Tensor:
    """The sum over ``axis`` of ``x``.  Its cotangent passes through
    (``"identity"``: what follows is the same on every rank, out of a
    region) or is all-reduced too (``"sum"``: what follows is split, inside
    a region)."""
    ax = mesh_axis(axis)
    return x if ax is None else _AllReduce.apply(x, ax, grad == "sum")


def all_reduce_max(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The elementwise max over ``axis`` (no gradient)."""
    ax = mesh_axis(axis)
    return x if ax is None else _ar(x.detach(), ax, dist.ReduceOp.MAX)


def partial(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """``x`` itself; its cotangent, a partial sum on each rank of
    ``axis``, is all-reduced."""
    ax = mesh_axis(axis)
    return x if ax is None else _Partial.apply(x, ax)


def region_in(x: torch.Tensor, split_work: bool, sp: bool) -> torch.Tensor:
    """Into a layer, from the residual layout (batch-sharded; with sequence
    parallelism ``sp`` the sequence dim split over "model" too) to the
    whole sequence on every "model" rank.  ``split_work``: the layer splits
    its work over "model" (a tensor-parallel region), so the cotangents
    that come back are partial sums."""
    if sp:
        return gather(x, 1, "model", "sum" if split_work else "slice")
    return partial(x) if split_work else x


def region_out(y: torch.Tensor, split_work: bool, sp: bool) -> torch.Tensor:
    """Out of a layer, back to the residual layout: a region's partial sums
    are all-reduced (reduce-scattered along the sequence under ``sp``); a
    whole result is sliced along the sequence under ``sp``."""
    if sp:
        return (reduce_scatter(y, 1) if split_work else split(y, 1))
    return all_reduce(y) if split_work else y


def summed_product(x: torch.Tensor, w: torch.Tensor,
                   grad: str = "identity") -> torch.Tensor:
    """``all_reduce(x @ w, "model", grad)``: a row-parallel product, this
    rank's block of the contraction summed over "model".  Serving (autograd
    off) on a low-precision ``x`` keeps each rank's partial product in f32
    and casts the sum once, as one device's product accumulates in f32 and
    rounds once (partials rounded to bf16 before the sum move the logits
    by several bf16 steps over a deep model); training keeps the
    all-reduce in the activations' dtype."""
    ax = mesh_axis("model")
    if (ax is not None and x.dtype != torch.float32
            and not torch.is_grad_enabled()):
        return _ar(x.float() @ w.float(), ax).to(x.dtype)
    return all_reduce(x @ w, grad=grad)


def row_out(x: torch.Tensor, w: torch.Tensor, split_work: bool,
            sp: bool) -> torch.Tensor:
    """``region_out(x @ w, split_work, sp)``: a layer's output projection
    back to the residual layout, a row-parallel one summed by
    ``summed_product``."""
    if split_work and not sp:
        return summed_product(x, w)
    return region_out(x @ w, split_work, sp)


def seq_partial(w: torch.Tensor, sp: bool) -> torch.Tensor:
    """A weight used on this rank's slice of the sequence (the norms under
    sequence parallelism): its gradient is a partial sum over "model"."""
    return partial(w) if sp else w


def spec_axes(spec: Spec) -> set:
    """Every mesh axis a spec names."""
    return {a for e in spec for a in entry_axes(e)}


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor placed by a
    resolved ``spec`` over ``mesh`` (a ``DeviceMesh`` or ``{name:
    size}``)."""
    sizes = axis_sizes(mesh)
    return tuple(n // int(np.prod([sizes[a] for a in entry_axes(e)]))
                 for n, e in zip(shape, spec))


def _split_of(mesh, entry) -> Tuple[int, int]:
    """(how many blocks a dim of spec ``entry`` is cut into over ``mesh``,
    this rank's block), the major axis first."""
    info = mesh_info(mesh)
    n, r = 1, 0
    for a in entry_axes(entry):
        size, rank, _ = info[a]
        n, r = n * size, r * size + rank
    return n, r


def local_shard(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's shard of a whole tensor ``t`` placed by the resolved
    ``spec`` over ``mesh`` (a ``DeviceMesh``): a copy of its block where a
    dim is split, ``t`` itself (detached) where none is."""
    t = t.detach()
    for i, e in enumerate(spec):
        n, r = _split_of(mesh, e)
        if n > 1:
            size = t.shape[i] // n
            t = t.narrow(i, r * size, size).clone()
    return t


def full_tensor(t: torch.Tensor, mesh, spec: Optional[Spec] = None
                ) -> torch.Tensor:
    """The whole tensor of this rank's shard ``t`` (of ``spec``, else the
    one ``tag`` put on it), all-gathered over ``mesh``'s groups, the minor
    axis of a dim first.  Every rank of the mesh must call it."""
    spec = getattr(t, "_shard_spec", ()) if spec is None else spec
    info = mesh_info(mesh)
    for i, e in enumerate(spec):
        for a in reversed(entry_axes(e)):
            size, rank, group = info[a]
            if size > 1:
                t = _ag(t, i, Axis(group, size, rank))
    return t


def shard_cache(cache, mesh, cfg):
    """A whole ``DecodeCache`` as this rank's leaves, placed by
    ``cache_shardings`` and tagged with their specs."""
    sh = cache_shardings(mesh, cache, cfg)
    return cache._replace(**{
        f: tag(local_shard(v, s.spec, mesh), s.spec)
        for f, v, s in zip(cache._fields, cache, sh)
        if isinstance(v, torch.Tensor)})


def gather_cache(cache, mesh):
    """The whole ``DecodeCache`` of this rank's tagged leaves (every rank
    calls it)."""
    return cache._replace(**{f: full_tensor(v, mesh)
                             for f, v in zip(cache._fields, cache)
                             if isinstance(v, torch.Tensor)})


def split_of(entry) -> Tuple[int, int]:
    """(blocks, this rank's block) of a dim of spec ``entry`` over the hint
    mesh; (1, 0) outside ``activation_hints``."""
    return (1, 0) if _HINT_MESH is None else _split_of(_HINT_MESH, entry)


def live_axes(entry) -> Tuple[str, ...]:
    """The axes of a spec entry that hold more than one rank of the hint
    mesh: the ones a collective must run over."""
    return tuple(a for a in entry_axes(entry) if mesh_axis(a) is not None)


def reshard(t: torch.Tensor, src: Optional[int], dst: Optional[int],
            axis: str = "model") -> torch.Tensor:
    """``t`` split along dim ``src`` over ``axis`` (None: whole) as split
    along ``dst`` (None: whole): gathered, then this rank's block taken."""
    if src == dst:
        return t
    if src is not None:
        t = gather(t, src, axis)
    return t if dst is None else split(t, dst, axis)


def tag(t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """Marks a local tensor as the shard of a weight of resolved ``spec``
    (``param_hint`` reads it); returns ``t``."""
    t._shard_spec = tuple(spec)
    return t


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes a spec entry names (None, an axis, or a tuple of
    them), major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def param_hint(x: torch.Tensor, logical: Tuple[Optional[str], ...]):
    """A weight as the layer uses it: its FSDP ("data") shard all-gathered,
    its "model" shard kept; the cotangent is reduce-scattered back to the
    shard.  The resolved spec is the one ``tag`` put on the local leaf
    (``logical`` names the weight's axes, as in the reference); a tensor
    without one is used as it is."""
    spec = getattr(x, "_shard_spec", None)
    if _HINT_MESH is None or spec is None:
        return x
    out = x
    for i, e in enumerate(spec):
        if "data" in entry_axes(e):
            out = gather(out, i, "data")
    if out is x:
        return x
    return tag(out, tuple("model" if "model" in entry_axes(e) else None
                          for e in spec))


def param_hints(p: dict, logical: dict) -> dict:
    """param_hint over a dict of weights (missing keys pass through)."""
    return {k: param_hint(v, logical[k]) if k in logical else v
            for k, v in p.items()}


def model_dim(w: torch.Tensor) -> Optional[int]:
    """The dim of a hinted weight that is split over "model" (None when it
    is whole, or outside a "model" axis of size > 1)."""
    spec = getattr(w, "_shard_spec", None)
    if spec is None or mesh_axis("model") is None:
        return None
    dims = [i for i, e in enumerate(spec) if "model" in entry_axes(e)]
    return dims[0] if dims else None


def whole(w: torch.Tensor, grad: str = "sum") -> torch.Tensor:
    """A hinted weight whole over "model": gathered if it is split there.
    ``grad`` as in ``gather``; inside a region (``"sum"``) a weight that is
    already whole gets its partial cotangents added (``partial``)."""
    d = model_dim(w)
    if d is not None:
        return gather(w, d, "model", grad)
    return partial(w) if grad == "sum" else w


def local_block(w: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """This "model" rank's ``n`` entries of ``dim`` of a hinted weight, for
    a region: the shard itself when the weight is split there, else a slice
    of the whole weight."""
    if model_dim(w) == dim:
        return w
    ax = mesh_axis("model")
    return whole(w).narrow(dim, ax.rank * n, n)


def hint(x: torch.Tensor, spec_fn) -> torch.Tensor:
    """An activation in ``spec_fn``'s layout.  ``x`` is this rank's rows of
    the batch (the step shards it over the batch axes) and whole on every
    other dim; the dims ``spec_fn(mesh, global shape)`` names "model" are
    split (``split``: the cotangent is all-gathered)."""
    mesh = _HINT_MESH
    if mesh is None:
        return x
    sizes = axis_sizes(mesh)
    bsize = int(np.prod([sizes[a] for a in batch_axes(mesh)]))
    spec = spec_fn(mesh, (x.shape[0] * bsize, *x.shape[1:]))
    for i, e in enumerate(spec):
        if "model" in entry_axes(e):
            x = split(x, i, "model")
    return x
