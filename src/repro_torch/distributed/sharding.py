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

Left out: ``hint``, ``param_hint``, ``param_hints`` and
``activation_hints`` (reference lines 46-120) only constrain GSPMD, and the
port's step is data-parallel with replicated parameters (``train.loop``):
they come with sharded execution (ROADMAP).  ``abstract_mesh`` is JAX's: a
``{name: size}`` map takes its place.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np

Spec = Tuple


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
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


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
