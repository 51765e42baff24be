"""Checkpoints in the reference's layout — port of
``src/repro/ckpt/checkpoint.py`` (lines 1-171).

The layout on disk is the reference's, so the two packages restore each
other's checkpoints bit for bit:
  * one ``.npy`` a leaf, holding the leaf's raw bytes as a flat uint8 array;
    leaf names are the reference's pytree paths (``params/blocks/attn/wq``,
    ``opt/mu/...``, ``opt/step``): a state dict's layers are stacked on a
    leading axis (``models.model.stack_layers``) and unstacked on restore;
  * ``manifest.json`` holds the step, each leaf's file, shape, dtype name
    (``bfloat16`` too) and the sha256 of its bytes, and ``extra``.  A bf16
    leaf is written as its ``uint16`` bits and read back by viewing the raw
    bytes, so no ``ml_dtypes`` is needed;
  * writes are atomic: a tmp directory renamed into place, then the
    ``latest`` symlink flipped; ``keep`` old steps are kept;
  * async mode hands the leaves to a writer thread after they are copied to
    the host: the copy ends before ``save_checkpoint`` returns, so a step
    that then updates the parameters in place cannot reach the writer.

``restore_checkpoint`` rebuilds the structure of ``target`` (a
``TrainState``, an ``AdamWState``, a state dict or nested dicts of
tensors): each leaf on its target leaf's device, or, given ``shardings``
(the same structure of ``sharding.NamedSharding`` over a ``DeviceMesh``), a
DTensor placed by the resolved spec.  The data pipeline is step-seeded, so
``step`` alone resumes the exact stream.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import reference_path, stack_layers

_SEP = "/"

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16,
           "int32": torch.int32, "int64": torch.int64,
           "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8,
           "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _is_record(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _flatten_with_paths(tree, prefix=()) -> List[Tuple[str, torch.Tensor]]:
    """(reference path, tensor) of every leaf, a state dict's layers
    stacked."""
    if tree is None:
        return []
    if _is_record(tree):
        return [leaf for f in tree._fields
                for leaf in _flatten_with_paths(getattr(tree, f),
                                                prefix + (f,))]
    if isinstance(tree, dict):
        if all(isinstance(v, torch.Tensor) for v in tree.values()):
            tree = stack_layers(tree)
        return [leaf for k in sorted(tree)
                for leaf in _flatten_with_paths(tree[k], prefix + (k,))]
    return [(_SEP.join(prefix), tree)]


def _rebuild(target, shardings, prefix, read: Callable):
    """``target``'s structure with each leaf ``read(path, layer, leaf,
    sharding)``."""
    if target is None:
        return None
    if _is_record(target):
        return type(target)(*(
            _rebuild(getattr(target, f),
                     None if shardings is None else getattr(shardings, f),
                     prefix + (f,), read) for f in target._fields))
    if isinstance(target, dict):
        out = {}
        for k, v in target.items():
            sh = None if shardings is None else shardings[k]
            if isinstance(v, dict):
                out[k] = _rebuild(v, sh, prefix + (k,), read)
            else:
                path, layer = reference_path(k)
                out[k] = read(_SEP.join(prefix + path), layer, v, sh)
        return out
    return read(_SEP.join(prefix), None, target, shardings)


def _host(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes on the host as numpy (bf16 as its uint16 bits)."""
    from torch.distributed.tensor import DTensor

    t = t.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.to("cpu", copy=True)      # a CPU tensor's .cpu() is itself
    if t.dtype == torch.bfloat16:
        t = t.view(torch.uint16)
    return t.numpy()


def save_checkpoint(
    directory: str,
    step: int,
    state: Any,
    extra: Optional[Dict[str, Any]] = None,
    async_mode: bool = False,
    keep: int = 3,
) -> threading.Thread | None:
    """Persist ``state`` under ``directory/step_{step:08d}``.  A sharded
    state (DTensors) is written whole: every rank of the process group
    calls this (the shards are gathered), and rank 0 writes."""
    import torch.distributed as dist

    # copied to the host BEFORE handing off: the caller's next step updates
    # the parameters in place
    host_leaves = [(n, _NAMES[t.dtype], _host(t))
                   for n, t in _flatten_with_paths(state)]
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    os.makedirs(directory, exist_ok=True)

    def write():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}, "extra": extra or {}}
        for name, dtype, arr in host_leaves:
            fn = name.replace(_SEP, "__") + ".npy"
            raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
            np.save(os.path.join(tmp, fn), raw)
            manifest["leaves"][name] = {
                "file": fn,
                "shape": list(arr.shape),
                "dtype": dtype,
                "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _update_latest(directory, final)
        _gc(directory, keep)

    if async_mode:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _update_latest(directory: str, final: str) -> None:
    link = os.path.join(directory, "latest")
    tmp_link = link + ".tmp"
    if os.path.lexists(tmp_link):
        os.remove(tmp_link)
    os.symlink(os.path.basename(final), tmp_link)
    os.replace(tmp_link, link)


def _gc(directory: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    link = os.path.join(directory, "latest")
    if not os.path.exists(link):
        return None
    name = os.path.basename(os.path.realpath(link))
    return int(name.split("_")[1])


def restore_checkpoint(
    directory: str,
    target: Any,
    step: Optional[int] = None,
    shardings: Any = None,
    validate_digests: bool = False,
) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore into the structure of ``target``; returns (the restored
    tree, its step, the manifest's ``extra``).  ``shardings``: the same
    structure of ``NamedSharding``s over a ``DeviceMesh`` — leaves become
    DTensors (elastic re-meshing: pass shardings built against the NEW
    mesh).  Each leaf file is read once, however many layers it holds."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    loaded: Dict[str, torch.Tensor] = {}

    def leaf(name: str) -> torch.Tensor:
        if name not in loaded:
            meta = manifest["leaves"][name]
            raw = np.load(os.path.join(path, meta["file"]))
            if validate_digests:
                digest = hashlib.sha256(raw.tobytes()).hexdigest()
                if digest != meta["sha256"]:
                    raise IOError(f"digest mismatch for {name} in {path}")
            loaded[name] = torch.from_numpy(raw).view(
                _DTYPES[meta["dtype"]]).reshape(meta["shape"])
        return loaded[name]

    def read(name, layer, like, sh):
        t = leaf(name)
        if layer is not None:
            t = t[layer]
        if sh is None:
            return t.to(like.device, copy=True)
        from torch.distributed.tensor import distribute_tensor

        mesh = sh.mesh
        return distribute_tensor(t.to(mesh.device_type, copy=True), mesh,
                                 sh.placements(), src_data_rank=None)

    tree = _rebuild(target, shardings, (), read)
    return tree, step, manifest["extra"]
