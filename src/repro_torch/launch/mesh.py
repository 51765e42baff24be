"""Device meshes over ``torch.distributed`` — port of
``src/repro/launch/mesh.py`` (lines 1-40).

Single pod:  (data=16, model=16)            = 256 devices
Multi-pod:   (pod=2, data=16, model=16)     = 512 devices

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dimensions
are named by ``axes``; ``core.distributed`` reduces over its ``data``
groups and gathers over its ``model`` groups.  Nothing is made at import
time: a mesh needs an initialized default process group of ``prod(shape)``
ranks (``torch.distributed.init_process_group``, with a ``timeout`` so that
a rank left waiting in a collective fails instead of hanging), and every
rank of that group must call the same constructor.  On CUDA each rank binds
the card ``rank % device_count()`` before the mesh is made, which on one
card puts every rank on ``cuda:0``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """An arbitrary mesh (tests, small runs): ``shape`` ranks per axis,
    named by ``axes``, laid out row-major over the global ranks."""
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def chips(mesh: DeviceMesh) -> int:
    return mesh.size()
