"""Port of ``repro.configs``: the Proxima configuration dataclasses and the
model zoo's registry, ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``.

Architecture ids use dashes (CLI form); module names use underscores.  The
ten architecture modules are imported statically (the reference loads them
through ``importlib``), so every one is reachable by a static import.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (
    deepseek_67b, falcon_mamba_7b, granite_34b, granite_moe_3b_a800m,
    mistral_nemo_12b, mixtral_8x22b, paligemma_3b, seamless_m4t_medium,
    stablelm_1_6b, zamba2_1_2b,
)
from repro_torch.configs.base import (
    BLOCK_ATTN, BLOCK_MAMBA1, BLOCK_MAMBA2, BLOCK_SHARED_ATTN, SHAPES,
    BuildConfig, DatasetConfig, FilterConfig, GraphConfig, ModelConfig,
    ObsConfig, PlanConfig, PQConfig, ProximaConfig, SearchConfig,
    ShapeConfig, ShardConfig, StreamConfig, upgrade_config,
)

__all__ = [
    "ARCH_IDS", "BLOCK_ATTN", "BLOCK_MAMBA1", "BLOCK_MAMBA2",
    "BLOCK_SHARED_ATTN", "BuildConfig", "DatasetConfig", "FilterConfig",
    "GraphConfig", "ModelConfig", "ObsConfig", "PlanConfig", "PQConfig",
    "ProximaConfig", "SHAPES", "SearchConfig", "ShapeConfig", "ShardConfig",
    "StreamConfig", "get_config", "get_smoke_config", "shape_cells",
    "upgrade_config",
]

_MODULES: Dict[str, object] = {
    "mistral-nemo-12b": mistral_nemo_12b,
    "stablelm-1.6b": stablelm_1_6b,
    "granite-34b": granite_34b,
    "deepseek-67b": deepseek_67b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "mixtral-8x22b": mixtral_8x22b,
    "paligemma-3b": paligemma_3b,
    "zamba2-1.2b": zamba2_1_2b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "falcon-mamba-7b": falcon_mamba_7b,
}

ARCH_IDS: List[str] = list(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return _MODULES[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def shape_cells(arch_id: str):
    """The (shape, runnable, reason) cells for an arch — the long_500k cell
    runs only on a sub-quadratic architecture."""
    cfg = get_config(arch_id)
    cells = []
    for name, shp in SHAPES.items():
        if name == "long_500k" and not cfg.subquadratic:
            cells.append((shp, False,
                          "full quadratic attention; 500k decode skipped"))
        else:
            cells.append((shp, True, ""))
    return cells
