"""Port of ``repro.configs``: the Proxima configuration dataclasses."""
from repro_torch.configs.base import (
    BuildConfig, DatasetConfig, FilterConfig, GraphConfig, ObsConfig,
    PlanConfig, PQConfig, ProximaConfig, SearchConfig, ShardConfig,
    StreamConfig, upgrade_config,
)

__all__ = [
    "BuildConfig", "DatasetConfig", "FilterConfig", "GraphConfig",
    "ObsConfig", "PlanConfig", "PQConfig", "ProximaConfig", "SearchConfig",
    "ShardConfig", "StreamConfig", "upgrade_config",
]
