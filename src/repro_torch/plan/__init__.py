"""Port of ``repro.plan``: the ``Searcher`` facade, its ``QueryPlanner`` and
the round-stepped ``RoundSession``, for flat plans (strategies none, masked,
scan and empty), tiled, merged and distributed plans."""
from repro_torch.configs.base import PlanConfig
from repro_torch.plan.planner import (
    Execution, IndexCapabilities, QueryPlan, QueryPlanner,
)
from repro_torch.plan.request import SearchRequest, SearchResult, SearchStats
from repro_torch.plan.rounds import RoundSession
from repro_torch.plan.searcher import Searcher, validate_attribute_store

__all__ = [
    "Execution", "IndexCapabilities", "PlanConfig", "QueryPlan",
    "QueryPlanner", "RoundSession", "SearchRequest", "SearchResult",
    "SearchStats", "Searcher", "validate_attribute_store",
]
