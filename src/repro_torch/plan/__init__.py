"""Port of ``repro.plan``: the ``Searcher`` facade and its ``QueryPlanner``,
flat unfiltered plans only."""
from repro_torch.configs.base import PlanConfig
from repro_torch.plan.planner import (
    Execution, IndexCapabilities, QueryPlan, QueryPlanner,
)
from repro_torch.plan.request import SearchRequest, SearchResult, SearchStats
from repro_torch.plan.searcher import Searcher

__all__ = [
    "Execution", "IndexCapabilities", "PlanConfig", "QueryPlan",
    "QueryPlanner", "SearchRequest", "SearchResult", "SearchStats",
    "Searcher",
]
