"""Port of ``repro.serve``: the batch-flush ``ServingEngine``."""
from repro_torch.serve.engine import EngineStats, Request, ServingEngine

__all__ = ["EngineStats", "Request", "ServingEngine"]
