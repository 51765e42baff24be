"""Port of ``repro.serve``: the ``ServingEngine`` (batch-flush and
continuous; frozen or streaming targets) and, in ``serve.retrieval``, the
``EmbeddingRetriever``."""
from repro_torch.serve.engine import EngineStats, Request, ServingEngine

__all__ = ["EngineStats", "Request", "ServingEngine"]
