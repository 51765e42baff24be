"""Port of ``repro.core``: Algorithm 1 and the single-segment index build."""
from repro_torch.core.dataset import (
    Dataset, exact_knn, make_dataset, recall_at_k, recall_hits_per_query,
)
from repro_torch.core.index import (
    ProximaIndex, build_index, index_from_arrays,
)
from repro_torch.core.search import (
    Corpus, SearchResult, SearchState, finalize_search, graph_search,
    graph_search_step, graph_search_stepped, init_search_state,
    search_state_active,
)

__all__ = [
    "Corpus", "Dataset", "ProximaIndex", "SearchResult", "SearchState",
    "build_index", "exact_knn", "finalize_search", "graph_search",
    "graph_search_step", "graph_search_stepped", "index_from_arrays",
    "init_search_state", "make_dataset", "recall_at_k",
    "recall_hits_per_query", "search_state_active",
]
