"""Port of ``repro.core``: Algorithm 1, its reference oracle, the index
build (single-segment and segmented, with hot-node reordering and gap
encoding) and the distributed search over a device mesh."""
from repro_torch.core.dataset import (
    ArraySegmentSource, Dataset, SyntheticSegmentSource, exact_knn,
    make_dataset, recall_at_k, recall_hits_per_query,
)
from repro_torch.core.distributed import (
    ShardedCorpus, distributed_search, distributed_search_kernel,
    shard_corpus,
)
from repro_torch.core.index import (
    ProximaIndex, build_index, build_index_monolithic, index_from_arrays,
)
from repro_torch.core.search import (
    Corpus, SearchResult, SearchState, finalize_search, graph_search,
    graph_search_step, graph_search_stepped, init_search_state,
    search_reference, search_state_active,
)
from repro_torch.core.segmented import (
    IndexSegment, SegmentedIndex, build_segmented,
)

__all__ = [
    "ArraySegmentSource", "Corpus", "Dataset", "IndexSegment", "ProximaIndex",
    "SearchResult", "SearchState", "SegmentedIndex", "ShardedCorpus",
    "SyntheticSegmentSource", "build_index", "build_index_monolithic",
    "build_segmented", "distributed_search", "distributed_search_kernel",
    "exact_knn", "finalize_search", "graph_search", "graph_search_step",
    "graph_search_stepped", "index_from_arrays", "init_search_state",
    "make_dataset", "recall_at_k", "recall_hits_per_query",
    "search_reference", "search_state_active", "shard_corpus",
]
