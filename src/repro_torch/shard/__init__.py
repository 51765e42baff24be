"""Port of ``repro.shard``: multi-channel corpus sharding — the paper's data
allocation scheme (§IV-E/§V).  The corpus is partitioned into P tiles (one
per NAND channel group), each tile with its own proximity graph and entry
point, hot nodes and PQ centroids replicated on every tile; a query fans out
to every tile before a cross-tile top-k merge on the bitonic kernel."""
from repro_torch.shard.partition import (
    TiledCorpus, TilePartition, assign_cold, partition_index,
    tiled_from_arrays, tiles_from_segments,
)
from repro_torch.shard.search import (
    ShardedSearchResult, cross_tile_merge, route_queries, sharded_search,
    sharded_search_kernel,
)

__all__ = [
    "ShardedSearchResult", "TiledCorpus", "TilePartition", "assign_cold",
    "cross_tile_merge", "partition_index", "route_queries", "sharded_search",
    "sharded_search_kernel", "tiled_from_arrays", "tiles_from_segments",
]
