"""Port of ``repro.filter``: the attribute store, ``FilterSpec`` predicates
and the selectivity-adaptive filtered search kernels (masked traversal and
the bitmap PQ scan), and ``tile_node_masks``, the shard layer's per-tile
mask slices."""
from repro_torch.filter.attributes import (
    AttributeStore, bitmap_popcount, encode_categorical, pack_bitmap,
    random_attributes, unpack_bitmap,
)
from repro_torch.filter.spec import ALL, Eq, FilterSpec, In, Range
from repro_torch.filter.traversal import (
    FilteredSearchResult, adapt_search_cfg, scan_search, tile_node_masks,
)


def attach_attributes(index, store: AttributeStore) -> AttributeStore:
    """Attach a per-node attribute store to a built ``ProximaIndex``; rows
    are keyed by the index's internal ids.  Returns the store."""
    if len(store) != index.dataset.num_base:
        raise ValueError(
            f"attribute store has {len(store)} rows, index has "
            f"{index.dataset.num_base} vertices"
        )
    index.attributes = store
    return store


__all__ = [
    "ALL", "AttributeStore", "Eq", "FilterSpec", "FilteredSearchResult",
    "In", "Range", "adapt_search_cfg", "attach_attributes",
    "bitmap_popcount", "encode_categorical", "pack_bitmap",
    "random_attributes", "scan_search", "tile_node_masks", "unpack_bitmap",
]
