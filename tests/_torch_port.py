"""Shared helpers of the port's tests: carry a reference index across."""
import dataclasses

from repro_torch.core.index import index_from_arrays


def port_index(ref_index, device="cpu"):
    """The port's ProximaIndex over the arrays of a reference index."""
    idx = ref_index
    return index_from_arrays(
        adjacency=idx.graph.adjacency, degrees=idx.graph.degrees,
        entry_point=idx.graph.entry_point, codes=idx.codes,
        base=idx.dataset.base, queries=idx.dataset.queries,
        gt=idx.dataset.gt, metric=idx.dataset.metric,
        centroids=idx.codebook.centroids, hot_count=idx.hot_count,
        config=dataclasses.asdict(idx.config), device=device,
    )
