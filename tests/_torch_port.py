"""Shared helpers of the port's tests: carry a reference index (and a
reference tiled corpus) across."""
import dataclasses

import numpy as np

from repro_torch.core.index import index_from_arrays
from repro_torch.shard import tiled_from_arrays


def port_index(ref_index, device="cpu"):
    """The port's ProximaIndex over copies of a reference index's arrays,
    its reordering included."""
    idx = ref_index
    reord = idx.reordering
    return index_from_arrays(
        adjacency=idx.graph.adjacency, degrees=idx.graph.degrees,
        entry_point=idx.graph.entry_point, codes=idx.codes,
        base=idx.dataset.base, queries=idx.dataset.queries,
        gt=idx.dataset.gt, metric=idx.dataset.metric,
        centroids=idx.codebook.centroids,
        perm=None if reord is None else reord.perm,
        inv=None if reord is None else reord.inv,
        hot_count=idx.hot_count,
        config=dataclasses.asdict(idx.config), device=device,
    )


def port_tiled(ref_tiled, ref_partition=None, device="cpu"):
    """The port's (TiledCorpus, TilePartition) over copies of a reference
    TiledCorpus's arrays (and its TilePartition's fields)."""
    return tiled_from_arrays(
        **{f: np.asarray(getattr(ref_tiled, f)) for f in ref_tiled._fields},
        partition=None if ref_partition is None
        else dataclasses.asdict(ref_partition),
        device=device)
