"""Shared helpers of the port's tests: carry a reference index (a
reference tiled corpus, a sharded corpus, a model's weights) across, and a
one-rank process group for the distributed path."""
import contextlib
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


@contextlib.contextmanager
def gloo_world_of_one(directory):
    """A one-rank gloo process group on a FileStore in ``directory`` and
    its 1x1 ("data", "model") CPU mesh; the group is destroyed on exit, so
    no other test in the process sees it (the default group is global)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group(
        "gloo", store=dist.FileStore(str(directory / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
    finally:
        dist.destroy_process_group()


def port_sharded(ref_index, shard=None, base=None):
    """The port's one-shard ShardedCorpus over a reference index's arrays
    (its base, or ``base``)."""
    from repro_torch.core.distributed import shard_corpus

    idx = ref_index
    return shard_corpus(
        idx.graph.adjacency, idx.codes,
        idx.dataset.base if base is None else base, idx.codebook.centroids,
        int(idx.graph.entry_point), idx.hot_count, 1, shard=shard,
        device="cpu")


def port_model(cfg, ref_params, device="cpu", **kw):
    """The port's Model of ``cfg`` holding the reference's ``model.init``
    weights (a pytree of numpy or jax arrays), carried across by
    ``params_from_reference``; ``kw`` are the Model's fields."""
    from repro_torch.models.model import build_model, params_from_reference

    model = build_model(cfg, device=device, **kw)
    model.load_state_dict(params_from_reference(cfg, ref_params))
    return model
