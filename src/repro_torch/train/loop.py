"""The train step — port of ``src/repro/train/loop.py`` (lines 1-131).

``make_train_step`` builds ``(state, batch) -> (state, metrics)`` with
metrics ``loss``, ``grad_norm`` and ``lr`` (device scalars).  The loss is
the model's, taken on ``state.params`` through
``torch.func.functional_call``, so the step is a function of the state
(a restored checkpoint's tensors train as the live ones do); remat is the
model's, per block.  With ``microbatches`` > 1 the batch is split into
contiguous rows (``x.reshape(mb, b // mb, ...)``), each microbatch's
gradients (``torch.autograd.grad``, in the parameters' dtype) are added into
f32 accumulators and averaged, as the reference's ``lax.scan`` does; with
one, the gradients go to the optimizer in the parameters' dtype, as the
reference's do.  The update is in place: the returned state holds the same
tensors.

On a mesh whose batch axes (``("pod", "data")`` or ``("data",)``) hold more
than one rank, the step is data-parallel with replicated parameters: each
rank takes its rows of every microbatch, and the loss and the gradients are
averaged with ``all_reduce`` over the batch axes' group.  This is the
reference's GSPMD step's arithmetic when every rank's rows hold the same
number of labels >= 0 (the step-seeded pipeline has no masked labels); the
MoE load-balancing term is then each rank's own.  Sharded execution (FSDP of
``embed`` over ``data``, tensor parallelism on ``model``) is not ported:
``distributed.sharding`` resolves the specs; nothing shards the step yet.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist
from torch.func import functional_call

from repro_torch.distributed import sharding as shard_lib
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamW, AdamWState


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt: AdamWState


def init_train_state(model: Model, optimizer: AdamW) -> Tuple[TrainState,
                                                               Dict]:
    """(the state over the model's own parameters, which get
    ``requires_grad``; its logical specs).  The model drew its weights when
    it was built (the reference's ``model.init(rng)``)."""
    params = {k: p.requires_grad_() for k, p in model.named_parameters()}
    return TrainState(params=params, opt=optimizer.init(params)), model.specs


def state_shardings(specs, state: TrainState, mesh) -> TrainState:
    """``NamedSharding``s of a TrainState (moments mirror params)."""
    p_sh = shard_lib.param_shardings(specs, state.params, mesh)
    return TrainState(params=p_sh, opt=AdamWState(
        step=shard_lib.NamedSharding(mesh, ()), mu=dict(p_sh),
        nu=dict(p_sh)))


def _batch_groups(mesh) -> Tuple[list, int, int]:
    """(the process groups of the mesh's batch axes that hold more than one
    rank, the ranks on the batch axes, this rank's index among them,
    major to minor); ([], 1, 0) without a mesh."""
    if mesh is None:
        return [], 1, 0
    sizes = shard_lib.axis_sizes(mesh)
    groups, n, rank = [], 1, 0
    for a in shard_lib.batch_axes(mesh):
        n, rank = n * sizes[a], rank * sizes[a] + mesh.get_local_rank(a)
        if sizes[a] > 1:
            groups.append(mesh.get_group(a))
    return groups, n, rank


def make_train_step(model: Model, optimizer: AdamW, mesh=None,
                    microbatches: int = 1):
    """Returns (train_step, the batch's spec).  ``mesh``: a ``DeviceMesh``
    or None (one device)."""
    groups, n_ranks, rank = _batch_groups(mesh)
    bspec = shard_lib.batch_spec(mesh) if mesh is not None else None

    def rows(x: torch.Tensor) -> torch.Tensor:
        """(mb, this rank's rows of each microbatch, ...)."""
        b = x.shape[0]
        if b % (microbatches * n_ranks):
            raise ValueError(f"batch {b} does not split into {microbatches} "
                             f"microbatches over {n_ranks} ranks")
        x = x.reshape(microbatches, n_ranks, b // (microbatches * n_ranks),
                      *x.shape[1:])
        return x[:, rank]

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = state.params
        for p in params.values():
            if not p.requires_grad:
                p.requires_grad_()
        leaves = list(params.values())
        mbs = {k: rows(torch.as_tensor(v, device=model.device))
               for k, v in batch.items()}
        gsum = None
        lsum = 0.0
        for j in range(microbatches):
            loss, _ = functional_call(model, params,
                                      ({k: v[j] for k, v in mbs.items()},))
            g = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
            loss = loss.detach()
            if microbatches == 1:
                gsum, lsum = list(g), loss
                break
            if gsum is None:
                gsum = [gi.float() for gi in g]
            else:
                for a, gi in zip(gsum, g):
                    a.add_(gi)
            lsum = lsum + loss
            del g
        if microbatches > 1:
            gsum = [a.div_(microbatches) for a in gsum]
            lsum = lsum / microbatches
        if groups:
            # a sum over each batch axis in turn is the sum over all of them
            gsum = [a.float() for a in gsum]
            for t in (*gsum, lsum):
                for group in groups:
                    dist.all_reduce(t, group=group)
            gsum = [a.div_(n_ranks) for a in gsum]
            lsum = lsum / n_ranks
        grads = dict(zip(params, gsum))
        new_params, new_opt, om = optimizer.apply(grads, state.opt, params)
        return TrainState(params=new_params, opt=new_opt), {"loss": lsum,
                                                            **om}

    return train_step, bspec


def make_serve_step(model: Model, mesh=None, seq_shard: bool = False):
    """A decode-step closure ``(cache, tokens) -> (logits, cache)`` (the
    reference's takes the params too; here the model holds them)."""

    def serve_step(cache, tokens):
        return model.decode_step(cache, tokens)

    return serve_step
