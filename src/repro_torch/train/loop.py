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
than one rank, the step shards the batch: each rank takes its rows of every
microbatch.  Two ways, as the reference's ``param_shardings`` says:

* without it the parameters are replicated and the step is data-parallel:
  the loss and the gradients are averaged with ``all_reduce`` over the
  batch axes' group.  This is the reference's GSPMD step's arithmetic when
  every rank's rows hold the same number of labels >= 0 (the step-seeded
  pipeline has no masked labels); the MoE load-balancing term is then each
  rank's own.
* with it (``state_shardings(...).params``) the step is sharded: the state
  holds each rank's shards (``shard_state``: DTensors placed by the
  resolved specs), and the model runs on the local shards inside
  ``sharding.activation_hints`` — FSDP of "embed" over "data" (weights
  all-gathered before use, gradients reduce-scattered back to the shard
  each microbatch and added into f32 shards, the reference's
  ``constrain_grads``) and tensor parallelism on "model" (models/layers.py).
  The loss is the global one (its sums run over the batch axes), gradients
  of weights replicated over a batch axis are all-reduced over it once per
  step, and AdamW updates the shards with the global norm: each rank's
  square-sums, each leaf's weighted by 1 / the ranks that hold the same
  shard, summed over the mesh's axes (``AdamW.apply``'s ``sq_norm``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
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
    info = shard_lib.mesh_info(mesh)
    groups, n, rank = [], 1, 0
    for a in shard_lib.batch_axes(mesh):
        size, local, group = info[a]
        n, rank = n * size, rank * size + local
        if size > 1:
            groups.append(group)
    return groups, n, rank


def shard_state(state: TrainState, specs, mesh) -> TrainState:
    """``state`` held as each rank's shards: parameters and both moments
    become DTensors placed by their resolved specs over ``mesh``, each
    rank's storage its share, copied out of the whole tensor (every rank
    passes the same whole state); a tensor no axis splits keeps its
    storage.  The step counter stays as it is."""
    from torch.distributed.tensor import DTensor

    sh = state_shardings(specs, state, mesh)

    def put(tensors, shardings):
        return {k: DTensor.from_local(
            shard_lib.local_shard(t, shardings[k].spec, mesh), mesh,
            shardings[k].placements(), run_check=False)
            for k, t in tensors.items()}

    return TrainState(params=put(state.params, sh.params), opt=AdamWState(
        step=state.opt.step, mu=put(state.opt.mu, sh.opt.mu),
        nu=put(state.opt.nu, sh.opt.nu)))


def local_shards(tensors: Dict[str, torch.Tensor]) -> Dict[str,
                                                          torch.Tensor]:
    """Each DTensor's local shard (its storage, not a copy); other tensors
    as they are."""
    from torch.distributed.tensor import DTensor

    return {k: t.to_local() if isinstance(t, DTensor) else t
            for k, t in tensors.items()}


def make_train_step(model: Model, optimizer: AdamW, mesh=None,
                    microbatches: int = 1, param_shardings=None):
    """Returns (train_step, the batch's spec).  ``mesh``: a ``DeviceMesh``
    or None (one device).  ``param_shardings``: the parameters'
    ``NamedSharding``s (``state_shardings(...).params``) for the sharded
    step, whose state holds the shards (``shard_state``, or each rank's
    local shards as plain tensors); None keeps the parameters replicated."""
    if param_shardings is not None:
        return _sharded_train_step(model, optimizer, mesh, microbatches,
                                   param_shardings)
    groups, n_ranks, rank = _batch_groups(mesh)
    bspec = shard_lib.batch_spec(mesh) if mesh is not None else None
    rows = _rows(microbatches, n_ranks, rank)

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


def _rows(microbatches: int, n_ranks: int, rank: int):
    def rows(x: torch.Tensor) -> torch.Tensor:
        """(mb, this rank's rows of each microbatch, ...)."""
        b = x.shape[0]
        if b % (microbatches * n_ranks):
            raise ValueError(f"batch {b} does not split into {microbatches} "
                             f"microbatches over {n_ranks} ranks")
        x = x.reshape(microbatches, n_ranks, b // (microbatches * n_ranks),
                      *x.shape[1:])
        return x[:, rank]

    return rows


def _sharded_train_step(model: Model, optimizer: AdamW, mesh, microbatches,
                        param_shardings):
    sizes = shard_lib.axis_sizes(mesh)
    specs = {k: sh.spec for k, sh in param_shardings.items()}
    _, n_ranks, rank = _batch_groups(mesh)
    rows = _rows(microbatches, n_ranks, rank)
    # the batch axes a weight is replicated over: its gradient is summed
    # over them after the microbatches (over "data" the reduce-scatter of
    # each use has summed it already)
    reduce_over = {k: [a for a in shard_lib.batch_axes(mesh)
                       if sizes[a] > 1 and a not in shard_lib.spec_axes(spec)]
                   for k, spec in specs.items()}
    norm_weights = {k: 1.0 / float(np.prod(
        [n for a, n in sizes.items() if a not in shard_lib.spec_axes(spec)]))
        for k, spec in specs.items()}
    groups = {a: shard_lib.mesh_info(mesh)[a][2] for a in sizes}
    mesh_groups = [a for a, n in sizes.items() if n > 1]

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        local = local_shards(state.params)
        leaves = {k: shard_lib.tag(t.detach().requires_grad_(), specs[k])
                  for k, t in local.items()}
        mbs = {k: rows(torch.as_tensor(v, device=model.device))
               for k, v in batch.items()}
        gsum = None
        lsum = 0.0
        with shard_lib.activation_hints(mesh):
            for j in range(microbatches):
                loss, _ = functional_call(
                    model, leaves, ({k: v[j] for k, v in mbs.items()},))
                g = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True,
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
        grads = dict(zip(leaves, gsum))
        for k, axes in reduce_over.items():
            for a in axes:
                dist.all_reduce(grads[k], group=groups[a])
        if microbatches > 1:
            grads = {k: a.div_(microbatches) for k, a in grads.items()}
            lsum = lsum / microbatches
        opt = AdamWState(step=state.opt.step, mu=local_shards(state.opt.mu),
                         nu=local_shards(state.opt.nu))
        # the whole gradient's squared norm: each entry counted once
        sq = sum(torch.sum(torch.square(g.float())) * norm_weights[k]
                 for k, g in grads.items())
        for a in mesh_groups:
            dist.all_reduce(sq, group=groups[a])
        _, new_opt, om = optimizer.apply(grads, opt, local, sq_norm=sq)
        return TrainState(params=state.params, opt=AdamWState(
            step=new_opt.step, mu=state.opt.mu, nu=state.opt.nu)), {
            "loss": lsum, **om}

    return train_step, shard_lib.batch_spec(mesh)


def serve_params(model: Model, mesh) -> Dict[str, torch.Tensor]:
    """The model's weights as this rank's shards for the sharded serving
    steps: each placed by ``param_shardings`` over ``mesh`` (a copy of its
    block; a weight no axis splits is the model's own storage) and tagged
    with its resolved spec."""
    params = dict(model.named_parameters())
    sh = shard_lib.param_shardings(model.specs, params, mesh)
    return {k: shard_lib.tag(shard_lib.local_shard(p, sh[k].spec, mesh),
                             sh[k].spec) for k, p in params.items()}


def _serving(model: Model, mesh):
    """``run(params, method, args, b)``: the model's serving ``method`` on
    ``params`` (None: its own weights), its arguments ``args(take)``.  With
    a mesh it runs inside ``activation_hints`` on this rank's rows of a
    global batch of ``b``, which ``take`` cuts from a tensor: the batch
    splits where the batch axes divide it, as ``cache_shardings`` splits the
    cache, and is whole on every rank otherwise.  The logits come back
    tagged with their spec (batch, None, vocabulary), for
    ``sharding.full_tensor``."""
    def call(params, method, *args):
        if params is None:
            return getattr(model, method)(*args)
        return functional_call(model, params, args, {"method": method})

    if mesh is None:
        return lambda params, method, args, b: call(params, method,
                                                    *args(lambda x: x))
    _, n_ranks, rank = _batch_groups(mesh)
    rows = _rows(1, n_ranks, rank)
    vocab = model.config.vocab_size

    def run(params, method, args, b):
        split = b % n_ranks == 0
        with shard_lib.activation_hints(mesh, batch_split=split):
            take = (lambda x: rows(x)[0]) if split else (lambda x: x)
            logits, cache = call(params, method, *args(take))
            spec = (shard_lib.batch_entry(), None,
                    "model" if logits.shape[-1] != vocab else None)
        return shard_lib.tag(logits, spec), cache

    return run


def make_serve_step(model: Model, mesh=None, seq_shard: bool = False):
    """The decode step ``(params, cache, tokens) -> (logits, cache)``, the
    reference's signature: ``params`` a state dict of the model (None: the
    model's own weights), ``tokens`` (B, 1) and ``cache`` a ``DecodeCache``
    from ``make_prefill_step``'s (or ``Model.prefill``'s) step.  On a mesh
    (a ``DeviceMesh`` over ("data", "model") or ("pod", "data", "model"))
    ``params`` are this rank's shards (``serve_params``), ``cache`` holds
    this rank's leaves and stays on it, every rank passes the same global
    ``tokens``, and the logits are this rank's rows and vocabulary block
    (the reference's ``out_shardings``; ``sharding.full_tensor`` gathers
    them).  ``seq_shard`` is the reference's, which its cache placement
    ignores too."""
    run = _serving(model, mesh)

    def serve_step(params, cache, tokens):
        tokens = torch.as_tensor(tokens, device=model.device)
        return run(params, "decode_step",
                   lambda take: (cache, take(tokens)), tokens.shape[0])

    return serve_step


def make_prefill_step(model: Model, mesh=None, seg_len: int = 0,
                      max_len=None):
    """The prefill step ``(params, batch) -> (logits, cache)`` beside
    ``make_serve_step``, with its arguments: ``Model.prefill`` with room
    for ``max_len`` positions, or ``prefill_chunked`` in segments of
    ``seg_len`` when it is set.  On a mesh every rank passes the same global
    ``batch`` and gets this rank's cache leaves and logits."""
    run = _serving(model, mesh)

    method, extra = (("prefill_chunked", (seg_len, max_len)) if seg_len
                     else ("prefill", (max_len,)))

    def prefill_step(params, batch):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        return run(params, method,
                   lambda take: ({k: take(v) for k, v in batch.items()},
                                 *extra), batch["tokens"].shape[0])

    return prefill_step

