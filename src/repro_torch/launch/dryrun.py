"""Multi-pod dry-run — twin of ``src/repro/launch/dryrun.py``: traces each
(architecture x input shape) cell's sharded step on the production meshes
and records memory, dot FLOPs, collective bytes and the roofline terms,
per device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --mesh both --out results/dryrun_torch.json

The reference lowers and compiles each cell with XLA over 512 forced host
devices.  The port has no compiler to ask, so it runs the step itself,
once, as one rank of the mesh would: a fake process group of
``prod(mesh)`` ranks (``torch.testing._internal.distributed.fake_pg``: its
collectives return at once) carries a ``DeviceMesh`` of the production
shape; the model is built at full width under ``FakeTensorMode`` (shapes
and dtypes, no storage), its state placed by ``state_shardings`` as this
rank's local shards, and ``train.loop``'s sharded step runs on them with
``roofline.trace_count`` watching (per-device dot FLOPs, collective bytes
and the peak of the bytes the step holds besides its state and batch).  The record has the
reference's keys, ``trace_s`` for ``lower_s`` and no ``compile_s``.

Prefill and decode cells run the sharded serving steps the same way
(``train.loop.make_prefill_step`` / ``make_serve_step`` on the weights'
local shards): a prefill cell prefills ``seq_len`` tokens into a cache of
``seq_len + 8`` positions (``prefill_chunked`` in segments of
``CHUNKED_PREFILL_SEG`` for ``CHUNKED_PREFILL``); a decode cell takes one
step against a cache of ``seq_len`` positions from ``init_cache`` (this
rank's leaves, placed by ``cache_shardings``), filled to ``seq_len - 1``
so the step writes the last slot and attends every position (the
reference's length is an abstract scalar), plus an encoder output for
encdec.  ``kv_bytes_local``, the decode cache's bytes over the chips,
feeds the memory term.  A process holds one default process group, so the
module sets up its own (one per mesh) and runs as its own process.
"""
import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shard_lib
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import build_model, input_specs
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline.trace_count import LiveBytes, TraceCount
from repro_torch.train.loop import (
    TrainState, init_train_state, make_prefill_step, make_serve_step,
    make_train_step, state_shardings,
)
from repro_torch.train.optimizer import AdamW, AdamWState

# train cells whose saved-activation stacks exceed HBM without
# sequence-parallel residual sharding (the reference's table)
SEQ_PARALLEL_TRAIN = {
    "mistral-nemo-12b", "granite-34b", "deepseek-67b", "mixtral-8x22b",
    "falcon-mamba-7b", "zamba2-1.2b",
}

# per-arch MoE dispatch-buffer layout (the reference's table): few-expert
# models prefer the data-sharded dispatch buffer
MOE_DISPATCH_HINT = {"mixtral-8x22b": True, "granite-moe-3b-a800m": False}

# prefill cells whose single-shot buffers exceed HBM: segmented prefill
# (the reference's table); vlm / encdec keep the single-shot path
CHUNKED_PREFILL = {
    "granite-moe-3b-a800m", "mixtral-8x22b", "zamba2-1.2b",
}
CHUNKED_PREFILL_SEG = 4096

PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _cell_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Per-device microbatch of ~1 sequence for train cells (memory-safe
    default at 4k seq)."""
    sizes = shard_lib.axis_sizes(mesh)
    bsz = int(np.prod([sizes[a] for a in shard_lib.batch_axes(mesh)]))
    if shape.kind != "train":
        return 1
    return max(shape.global_batch // bsz, 1)


@contextlib.contextmanager
def fake_mesh(shape, axes):
    """A fake default process group of ``prod(shape)`` ranks (this process
    is rank 0) and its CPU ``DeviceMesh``; the group is destroyed on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        yield make_mesh(shape, axes, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def lower_cell(
    arch: str,
    shape: ShapeConfig,
    mesh,
    model_kw: Optional[Dict[str, Any]] = None,
    microbatches: Optional[int] = None,
    cfg: Optional[ModelConfig] = None,
) -> Dict[str, Any]:
    """Traces one cell on ``mesh`` (a ``DeviceMesh`` over a fake process
    group, ``fake_mesh``); returns the result record.  ``cfg`` replaces
    ``get_config(arch)`` (a cut-down config)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg or get_config(arch)
    sizes = shard_lib.axis_sizes(mesh)
    chips = int(np.prod(list(sizes.values())))
    base = {"arch": arch, "shape": shape.name,
            "mesh": "x".join(str(s) for s in sizes.values()),
            "chips": chips}
    model_kw = dict(model_kw or {})
    if shape.kind == "train" and arch in SEQ_PARALLEL_TRAIN:
        model_kw.setdefault("seq_parallel", True)
    if arch in MOE_DISPATCH_HINT:
        model_kw.setdefault("moe_dispatch_hint", MOE_DISPATCH_HINT[arch])
    if shape.kind != "train":
        return _serve_cell(arch, shape, mesh, model_kw, cfg, base)
    mb = microbatches or _cell_microbatches(cfg, shape, mesh)
    t0 = time.time()
    with FakeTensorMode():
        model = build_model(cfg, device="cpu", **model_kw)
        optimizer = AdamW()
        full, specs = init_train_state(model, optimizer)
        sh = state_shardings(specs, full, mesh).params

        def local(dtype=None):
            return {k: torch.empty(
                shard_lib.local_shape(p.shape, sh[k].spec, sizes),
                dtype=dtype or p.dtype) for k, p in full.params.items()}

        state = TrainState(params=local(), opt=AdamWState(
            step=torch.zeros((), dtype=torch.int32),
            mu=local(torch.float32), nu=local(torch.float32)))
        del full
        batch = {k: torch.empty(v.shape, dtype=v.dtype)
                 for k, v in input_specs(cfg, shape).items()}
        step, _ = make_train_step(model, optimizer, mesh, mb,
                                  param_shardings=sh)
        counts, mem = TraceCount(), LiveBytes()
        mem.exclude([*state.params.values(), *state.opt.mu.values(),
                     *state.opt.nu.values(), state.opt.step,
                     *batch.values()])
        with mem, counts:
            step(state, batch)
    trace_s = time.time() - t0
    state_bytes = _nbytes([*state.params.values(), *state.opt.mu.values(),
                           *state.opt.nu.values(), state.opt.step])
    bsize = int(np.prod([sizes[a] for a in shard_lib.batch_axes(mesh)]))
    batch_bytes = _nbytes(batch.values()) // bsize
    temp = mem.peak
    mem_rec = {"argument_size_in_bytes": state_bytes + batch_bytes,
               "output_size_in_bytes": state_bytes,
               "temp_size_in_bytes": temp,
               "peak_memory_in_bytes": state_bytes + batch_bytes + temp}
    tokens = shape.global_batch * shape.seq_len
    model_flops = roofline.train_model_flops(cfg.active_param_count(),
                                             tokens)
    hbm = roofline.analytic_hbm_bytes(cfg, shape, mesh, microbatches=mb)
    rl = roofline.analyze(counts, chips=chips, model_flops=model_flops,
                          hbm_bytes_per_device=hbm)
    return dict(base, status="ok", trace_s=round(trace_s, 1),
                microbatches=mb, model_kw=model_kw, memory=mem_rec,
                roofline=rl.to_dict(), coll_calls=counts.coll_calls,
                param_count=cfg.param_count(),
                active_param_count=cfg.active_param_count(),
                dtype=str(torch_dtype(cfg.dtype)))


def _whole_bytes(t: torch.Tensor, sizes) -> int:
    """The bytes of the whole tensor of a rank's tagged shard."""
    n = int(np.prod([sizes[a] for e in t._shard_spec
                     for a in shard_lib.entry_axes(e)]))
    return t.numel() * t.element_size() * n


def _serve_cell(arch, shape, mesh, model_kw, cfg, base) -> Dict[str, Any]:
    """A prefill or decode cell (``lower_cell``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    sizes = shard_lib.axis_sizes(mesh)
    chips = base["chips"]
    b = shape.global_batch
    bsize = int(np.prod([sizes[a] for a in shard_lib.batch_axes(mesh)]))
    kv_bytes_local = 0.0
    t0 = time.time()
    with FakeTensorMode():
        model = build_model(cfg, device="cpu", **model_kw)
        full = dict(model.named_parameters())
        sh = shard_lib.param_shardings(model.specs, full, mesh)
        params = {k: shard_lib.tag(torch.empty(
            shard_lib.local_shape(p.shape, sh[k].spec, sizes),
            dtype=p.dtype), sh[k].spec) for k, p in full.items()}
        del full
        batch = {k: torch.empty(v.shape, dtype=v.dtype)
                 for k, v in input_specs(cfg, shape).items()}
        if shape.kind == "prefill":
            seg = CHUNKED_PREFILL_SEG if arch in CHUNKED_PREFILL else 0
            step = make_prefill_step(model, mesh, seg_len=seg,
                                     max_len=shape.seq_len + 8)
            args = (params, batch)
            held = []
        else:
            with shard_lib.activation_hints(mesh,
                                            batch_split=b % bsize == 0):
                cache = model.init_cache(b, shape.seq_len)
                if cfg.family == "encdec":
                    spec = (shard_lib.batch_entry(), None, None)
                    cache = cache._replace(enc_out=shard_lib.tag(
                        torch.empty(shard_lib.local_shape(
                            (b, shape.seq_len, cfg.d_model), spec, sizes),
                            dtype=torch_dtype(cfg.dtype)), spec))
            cache = cache._replace(length=shape.seq_len - 1)
            held = [t for t in cache[:5] if t is not None]
            kv_bytes_local = float(sum(
                _whole_bytes(t, sizes) for t in held)) / chips
            step = make_serve_step(model, mesh)
            args = (params, cache, batch["tokens"])
        counts, mem = TraceCount(), LiveBytes()
        mem.exclude([*params.values(), *held, *batch.values()])
        with mem, counts:
            logits, out_cache = step(*args)
    trace_s = time.time() - t0
    param_bytes = _nbytes(params.values())
    batch_bytes = _nbytes(batch.values()) // (bsize if b % bsize == 0
                                              else 1)
    cache_bytes = _nbytes([t for t in out_cache[:5] if t is not None])
    arg = param_bytes + batch_bytes + _nbytes(held)
    mem_rec = {"argument_size_in_bytes": arg,
               "output_size_in_bytes": _nbytes([logits]) + cache_bytes,
               "temp_size_in_bytes": mem.peak,
               "peak_memory_in_bytes": arg + mem.peak}
    tokens = b * (shape.seq_len if shape.kind == "prefill" else 1)
    model_flops = roofline.decode_model_flops(cfg.active_param_count(),
                                              tokens)
    hbm = roofline.analytic_hbm_bytes(cfg, shape, mesh,
                                      kv_cache_bytes=kv_bytes_local)
    rl = roofline.analyze(counts, chips=chips, model_flops=model_flops,
                          hbm_bytes_per_device=hbm)
    return dict(base, status="ok", trace_s=round(trace_s, 1),
                microbatches=1, model_kw=model_kw, memory=mem_rec,
                roofline=rl.to_dict(), coll_calls=counts.coll_calls,
                kv_bytes_local=kv_bytes_local,
                cache_bytes_local=cache_bytes,
                param_count=cfg.param_count(),
                active_param_count=cfg.active_param_count(),
                dtype=str(torch_dtype(cfg.dtype)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results: Dict[str, Any] = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)

    for multi in meshes:
        mesh_shape, axes = PRODUCTION_MESHES[multi]
        mesh_name = "x".join(str(s) for s in mesh_shape)
        with fake_mesh(mesh_shape, axes) as mesh:
            for arch in archs:
                cfg = get_config(arch)
                for shape_name in shapes:
                    shape = SHAPES[shape_name]
                    key = f"{arch}|{shape_name}|{mesh_name}"
                    if key in results and results[key].get(
                            "status") == "ok":
                        print(f"[skip] {key}")
                        continue
                    if shape_name == "long_500k" and not cfg.subquadratic:
                        results[key] = {
                            "arch": arch, "shape": shape_name,
                            "mesh": mesh_name, "status": "skipped",
                            "reason": "full quadratic attention at 500k",
                        }
                        _write(args.out, results)
                        print(f"[skipped-by-design] {key}")
                        continue
                    print(f"[trace] {key} ...", flush=True)
                    try:
                        rec = lower_cell(arch, shape, mesh)
                        results[key] = rec
                        if rec["status"] == "ok":
                            rl = rec["roofline"]
                            print(
                                f"  ok  trace={rec['trace_s']}s "
                                f"flops={rl['flops']:.3e} "
                                f"coll={rl['coll_bytes']:.3e} "
                                f"peak={rec['memory']['peak_memory_in_bytes']:.3e} "
                                f"bottleneck={rl['bottleneck']}", flush=True)
                        else:
                            print(f"  {rec['status']}", flush=True)
                    except Exception as e:
                        results[key] = {
                            "arch": arch, "shape": shape_name,
                            "mesh": mesh_name, "status": "error",
                            "error": f"{type(e).__name__}: {e}",
                            "trace": traceback.format_exc()[-2000:],
                        }
                        print(f"  ERROR {type(e).__name__}: {str(e)[:300]}",
                              flush=True)
                    _write(args.out, results)


def _write(path: str, results) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1)
    os.replace(tmp, path)


if __name__ == "__main__":
    main()
