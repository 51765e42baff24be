"""The port's sharded serving (``train.loop.make_prefill_step`` /
``make_serve_step`` on a mesh) on a (2, 2) ("data", "model") gloo mesh of
4 rank processes against the one-rank serving path on the same weights.

Each case serves a batch in f32 from seeded weights and inputs: a prefill
(single-shot, or ``prefill_chunked`` in segments) and greedy decode steps
on the gathered logits.  The smoke configs on a "model" axis of 2 take
both cache layouts: kv heads split (stablelm, seamless, mistral, deepseek,
granite-moe, mixtral: 2-4 kv heads) and the positions split (granite-34b,
PaliGemma: 1 kv head; mixtral's ring with 1 kv head, single-shot and
chunked).  The batch-1 cases
put the positions over "data" (zamba2: heads over "model" too) or over
("data", "model") (granite-34b).

Three cases run in bf16, where a row-parallel product's partial sums are
added in f32 and cast once (``sharding.summed_product``): summed in bf16
their logits come 0.037-0.043 from one rank's, beyond the bf16 bar.

Bars: every step's gathered logits rtol 1e-5 (bf16: 1e-2), with a tenth of
that of the largest |logit| as the floor; the greedy tokens equal; the
gathered cache after the last step within the same bar of the one-rank
cache; each rank's cache leaves of the shape ``local_shape(global,
cache_shardings spec)``; ``shard_cache`` of the gathered cache gives back
each rank's leaves.
"""
import dataclasses
import json
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.distributed import sharding as shard_lib
from repro_torch.models.model import build_model
from repro_torch.train.loop import make_prefill_step, make_serve_step
from test_torch_sharded_train import run_ranks

KW = dict(q_chunk=64, ssm_chunk=8)
SIZES = {"data": 2, "model": 2}
STEPS = 3
BF16_RTOL = 1e-2


class Case(NamedTuple):
    arch: str
    over: dict = {}
    batch: int = 4
    prompt: int = 16
    seg_len: int = 0             # prefill_chunked's segment (0: single-shot)
    steps: int = STEPS
    max_len: int = 40


def _cases():
    out = {a: Case(a) for a in ARCH_IDS}
    for a in ("granite-moe-3b-a800m", "mixtral-8x22b", "zamba2-1.2b",
              "stablelm-1.6b"):
        out[f"{a}|chunked"] = Case(a, prompt=32, seg_len=16, max_len=40)
    out.update({
        # decoded past the 64-wide window: the ring's slots wrap
        "mixtral-8x22b|ring": Case("mixtral-8x22b", prompt=60, steps=8,
                                   max_len=72),
        "mixtral-8x22b|ring-mqa": Case("mixtral-8x22b",
                                       {"num_kv_heads": 1}, prompt=60,
                                       steps=8, max_len=72),
        # segments against a full 128-slot ring split over "model"
        "mixtral-8x22b|chunked-ring-mqa": Case(
            "mixtral-8x22b", {"num_kv_heads": 1}, prompt=128, seg_len=16,
            max_len=132),
        # batch 1: the positions over "data" (and "model")
        "zamba2-1.2b|batch1": Case("zamba2-1.2b", batch=1),
        "granite-34b|batch1": Case("granite-34b", batch=1),
    })
    # bf16: the row-parallel sums in f32, cast once (not zamba2: the
    # hybrid's bf16 is 0.145 from its own f32 in the reference, PERF.md)
    out.update({f"{a}|bf16": Case(a, {"dtype": "bfloat16"}) for a in (
        "stablelm-1.6b", "paligemma-3b", "falcon-mamba-7b")})
    return out


CASES = _cases()


def _model(case):
    cfg = dataclasses.replace(get_smoke_config(case.arch),
                              **dict({"dtype": "float32"}, **case.over))
    return build_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0), **KW)


def _batch(case, cfg):
    rng = np.random.default_rng(1)
    b, s = case.batch, case.prompt
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.family == "vlm":
        batch["frontend"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.frontend_dim), np.float32)
    if cfg.family == "encdec":
        batch["frontend"] = rng.standard_normal((b, s, cfg.frontend_dim),
                                                np.float32)
    return batch


def serve(case, model, params=None, mesh=None, gather=None):
    """(every step's logits, the greedy tokens, the last cache) of ``case``
    through the prefill and decode steps; ``gather`` makes a sharded step's
    logits whole."""
    gather = gather or (lambda x: x)
    prefill = make_prefill_step(model, mesh, seg_len=case.seg_len,
                                max_len=case.max_len)
    step = make_serve_step(model, mesh)
    lg, cache = prefill(params, _batch(case, model.config))
    logits, toks = [gather(lg)], []
    for _ in range(case.steps):
        toks.append(logits[-1].argmax(-1))
        lg, cache = step(params, cache, toks[-1])
        logits.append(gather(lg))
    return logits, torch.cat(toks, 1), cache


_RANK = r"""
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
import test_torch_sharded_serve as T
from repro_torch.distributed import sharding as shard_lib
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.loop import serve_params

rank, where = int(sys.argv[1]), sys.argv[2]
dist.init_process_group(
    "gloo", store=dist.FileStore(where + "/store", 4), rank=rank,
    world_size=4, timeout=datetime.timedelta(seconds=120))
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
out = {}
for name, case in T.CASES.items():
    model = T._model(case)
    params = serve_params(model, mesh)
    logits, toks, cache = T.serve(case, model, params, mesh,
                                  lambda x: shard_lib.full_tensor(x, mesh))
    out[name] = {f: list(getattr(cache, f).shape)
                 for f in cache._fields[:5] if getattr(cache, f) is not None}
    whole = shard_lib.gather_cache(cache, mesh)
    back = shard_lib.shard_cache(whole, mesh, model.config)
    out[name + "/roundtrip"] = all(
        torch.equal(a, b) and a._shard_spec == b._shard_spec
        for a, b in zip(cache[:5], back[:5]) if a is not None)
    if rank == 0:
        arrays = {f"logits{i}": x.float().numpy()
                  for i, x in enumerate(logits)}
        arrays["tokens"] = toks.numpy()
        arrays.update({f: getattr(whole, f).float().numpy()
                       for f in whole._fields[:5]
                       if getattr(whole, f) is not None})
        np.savez(where + "/" + name.replace("|", "_") + ".npz", **arrays)
with open(where + f"/out{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    where = tmp_path_factory.mktemp("sharded_serve")
    run_ranks(_RANK, where)
    return where, [json.loads((where / f"out{r}.json").read_text())
                   for r in range(4)]


@pytest.fixture(scope="module")
def one_rank():
    """name -> (logits, tokens, cache) of the one-rank serving path."""
    return {name: serve(case, _model(case)) for name, case in CASES.items()}


def _close(got, want, what, rtol):
    atol = rtol / 10 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_equals_one_rank(name, mesh_run, one_rank):
    where, outs = mesh_run
    logits, toks, cache = one_rank[name]
    rtol = BF16_RTOL if CASES[name].over.get("dtype") else 1e-5
    got = dict(np.load(where / (name.replace("|", "_") + ".npz")))
    for i, want in enumerate(logits):
        _close(got[f"logits{i}"], want.float().numpy(), f"{name} logits {i}",
               rtol)
    np.testing.assert_array_equal(got["tokens"], toks.numpy())
    for f in cache._fields[:5]:
        want = getattr(cache, f)
        if want is not None:
            _close(got[f], want.float().numpy(), f"{name} cache {f}", rtol)
    # each rank holds its share of the cache, as cache_shardings places it
    specs = shard_lib.cache_shardings(SIZES, cache, _model(CASES[name])
                                      .config)
    for out in outs:
        assert out[name + "/roundtrip"], name   # shard_cache(gather_cache)
        for f, shape in out[name].items():
            want = shard_lib.local_shape(getattr(cache, f).shape,
                                         getattr(specs, f).spec, SIZES)
            assert tuple(shape) == want, (name, f, shape, want)


def test_cases_cover_every_layout():
    """The cases put the cache's positions over "model", over "data" and
    over both, and its kv heads over "model"."""
    seen = set()
    for name, case in CASES.items():
        model = _model(case)
        cache = model.init_cache(case.batch, case.max_len)
        if cache.kv_k is None:
            continue
        spec = shard_lib.cache_shardings(SIZES, cache, model.config).kv_k.spec
        seen.add((spec[2], spec[3]))
    assert {(None, "model"), ("model", None), ("data", "model"),
            (("data", "model"), None)} <= seen, seen
