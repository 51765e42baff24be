"""The port's training half (``repro_torch.train``, the trainable
``models.model``) against the JAX reference on the CPU: the step-seeded
data bit for bit; AdamW's schedule and update on the same gradients; the
gradients of all ten architectures against ``jax.grad``; remat bit-neutral;
the twins of ``tests/test_train_ckpt_fault.py``'s loop tests; a 5-step loss
trajectory against the reference's train step; a 2-rank gloo mesh's
data-parallel step against the one-rank step.

Bars:
* the schedule rtol 1e-6; ``apply``'s f32 leaves rtol 1e-6 with atol 1e-6
  of the leaf's largest value (an entry the update takes near zero keeps
  its operands' rounding), bf16 leaves within one bf16 ulp; the global norm
  rtol 1e-5 (an f32 sum of ~10^5 squares in each library's reduction
  order) and, once it clips, 3x its relative difference more on the f32
  leaves and moments, which the clip scale carries;
* gradients rtol 1e-4 and atol 1e-4 of each leaf's largest |g| (the SSM
  and hybrid families 1e-3: the port's step-by-step scan against the
  reference's associative one); remat bit for bit;
* the trajectory's losses rtol 1e-3, its parameters within 2 x the summed
  learning rates + one bf16 ulp, at most 5% of entries beyond one ulp
  (Adam's early updates are ~sign(g) x lr, so an entry whose gradient is
  near zero can move the other way; PERF.md);
* the 2-rank step's metrics rtol 1e-5 and parameters within 2 x lr (one
  Adam step), under 1% of entries beyond 1e-6.
"""
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import port_model
from repro.configs import ARCH_IDS, get_smoke_config
from repro.configs.base import BLOCK_MAMBA2
from repro.launch.mesh import make_mesh as ref_mesh
from repro.models.model import build_model as ref_build
from repro.train import data as ref_data
from repro.train.loop import init_train_state as ref_init_state
from repro.train.loop import make_train_step as ref_make_step
from repro.train.optimizer import AdamW as RefAdamW
from repro_torch.models import model as model_mod
from repro_torch.models.model import (
    build_model, params_from_reference, stack_layers,
)
from repro_torch.train import data
from repro_torch.train.loop import (
    init_train_state, make_serve_step, make_train_step,
    state_shardings,
)
from repro_torch.train.optimizer import AdamW, reference_ndim

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
KW = dict(q_chunk=64, ssm_chunk=8)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _pairs(ref_tree, port_tree, path=()):
    """(path, reference leaf, port leaf) over two nested dicts."""
    for k, v in ref_tree.items():
        if isinstance(v, dict):
            yield from _pairs(v, port_tree[k], path + (k,))
        else:
            yield "/".join(path + (k,)), v, port_tree[k]


def _bf16_ulp(x):
    return np.spacing(np.abs(x).astype(np.float32)) * 2.0 ** 16


# ---- data ------------------------------------------------------------------

@pytest.mark.parametrize("family", ["dense", "vlm", "encdec"])
def test_data_pipeline_bit_equal(family):
    kw = dict(vocab_size=1000, seq_len=33, global_batch=4, frontend_tokens=8,
              frontend_dim=16, family=family)
    for step in (0, 7):
        want = ref_data.batch_for_step(ref_data.DataConfig(**kw), step)
        got = data.batch_for_step(data.DataConfig(**kw), step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        on = data.device_put_batch(got, "cpu")
        for k in want:
            np.testing.assert_array_equal(on[k].numpy(), want[k])
    # step-seeded: the same step again is the same batch, the next is not
    cfg = data.DataConfig(**kw)
    np.testing.assert_array_equal(data.batch_for_step(cfg, 7)["tokens"],
                                  data.batch_for_step(cfg, 7)["tokens"])
    assert not np.array_equal(data.batch_for_step(cfg, 7)["tokens"],
                              data.batch_for_step(cfg, 8)["tokens"])


# ---- the optimizer ---------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(10, 200), (0, 50), (5, 5)])
def test_schedule_equals_reference(warmup, total):
    kw = dict(lr=3e-3, warmup_steps=warmup, total_steps=total,
              min_lr_ratio=0.1)
    ref, port = RefAdamW(**kw), AdamW(**kw)
    steps = np.arange(0, total + 20)
    want = np.asarray([float(ref.schedule(jnp.int32(s))) for s in steps])
    got = np.asarray([float(port.schedule(int(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    t = port.schedule(torch.tensor(3, dtype=torch.int32))
    assert t.dtype == torch.float32


def _perturbed(cfg, rng):
    """The reference's init weights of ``cfg`` plus N(0, 0.5^2) noise in
    every leaf (so every leaf, norms included, is non-zero and the weight
    decay shows), in each leaf's dtype."""
    rm = ref_build(cfg, **KW)
    rp = jax.jit(lambda k: rm.init(k)[0])(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float32)
                              + 0.5 * rng.standard_normal(a.shape),
                              a.dtype), rp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "seamless-m4t-medium",
                                  "falcon-mamba-7b"])
def test_apply_equals_reference(arch, dtype):
    """Three updates on the same parameters and gradients: two clipped
    (global norm ~300), one not.  The hybrid's ``blocks`` D / dt_bias /
    ln1, the encdec's ``cross_blocks`` ln and the SSM's 1-d leaves are rank
    1 in the port and rank 2 in the reference, and are decayed."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    rng = np.random.default_rng(3)
    rparams = _perturbed(cfg, rng)
    params = params_from_reference(cfg, rparams)
    lifted = [k for k, p in params.items()
              if p.ndim == 1 and reference_ndim(k, p) == 2]
    assert lifted, "no leaf whose decay depends on the stacked rank"
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    kw_clip = 1.0
    ropt, opt = RefAdamW(**kw), AdamW(**kw)
    rstate, state = ropt.init(rparams), opt.init(params)
    rapply = jax.jit(ropt.apply)
    rtol = 1e-6
    for scale in (1.0, 1.0, 1e-5):
        rgrads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(scale * rng.standard_normal(a.shape),
                                  a.dtype), rparams)
        grads = params_from_reference(cfg, rgrads)
        rparams, rstate, rm = rapply(rgrads, rstate, rparams)
        params, state, m = opt.apply(grads, state, params)
        gn, rgn = float(m["grad_norm"]), float(rm["grad_norm"])
        np.testing.assert_allclose(gn, rgn, rtol=1e-5)
        # the clip scale carries the norm's rounding into every update and
        # into the moments, which keep it
        if rgn > kw_clip:
            rtol = max(rtol, 1e-6 + 3 * abs(gn / rgn - 1))
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
        assert int(state.step) == int(rstate.step)
        for tree, rtree in ((params, rparams), (state.mu, rstate.mu),
                            (state.nu, rstate.nu)):
            got_tree = stack_layers(tree)
            for name, want, got in _pairs(rtree, got_tree):
                want, bf16 = _f32(want), got.dtype == torch.bfloat16
                got = _f32(got)
                if bf16:
                    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
                    assert np.all(np.abs(got - want) <= ulp), name
                else:
                    np.testing.assert_allclose(
                        got, want, rtol=rtol,
                        atol=rtol * float(np.abs(want).max()), err_msg=name)


# ---- gradients and remat ---------------------------------------------------

def _batch(cfg, rng, b=2, s=12):
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["frontend"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frontend"] = rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
    return batch


class TestGradients:
    @pytest.fixture(scope="class", params=ARCH_IDS)
    def grads(self, request):
        """f32 gradients of the loss: the reference's ``jax.grad`` and the
        port's with remat "block" and "none" (``torch.utils.checkpoint``
        calls counted)."""
        cfg = dataclasses.replace(get_smoke_config(request.param),
                                  dtype="float32")
        rm = ref_build(cfg, **KW)
        rp = jax.jit(lambda k: rm.init(k)[0])(jax.random.PRNGKey(0))
        batch = _batch(cfg, np.random.default_rng(1))
        rb = {k: jnp.asarray(v) for k, v in batch.items()}
        rg = jax.jit(jax.grad(lambda p, b: rm.loss(p, b)[0]))(rp, rb)
        out = {"cfg": cfg, "ref": jax.tree_util.tree_map(np.asarray, rg)}
        real = model_mod.checkpoint
        for remat in ("block", "none"):
            calls = []

            def counted(*a, **k):
                calls.append(1)
                return real(*a, **k)

            model_mod.checkpoint = counted
            try:
                pm = port_model(cfg, rp, remat=remat, **KW)
                state, _ = init_train_state(pm, AdamW())
                loss, _ = pm.loss({k: torch.from_numpy(v)
                                   for k, v in batch.items()})
                g = torch.autograd.grad(loss, list(state.params.values()))
            finally:
                model_mod.checkpoint = real
            out[remat] = dict(zip(state.params, g))
            out[f"{remat}_checkpoints"] = len(calls)
        return out

    def test_gradients_equal_reference(self, grads):
        cfg = grads["cfg"]
        tol = 1e-3 if cfg.family in ("ssm", "hybrid") else 1e-4
        got_tree = stack_layers(grads["block"])
        n = 0
        for name, want, got in _pairs(grads["ref"], got_tree):
            want = _f32(want)
            np.testing.assert_allclose(
                _f32(got), want, rtol=tol,
                atol=tol * max(float(np.abs(want).max()), 1e-30),
                err_msg=name)
            n += want.size
        assert n == sum(g.numel() for g in grads["block"].values())

    def test_remat_is_bit_neutral(self, grads):
        cfg = grads["cfg"]
        blocks = cfg.num_layers + cfg.encoder_layers
        if cfg.family == "hybrid":
            # the mamba blocks; the shared attention block runs outside
            # remat, as in the reference
            blocks = sum(b == BLOCK_MAMBA2 for b in cfg.block_pattern())
        assert grads["block_checkpoints"] == blocks
        assert grads["none_checkpoints"] == 0
        for k, g in grads["block"].items():
            assert torch.equal(g, grads["none"][k]), k


def test_serving_builds_no_graph():
    """Trainable weights (``init_train_state``), and still no autograd
    graph on a serving call, nor a checkpointed block."""
    cfg = get_smoke_config("zamba2-1.2b")
    model = build_model(cfg, device="cpu", **KW)
    init_train_state(model, AdamW())
    assert all(p.requires_grad for p in model.parameters())
    toks = torch.randint(0, cfg.vocab_size, (2, 16))
    real, calls = model_mod.checkpoint, []
    model_mod.checkpoint = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        lg, cache = model.prefill({"tokens": toks}, max_len=20)
        lg2, cache2 = make_serve_step(model)(None, cache, toks[:, :1])
        lg3, _ = model.prefill_chunked({"tokens": toks}, seg_len=8)
    finally:
        model_mod.checkpoint = real
    assert not calls
    for t in (lg, lg2, lg3, *[c for c in cache2[:5] if c is not None]):
        assert not t.requires_grad and t.grad_fn is None


# ---- the loop: twins of tests/test_train_ckpt_fault.py ----------------------

def _fresh(cfg=None, seed=0):
    """A new port model of ``cfg`` (stablelm-1.6b's smoke config) and its
    state: each call the same weights (a seeded CPU generator)."""
    cfg = cfg or get_smoke_config("stablelm-1.6b")
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed),
                        q_chunk=64)
    opt = AdamW(lr=1e-3, warmup_steps=10, total_steps=200)
    state, specs = init_train_state(model, opt)
    dcfg = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=65,
                           global_batch=8, copy_period=16)
    return model, opt, state, specs, dcfg


def test_loss_decreases():
    model, opt, state, _, dcfg = _fresh()
    ts, _ = make_train_step(model, opt, microbatches=2)
    losses = []
    for step in range(30):
        state, m = ts(state, data.batch_for_step(dcfg, step))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3


def test_microbatch_equivalence():
    m1, opt, s1, _, dcfg = _fresh()
    m4, _, s4, _, _ = _fresh()
    batch = data.batch_for_step(dcfg, 0)
    s1, r1 = make_train_step(m1, opt, microbatches=1)[0](s1, batch)
    s4, r4 = make_train_step(m4, opt, microbatches=4)[0](s4, batch)
    # losses averaged over microbatches equal the full-batch loss
    assert abs(float(r1["loss"]) - float(r4["loss"])) < 5e-2
    # parameters after the step are close (fp32 accumulation, bf16 params)
    for k, a in s1.params.items():
        np.testing.assert_allclose(_f32(a), _f32(s4.params[k]), rtol=0.1,
                                   atol=0.05, err_msg=k)


def test_microbatch_gradients_accumulate_in_f32():
    """bf16 weights, 2 microbatches: the optimizer gets the mean of the
    microbatches' gradients summed in f32 (accumulating through ``.grad``
    would sum in bf16), from contiguous rows."""
    seen = {}

    class Spy(AdamW):
        def apply(self, grads, state, params):
            seen.update(grads)
            return super().apply(grads, state, params)

    model, _, state, _, dcfg = _fresh()
    opt = Spy(lr=1e-3, warmup_steps=10, total_steps=200)
    batch = data.batch_for_step(dcfg, 0)
    want = None
    for rows in (slice(0, 4), slice(4, 8)):
        loss, _ = model.loss({k: torch.from_numpy(v[rows])
                              for k, v in batch.items()})
        g = torch.autograd.grad(loss, list(state.params.values()))
        g = [x.float() for x in g]
        want = g if want is None else [a + b for a, b in zip(want, g)]
    make_train_step(model, opt, microbatches=2)[0](state, batch)
    for k, w in zip(state.params, want):
        assert seen[k].dtype == torch.float32
        assert torch.equal(seen[k], w / 2), k


def test_state_shardings_mirror_params():
    _, _, state, specs, _ = _fresh()
    sh = state_shardings(specs, state, {"data": 2, "model": 1})
    assert sh.params["embed"].spec == ("model", "data")
    assert sh.opt.mu == sh.params and sh.opt.nu == sh.params
    assert sh.opt.step.spec == ()


@pytest.mark.parametrize("microbatches", [1, 2])
def test_trajectory_equals_reference(microbatches):
    """5 steps of the reference's setup (stablelm-1.6b smoke, bf16, AdamW
    warmup 10) from the same weights through both train steps."""
    cfg = get_smoke_config("stablelm-1.6b")
    rm = ref_build(cfg, q_chunk=64)
    ropt = RefAdamW(lr=1e-3, warmup_steps=10, total_steps=200)
    rstate, _ = ref_init_state(rm, ropt, jax.random.PRNGKey(0))
    rts = jax.jit(ref_make_step(rm, ropt, ref_mesh((1, 1), ("data", "model")),
                                microbatches=microbatches)[0])
    pm = port_model(cfg, rstate.params, q_chunk=64)
    opt = AdamW(lr=1e-3, warmup_steps=10, total_steps=200)
    state, _ = init_train_state(pm, opt)
    ts, _ = make_train_step(pm, opt, microbatches=microbatches)
    dcfg = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=65,
                           global_batch=8, copy_period=16)
    lr_sum = 0.0
    for step in range(5):
        batch = data.batch_for_step(dcfg, step)
        rstate, rmet = rts(rstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, met = ts(state, batch)
        np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]),
                                   rtol=1e-3, err_msg=f"step {step}")
        np.testing.assert_allclose(float(met["lr"]), float(rmet["lr"]),
                                   rtol=1e-6)
        lr_sum += float(rmet["lr"])
    off, total = 0, 0
    for name, want, got in _pairs(rstate.params, stack_layers(state.params)):
        want, got = _f32(want), _f32(got)
        ulp = _bf16_ulp(want)
        d = np.abs(got - want)
        assert np.all(d <= 2 * lr_sum + ulp), name
        off += int((d > ulp).sum())
        total += want.size
    assert off <= 0.05 * total


def test_launcher_trains_and_resumes(tmp_path, capsys):
    """``launch.train``: the reference's custom configs and printed lines;
    with ``--ckpt-dir`` the fault-tolerant loop checkpoints, and a second
    run resumes at the last step with nothing left to do."""
    from repro.launch.train import custom_dense_config as ref_custom
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.launch import train as launcher

    for m in (5, 100, 400):
        assert (dataclasses.asdict(launcher.custom_dense_config(m))
                == dataclasses.asdict(ref_custom(m)))
    argv = ["--smoke", "--device", "cpu", "--steps", "10", "--log-every",
            "5", "--batch", "4", "--seq", "33", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "5"]
    launcher.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=stablelm-1.6b-smoke params=0.1M"
    assert len(out) == 3
    for line, step in zip(out[1:], (5, 10)):
        assert re.fullmatch(rf"step +{step} loss \d+\.\d{{4}} gnorm "
                            rf"\d+\.\d{{3}} lr \d\.\d\de-\d\d "
                            rf"\(\d+ tok/s\)", line), line
    assert ck.latest_step(str(tmp_path)) == 10
    launcher.main(argv)
    assert capsys.readouterr().out.splitlines() == out[:1]


# ---- a 2-rank gloo mesh ----------------------------------------------------

def _mesh_cfg():
    """stablelm-1.6b's smoke config in f32 with an odd vocabulary (255): on
    a model axis of 2 the vocab dims do not divide and stay replicated."""
    return dataclasses.replace(get_smoke_config("stablelm-1.6b"),
                               dtype="float32", vocab_size=255)


_RANK = r"""
import dataclasses, datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding as shard_lib
from repro_torch.distributed.fault import elastic_restore
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import build_model
from repro_torch.train import data
from repro_torch.train.loop import init_train_state, make_train_step
from repro_torch.train.optimizer import AdamW

rank, where = int(sys.argv[1]), sys.argv[2]
dist.init_process_group(
    "gloo", store=dist.FileStore(where + "/store", 2), rank=rank,
    world_size=2, timeout=datetime.timedelta(seconds=120))
cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"),
                          dtype="float32", vocab_size=255)
out = {}
for shape in ((2, 1), (1, 2)):
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0),
                        q_chunk=64)
    state, specs = init_train_state(model, AdamW())
    saved = {k: p.detach().clone() for k, p in state.params.items()}
    restored, step, _ = elastic_restore(where + "/ckpt", state.params, mesh,
                                        specs)
    sh = shard_lib.param_shardings(specs, state.params, mesh)
    rec = {"step": step, "placements": {}, "full_equal": [],
           "all_dtensor": all(isinstance(t, DTensor)
                              for t in restored.values())}
    for k, t in restored.items():
        rec["placements"][k] = [str(p) for p in t.placements]
        if not torch.equal(t.full_tensor(), saved[k]):
            rec["full_equal"].append(k)
    rec["placements_follow_specs"] = all(
        tuple(restored[k].placements) == sh[k].placements() for k in sh)
    out[f"{shape[0]}x{shape[1]}"] = rec
    if shape == (2, 1):
        opt = AdamW(lr=1e-3, warmup_steps=10, total_steps=200)
        state, _ = init_train_state(model, opt)
        ts, _ = make_train_step(model, opt, mesh=mesh, microbatches=2)
        dcfg = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=33,
                               global_batch=8, copy_period=8)
        state, m = ts(state, data.batch_for_step(dcfg, 0))
        out["metrics"] = {k: float(v) for k, v in m.items()}
        np.savez(where + f"/params{rank}.npz", **{
            k: p.detach().numpy() for k, p in state.params.items()})
with open(where + f"/out{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo_two_ranks(tmp_path_factory):
    """Two gloo rank processes on a FileStore (OMP_NUM_THREADS=1): each
    elastic-restores a checkpoint of the initial weights onto a (2, 1) and
    a (1, 2) ("data", "model") mesh, then takes one data-parallel step on
    the (2, 1) mesh."""
    from repro_torch.ckpt import checkpoint as ck

    where = tmp_path_factory.mktemp("gloo_two_ranks")
    model, _, state, specs, _ = _fresh(_mesh_cfg())
    ck.save_checkpoint(str(where / "ckpt"), 5, state.params)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(where)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    outs = [json.loads((where / f"out{r}.json").read_text())
            for r in range(2)]
    params = [dict(np.load(where / f"params{r}.npz")) for r in range(2)]
    return outs, params, state, specs


def test_data_parallel_step_equals_one_rank(gloo_two_ranks):
    outs, params, _, _ = gloo_two_ranks
    cfg = _mesh_cfg()
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0),
                        q_chunk=64)
    opt = AdamW(lr=1e-3, warmup_steps=10, total_steps=200)
    state, _ = init_train_state(model, opt)
    dcfg = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=33,
                           global_batch=8, copy_period=8)
    state, m = make_train_step(model, opt, microbatches=2)[0](
        state, data.batch_for_step(dcfg, 0))
    lr = float(m["lr"])
    for r, out in enumerate(outs):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(out["metrics"][k], float(m[k]),
                                       rtol=1e-5, err_msg=f"rank {r} {k}")
        for k, p in state.params.items():
            # replicated: the two ranks hold the same bits
            np.testing.assert_array_equal(params[r][k], params[0][k])
            # the first Adam step moves an entry by ~sign(g) x lr: a
            # gradient entry near zero may round the other way
            np.testing.assert_allclose(params[r][k], _f32(p), rtol=1e-5,
                                       atol=2 * lr, err_msg=k)
    # most entries agree far more closely than the bound
    d = np.concatenate([np.abs(params[0][k] - _f32(p)).ravel()
                        for k, p in state.params.items()])
    assert (d > 1e-6).mean() < 0.01


def test_elastic_restore_on_two_ranks(gloo_two_ranks):
    """DTensors whose placements follow the resolved specs (the odd vocab
    replicated on the model axis, though its logical name says "model"),
    whose ``full_tensor()`` is the saved state."""
    from repro_torch.distributed import sharding as shard_lib

    outs, _, state, specs = gloo_two_ranks
    for shape in ("2x1", "1x2"):
        sizes = dict(zip(("data", "model"), map(int, shape.split("x"))))
        for r, out in enumerate(outs):
            rec = out[shape]
            assert rec["step"] == 5
            assert rec["all_dtensor"] and rec["placements_follow_specs"]
            assert rec["full_equal"] == [], (r, shape, rec["full_equal"])
            for k, spec in specs.items():
                want = shard_lib.placements(shard_lib.logical_to_spec(
                    spec, shape=tuple(state.params[k].shape), mesh=sizes),
                    sizes)
                assert rec["placements"][k] == [str(p) for p in want], k
    from torch.distributed.tensor import Replicate, Shard

    assert outs[0]["1x2"]["placements"]["embed"] == [str(Shard(1)),
                                                     str(Replicate())]
    assert outs[0]["1x2"]["placements"]["blocks.0.attn.wq"] == [
        str(Shard(0)), str(Shard(1))]
