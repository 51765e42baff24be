"""The port's sharded training step (FSDP over "data", tensor parallelism
over "model", ``train.loop.make_train_step(..., param_shardings=)``) on a
(2, 2) ("data", "model") gloo mesh of 4 rank processes against the
one-rank step, and against the reference's own sharded step.

Each case takes one step of 2 microbatches in f32 on the same weights and
data.  AdamW's clip is lifted (``clip_norm`` 1e9) so that the first
moment after one step is 0.1 x the gradient: the ranks write the moments'
and parameters' full tensors, and the moment holds the sharded step's
whole gradient.

Bars: loss and ``grad_norm`` rtol 1e-5; each gradient leaf within 1e-4 of
its largest |g| (the SSM and hybrid families 1e-3: their d_inner blocks
reassociate the f32 sums of the projections); the parameters within
the two-rank data-parallel test's bar in ``tests/test_torch_train.py``
(2 x lr, under 1% of entries beyond 1e-6).  Against
the reference's sharded step (two steps): losses and norms rtol 1e-5,
parameters within 2 x the summed learning rates, under 1% beyond 1e-6.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.distributed import sharding as shard_lib
from repro_torch.models.layers import moe_route
from repro_torch.models.model import build_model
from repro_torch.train import data
from repro_torch.train.loop import init_train_state, make_train_step
from repro_torch.train.optimizer import AdamW

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
KW = dict(q_chunk=64, ssm_chunk=8)
SSM_FAMILIES = ("ssm", "hybrid")


def _cases():
    """name -> (arch, config overrides, model overrides)."""
    out = {a: (a, {}, {}) for a in ARCH_IDS}
    out.update({f"{a}|sp": (a, {}, {"seq_parallel": True})
                for a in ARCH_IDS})
    out.update({
        "granite-moe-3b-a800m|nohint": ("granite-moe-3b-a800m", {},
                                        {"moe_dispatch_hint": False}),
        "mixtral-8x22b|nohint": ("mixtral-8x22b", {},
                                 {"moe_dispatch_hint": False}),
        "granite-moe-3b-a800m|drops": ("granite-moe-3b-a800m", {},
                                       {"moe_capacity": 0.5}),
        "mixtral-8x22b|drops-sp": ("mixtral-8x22b", {},
                                   {"moe_capacity": 0.5,
                                    "seq_parallel": True}),
        "stablelm-1.6b|odd-vocab": ("stablelm-1.6b", {"vocab_size": 255},
                                    {}),
    })
    return out


CASES = _cases()


def _cfg(arch, over):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               **over)


def _dcfg(cfg):
    return data.DataConfig(vocab_size=cfg.vocab_size, seq_len=33,
                           global_batch=8, copy_period=8, family=cfg.family,
                           frontend_tokens=cfg.frontend_tokens,
                           frontend_dim=cfg.frontend_dim)


def _opt():
    return AdamW(lr=1e-3, warmup_steps=10, total_steps=200, clip_norm=1e9)


_RANK = r"""
import dataclasses, datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
import test_torch_sharded_train as T
from repro_torch.ckpt import checkpoint as ck
from repro_torch.distributed import sharding as shard_lib
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import build_model
from repro_torch.train import data
from repro_torch.train.loop import (init_train_state, make_train_step,
                                    shard_state, state_shardings)

rank, where = int(sys.argv[1]), sys.argv[2]
dist.init_process_group(
    "gloo", store=dist.FileStore(where + "/store", 4), rank=rank,
    world_size=4, timeout=datetime.timedelta(seconds=120))
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
out = {}
for name, (arch, over, kw) in T.CASES.items():
    cfg = T._cfg(arch, over)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0),
                        **T.KW, **kw)
    opt = T._opt()
    state, specs = init_train_state(model, opt)
    sh = state_shardings(specs, state, mesh)
    state = shard_state(state, specs, mesh)
    ts, _ = make_train_step(model, opt, mesh, 2, param_shardings=sh.params)
    state, m = ts(state, data.batch_for_step(T._dcfg(cfg), 0))
    rec = {"metrics": {k: float(v) for k, v in m.items()},
           "local": {k: [list(t.to_local().shape),
                         list(t.shape), [str(p) for p in t.placements]]
                     for k, t in state.params.items()},
           "moments_local": all(
               state.opt.mu[k].to_local().shape == t.to_local().shape
               and state.opt.nu[k].to_local().shape == t.to_local().shape
               for k, t in state.params.items())}
    full = {"p/" + k: t.full_tensor().numpy()
            for k, t in state.params.items()}
    full.update({"mu/" + k: t.full_tensor().numpy()
                 for k, t in state.opt.mu.items()})
    if rank == 0:
        np.savez(where + "/" + name.replace("|", "_") + ".npz", **full)
    if name == "stablelm-1.6b":
        ck.save_checkpoint(where + "/ckpt", 1, state)
        dist.barrier()
        back, step, _ = ck.restore_checkpoint(where + "/ckpt", state,
                                              shardings=sh)
        # every rank runs every gather: no short-circuit
        same = [(torch.equal(back.params[k].full_tensor(),
                             state.params[k].full_tensor()),
                 torch.equal(back.opt.mu[k].to_local(),
                             state.opt.mu[k].to_local()),
                 tuple(back.params[k].placements)
                 == sh.params[k].placements()) for k in state.params]
        rec["restore_equal"] = all(map(all, same)) and step == 1
    out[name] = rec
with open(where + f"/out{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


def run_ranks(script, where, n=4, timeout=300):
    """``script`` in ``n`` rank processes (argv: rank, ``where``), one
    thread each; asserts they all exit 0."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), str(pathlib.Path(__file__).parent)]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(where)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    where = tmp_path_factory.mktemp("sharded_train")
    run_ranks(_RANK, where)
    outs = [json.loads((where / f"out{r}.json").read_text())
            for r in range(4)]
    return where, outs


@pytest.fixture(scope="module")
def one_rank():
    """name -> (metrics, params, first moments) of the one-rank step."""
    out = {}
    for name, (arch, over, kw) in CASES.items():
        cfg = _cfg(arch, over)
        model = build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0),
                            **KW, **kw)
        opt = _opt()
        state, _ = init_train_state(model, opt)
        ts, _ = make_train_step(model, opt, microbatches=2)
        state, m = ts(state, data.batch_for_step(_dcfg(cfg), 0))
        out[name] = ({k: float(v) for k, v in m.items()},
                     {k: p.detach().numpy().copy()
                      for k, p in state.params.items()},
                     {k: t.numpy().copy() for k, t in state.opt.mu.items()})
    return out


def _check(name, metrics, params, mu, want_metrics, want_params, want_mu,
           lr):
    arch = CASES[name][0]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(metrics[k], want_metrics[k], rtol=1e-5,
                                   err_msg=f"{name} {k}")
    tol = 1e-3 if get_smoke_config(arch).family in SSM_FAMILIES else 1e-4
    for k, want in want_mu.items():
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(mu[k], want, rtol=0, atol=tol * scale,
                                   err_msg=f"{name} gradient {k}")
    d = []
    for k, want in want_params.items():
        np.testing.assert_allclose(params[k], want, rtol=1e-5, atol=2 * lr,
                                   err_msg=f"{name} {k}")
        d.append(np.abs(params[k] - want).ravel())
    assert (np.concatenate(d) > 1e-6).mean() < 0.01, name


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_equals_one_rank(name, mesh_run, one_rank):
    where, outs = mesh_run
    want_m, want_p, want_mu = one_rank[name]
    got = dict(np.load(where / (name.replace("|", "_") + ".npz")))
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[name]["metrics"]["loss"],
                                   outs[0][name]["metrics"]["loss"],
                                   rtol=1e-6, err_msg=f"rank {r}")
    _check(name, outs[0][name]["metrics"],
           {k[2:]: v for k, v in got.items() if k.startswith("p/")},
           {k[3:]: v for k, v in got.items() if k.startswith("mu/")},
           want_m, want_p, want_mu, want_m["lr"])


def test_moe_capacity_case_drops_tokens():
    """The ``drops`` cases run at a capacity where the one-rank router
    drops (token, choice) pairs in every layer's first microbatch."""
    for name in ("granite-moe-3b-a800m|drops", "mixtral-8x22b|drops-sp"):
        arch, over, kw = CASES[name]
        cfg = _cfg(arch, over)
        model = build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0),
                            **KW, **kw)
        batch = data.batch_for_step(_dcfg(cfg), 0)
        tokens = torch.as_tensor(batch["tokens"][:4])
        x = model.embed[tokens].reshape(-1, cfg.d_model)
        r = moe_route(model.blocks[0].ff.tree(), x, cfg, kw["moe_capacity"])
        assert 0 < int((~r["keep"]).sum()) < r["keep"].numel(), name


def test_per_rank_storage(mesh_run):
    """Each rank's local parameter (and moment) storage is the resolved
    spec's share: a quarter wherever both axes divide."""
    _, outs = mesh_run
    sizes = {"data": 2, "model": 2}
    for name in ("stablelm-1.6b", "stablelm-1.6b|odd-vocab",
                 "granite-moe-3b-a800m", "falcon-mamba-7b"):
        arch, over, kw = CASES[name]
        model = build_model(_cfg(arch, over), device="cpu", **KW, **kw)
        quarter = 0
        for out in outs:
            rec = out[name]
            assert rec["moments_local"]
            for k, spec in model.specs.items():
                local, shape, placements = rec["local"][k]
                resolved = shard_lib.logical_to_spec(spec, shape=shape,
                                                     mesh=sizes)
                want = list(shard_lib.local_shape(shape, resolved, sizes))
                assert local == want, (name, k, local, want)
                assert placements == [str(p) for p in shard_lib.placements(
                    resolved, sizes)]
                quarter += int(np.prod(local)) * 4 == int(np.prod(shape))
        assert quarter > 0
    emb = outs[0]["stablelm-1.6b|odd-vocab"]["local"]["embed"]
    assert emb[0] == [255, 32]          # vocab 255 stays whole on "model"


def test_sharded_checkpoint_restores(mesh_run, tmp_path):
    """The sharded state's checkpoint holds whole tensors: restored onto
    (2, 2) it gives back every shard and placement; restored on one rank
    it is the state the ranks wrote."""
    from repro_torch.ckpt import checkpoint as ck

    where, outs = mesh_run
    assert all(out["stablelm-1.6b"]["restore_equal"] for out in outs)
    cfg = _cfg("stablelm-1.6b", {})
    model = build_model(cfg, device="cpu", **KW)
    state, _ = init_train_state(model, _opt())
    back, step, _ = ck.restore_checkpoint(str(where / "ckpt"), state)
    got = dict(np.load(where / "stablelm-1.6b.npz"))
    assert step == 1 and int(back.opt.step) == 1
    for k, t in back.params.items():
        np.testing.assert_array_equal(t.numpy(), got["p/" + k])
        np.testing.assert_array_equal(back.opt.mu[k].numpy(),
                                      got["mu/" + k])


# ---- the reference's sharded step -------------------------------------------

_REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models.model import build_model
from repro.train import data
from repro.train.loop import (TrainState, init_train_state, jit_train_step,
                              make_train_step, state_shardings)
from repro.train.optimizer import AdamW

arch, where = sys.argv[1], sys.argv[2]
cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
model = build_model(cfg, q_chunk=64, ssm_chunk=8)
opt = AdamW(lr=1e-3, warmup_steps=10, total_steps=200, clip_norm=1e9)
state, specs = init_train_state(model, opt, jax.random.PRNGKey(0))
flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(state.params)[0]}
np.savez(where + "/ref_init.npz", **flat)
mesh = make_mesh((2, 2), ("data", "model"))
st_sh = state_shardings(specs, state, mesh)
step, bsh = make_train_step(model, opt, mesh, microbatches=2,
                            param_shardings=st_sh.params)
fn = jit_train_step(step, st_sh, bsh)
dcfg = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=33,
                       global_batch=8, copy_period=8, family=cfg.family)
out = []
for s in range(2):
    state, m = fn(state, data.batch_for_step(dcfg, s))
    out.append({k: float(v) for k, v in m.items()})
flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(state.params)[0]}
np.savez(where + "/ref_final.npz", **flat)
json.dump(out, open(where + "/ref_metrics.json", "w"))
"""

_PORT = r"""
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
import test_torch_sharded_train as T
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import build_model, params_from_reference
from repro_torch.train import data
from repro_torch.train.loop import (init_train_state, make_train_step,
                                    shard_state, state_shardings)

rank, where = int(sys.argv[1]), sys.argv[2]
arch = open(where + "/arch").read()
dist.init_process_group(
    "gloo", store=dist.FileStore(where + "/store", 4), rank=rank,
    world_size=4, timeout=datetime.timedelta(seconds=120))
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
cfg = T._cfg(arch, {})
model = build_model(cfg, device="cpu", **T.KW)
flat = dict(np.load(where + "/ref_init.npz"))
tree = {}
for k, v in flat.items():
    node = tree
    *path, leaf = k.split("/")
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = v
model.load_state_dict(params_from_reference(cfg, tree))
opt = T._opt()
state, specs = init_train_state(model, opt)
sh = state_shardings(specs, state, mesh)
state = shard_state(state, specs, mesh)
ts, _ = make_train_step(model, opt, mesh, 2, param_shardings=sh.params)
dcfg = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=33,
                       global_batch=8, copy_period=8, family=cfg.family)
out = []
for s in range(2):
    state, m = ts(state, data.batch_for_step(dcfg, s))
    out.append({k: float(v) for k, v in m.items()})
if rank == 0:
    from repro_torch.models.model import params_to_reference
    full = {k: t.full_tensor() for k, t in state.params.items()}
    ref = params_to_reference(full)
    flat = {}
    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(prefix + k + "/", v)
            else:
                flat[prefix + k] = v
    walk("", ref)
    np.savez(where + "/port_final.npz", **flat)
    json.dump(out, open(where + "/port_metrics.json", "w"))
else:
    [t.full_tensor() for t in state.params.values()]
dist.destroy_process_group()
"""


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-moe-3b-a800m"])
def test_sharded_step_against_reference_sharded_step(arch, tmp_path):
    """Two steps of the reference's GSPMD step at (2, 2) on 4 forced host
    devices against the port's explicit one on the gloo (2, 2) mesh, from
    the reference's initial weights."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF, arch, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    (tmp_path / "arch").write_text(arch)
    run_ranks(_PORT, tmp_path)
    want = json.loads((tmp_path / "ref_metrics.json").read_text())
    got = json.loads((tmp_path / "port_metrics.json").read_text())
    lr_sum = 0.0
    for w, g in zip(want, got):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
        lr_sum += w["lr"]
    want_p = dict(np.load(tmp_path / "ref_final.npz"))
    got_p = dict(np.load(tmp_path / "port_final.npz"))
    assert set(want_p) == set(got_p)
    d = []
    for k, w in want_p.items():
        np.testing.assert_allclose(got_p[k], w, rtol=1e-5,
                                   atol=2 * lr_sum, err_msg=k)
        d.append(np.abs(got_p[k] - w).ravel())
    assert (np.concatenate(d) > 1e-6).mean() < 0.01
