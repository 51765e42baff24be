"""The port's checkpoints, fault-tolerant loop and sharding rules
(``repro_torch.ckpt``, ``repro_torch.distributed``) against the JAX
reference on the CPU: the twins of ``tests/test_train_ckpt_fault.py``'s
checkpoint, fault and elastic tests; checkpoints written by either package
and restored by the other, bit for bit, with equal sha256 digests; every
parameter's resolved spec equal to the reference's ``PartitionSpec`` for
the ten smoke and the ten full configs on (16, 16) and (2, 16, 16) meshes
(the reference through ``abstract_mesh``, as
``tests/test_sharding_roofline.py`` does; the port's full-size weights as
fake tensors), and the activation and cache specs.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_port import gloo_world_of_one, port_model
from repro.ckpt import checkpoint as ref_ck
from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke
from repro.distributed import sharding as ref_sl
from repro.launch.mesh import make_mesh as ref_mesh
from repro.models.model import build_model as ref_build
from repro.train.loop import init_train_state as ref_init_state
from repro.train.loop import make_train_step as ref_make_step
from repro.train.optimizer import AdamW as RefAdamW
from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed import sharding as sl
from repro_torch.distributed.fault import (
    FaultConfig, FaultTolerantLoop, elastic_restore,
)
from repro_torch.models.model import (
    build_model, params_to_reference, reference_path,
)
from repro_torch.train.data import DataConfig, batch_for_step
from repro_torch.train.loop import init_train_state, make_train_step
from repro_torch.train.optimizer import AdamW


def _setup():
    """The reference test's setup, the port's weights: a new model each
    call, the same seeded weights."""
    cfg = get_smoke_config("stablelm-1.6b")
    model = build_model(cfg, device="cpu", q_chunk=64,
                        generator=torch.Generator().manual_seed(0))
    opt = AdamW(lr=1e-3, warmup_steps=10, total_steps=200)
    state, specs = init_train_state(model, opt)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=65, global_batch=8,
                      copy_period=16)
    return model, opt, state, specs, dcfg


def _leaves(state):
    """(name, tensor) of a TrainState, moments and step included."""
    out = [(f"params/{k}", v) for k, v in state.params.items()]
    out += [(f"mu/{k}", v) for k, v in state.opt.mu.items()]
    out += [(f"nu/{k}", v) for k, v in state.opt.nu.items()]
    return out + [("step", state.opt.step)]


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x.detach(), y.detach()), n


# ---- twins of tests/test_train_ckpt_fault.py --------------------------------

def test_checkpoint_roundtrip_and_gc(tmp_path):
    model, opt, state, _, dcfg = _setup()
    ts, _ = make_train_step(model, opt)
    state, _ = ts(state, batch_for_step(dcfg, 0))    # moments non-zero
    d = str(tmp_path)
    for step in (1, 2, 3, 4):
        ck.save_checkpoint(d, step, state, keep=2)
    assert ck.latest_step(d) == 4
    dirs = [x for x in os.listdir(d) if x.startswith("step_")]
    assert len(dirs) == 2  # gc keeps last 2
    restored, step, _ = ck.restore_checkpoint(d, state,
                                              validate_digests=True)
    assert step == 4
    _assert_states_equal(restored, state)
    # new tensors, not the live ones
    assert all(r is not s for (_, r), (_, s) in zip(_leaves(restored),
                                                    _leaves(state)))
    # the reference's leaf names, layers stacked
    man = json.loads((tmp_path / "step_00000004" / "manifest.json")
                     .read_text())
    assert man["leaves"]["params/blocks/attn/wq"]["shape"] == [2, 64, 64]
    assert man["leaves"]["params/blocks/attn/wq"]["dtype"] == "bfloat16"
    assert man["leaves"]["opt/mu/blocks/ln1"]["dtype"] == "float32"
    assert man["leaves"]["opt/step"] == dict(
        man["leaves"]["opt/step"], shape=[], dtype="int32")


def test_async_save_copies_before_returning(tmp_path):
    """The async writer gets host copies made before ``save_checkpoint``
    returns: an in-place update right after cannot reach the file."""
    _, _, state, _, _ = _setup()
    want = {k: v.detach().clone() for k, v in state.params.items()}
    t = ck.save_checkpoint(str(tmp_path), 1, state.params, async_mode=True)
    with torch.no_grad():
        for p in state.params.values():
            p.add_(1.0)
    t.join(timeout=60)
    assert not t.is_alive()
    restored, _, _ = ck.restore_checkpoint(str(tmp_path), state.params)
    for k, v in want.items():
        assert torch.equal(restored[k], v), k


def _step_fn(ts, dcfg, fault_at=None):
    fails = {"n": 0}

    def step_fn(st, step):
        if step == fault_at and fails["n"] == 0:
            fails["n"] += 1
            return st, {"loss": float("nan"), "grad_norm": 1.0}
        st, m = ts(st, batch_for_step(dcfg, step))
        return st, {k: float(v) for k, v in m.items()}

    return step_fn


def test_fault_recovery_deterministic(tmp_path):
    """A NaN fault mid-run rolls back + skips; the run completes, the final
    step count is exact, and the state is bit for bit that of a clean run
    over the same data without the skipped step's."""
    model, opt, state, _, dcfg = _setup()
    ts, _ = make_train_step(model, opt)
    loop = FaultTolerantLoop(_step_fn(ts, dcfg, fault_at=6), state,
                             FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=3,
                                         async_ckpt=False))
    loop.run(10)
    assert loop.restarts == 1
    assert loop.step == 10
    model2, opt2, clean, _, _ = _setup()
    ts2, _ = make_train_step(model2, opt2)
    for step in (0, 1, 2, 3, 4, 5, 7, 8, 9):
        clean, _ = ts2(clean, batch_for_step(dcfg, step))
    _assert_states_equal(loop.state, clean)


def test_fault_loop_rolls_back_on_device_error(tmp_path):
    """A device error (``torch.AcceleratorError``) rolls back without a
    skip and replays the step; any other error propagates."""
    model, opt, state, _, dcfg = _setup()
    ts, _ = make_train_step(model, opt)
    inner = _step_fn(ts, dcfg)
    seen, raised = [], {"n": 0}

    def step_fn(st, step):
        seen.append(step)
        if step == 4 and raised["n"] == 0:
            raised["n"] += 1
            raise torch.AcceleratorError("injected")
        return inner(st, step)

    loop = FaultTolerantLoop(step_fn, state,
                             FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=3,
                                         async_ckpt=True))
    loop.run(6)
    assert loop.restarts == 1 and loop.step == 6
    assert seen == [0, 1, 2, 3, 4, 3, 4, 5]

    def bug(st, step):
        raise RuntimeError("a bug, not a fault")

    with pytest.raises(RuntimeError, match="a bug"):
        FaultTolerantLoop(bug, loop.state, FaultConfig(
            ckpt_dir=str(tmp_path / "b"), async_ckpt=False)).run(1)


def test_elastic_restore_different_mesh(tmp_path):
    """A checkpoint of the parameters restores onto a mesh as DTensors
    placed by the resolved specs, their full tensors the saved ones."""
    from torch.distributed.tensor import DTensor

    _, _, state, specs, _ = _setup()
    ck.save_checkpoint(str(tmp_path / "ckpt"), 5, state.params)
    with gloo_world_of_one(tmp_path) as new_mesh:
        restored, step, _ = elastic_restore(str(tmp_path / "ckpt"),
                                            state.params, new_mesh, specs)
        assert step == 5
        sh = sl.param_shardings(specs, state.params, new_mesh)
        for k, v in state.params.items():
            t = restored[k]
            assert isinstance(t, DTensor)
            assert tuple(t.placements) == sh[k].placements()
            assert torch.equal(t.full_tensor(), v.detach()), k


# ---- checkpoints across the two packages ------------------------------------

@pytest.fixture(scope="module")
def ref_checkpoint(tmp_path_factory):
    """The reference's state after one train step (stablelm-1.6b smoke,
    bf16), saved by the reference."""
    cfg = ref_get_smoke("stablelm-1.6b")
    rm = ref_build(cfg, q_chunk=64)
    ropt = RefAdamW(lr=1e-3, warmup_steps=10, total_steps=200)
    rstate, _ = ref_init_state(rm, ropt, jax.random.PRNGKey(0))
    ts, _ = ref_make_step(rm, ropt, ref_mesh((1, 1), ("data", "model")))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=65, global_batch=8,
                      copy_period=16)
    rstate, _ = jax.jit(ts)(rstate, {
        k: jnp.asarray(v) for k, v in batch_for_step(dcfg, 0).items()})
    d = tmp_path_factory.mktemp("ref_ckpt")
    ref_ck.save_checkpoint(str(d), 1, rstate)
    return cfg, rstate, d


def _manifest(d, step):
    return json.loads((d / f"step_{step:08d}" / "manifest.json").read_text())


def test_checkpoints_cross_packages(ref_checkpoint, tmp_path):
    cfg, rstate, d_ref = ref_checkpoint
    # the port restores the reference's checkpoint ...
    pm = port_model(get_smoke_config("stablelm-1.6b"), rstate.params,
                    q_chunk=64)
    target, _ = init_train_state(pm, AdamW())
    state, step, _ = ck.restore_checkpoint(str(d_ref), target,
                                           validate_digests=True)
    assert step == 1 and int(state.opt.step) == int(rstate.opt.step) == 1
    for tree, rtree in ((state.params, rstate.params),
                        (state.opt.mu, rstate.opt.mu),
                        (state.opt.nu, rstate.opt.nu)):
        got = params_to_reference(tree)
        for path, want in jax.tree_util.tree_leaves_with_path(rtree):
            g = got
            for p in path:
                g = g[p.key]
            np.testing.assert_array_equal(g, np.asarray(want, np.float32),
                                          err_msg=str(path))
    # ... writes it back in the same layout, digest for digest ...
    ck.save_checkpoint(str(tmp_path), 1, state)
    mine, theirs = _manifest(tmp_path, 1), _manifest(d_ref, 1)
    assert mine["leaves"] == theirs["leaves"]
    for meta in mine["leaves"].values():
        assert ((tmp_path / "step_00000001" / meta["file"]).read_bytes()
                == (d_ref / "step_00000001" / meta["file"]).read_bytes())
    # ... and the reference restores the port's, bit for bit
    back, step, _ = ref_ck.restore_checkpoint(str(tmp_path), rstate,
                                              validate_digests=True)
    assert step == 1
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(rstate)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---- sharding rules ---------------------------------------------------------

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def test_logical_to_spec_divisibility():
    big = {"data": 16, "model": 16}
    assert sl.logical_to_spec(("embed", "kv"), shape=(64, 1),
                              mesh=big) == ("data", None)
    assert sl.logical_to_spec(("embed", "kv"), shape=(64, 32),
                              mesh=big) == ("data", "model")
    assert sl.logical_to_spec(("embed", "kv"), shape=(33, 1),
                              mesh=big) == (None, None)
    # the placement follows the resolved spec, not the logical names
    from torch.distributed.tensor import Replicate, Shard

    assert sl.placements((None, None), big) == (Replicate(), Replicate())
    assert sl.placements(("data", "model"), big) == (Shard(0), Shard(1))
    pod = {"pod": 2, "data": 16, "model": 16}
    assert sl.placements((("pod", "data"), None), pod) == (
        Shard(0), Shard(0), Replicate())


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, size):
    """Every parameter's resolved spec on both meshes: the reference's
    stacked leaves (a leading None for the layer axis) against each of the
    port's layers."""
    ref_cfg = (ref_get_smoke if size == "smoke" else ref_get_config)(arch)
    cfg = (get_smoke_config if size == "smoke" else get_config)(arch)
    rm = ref_build(ref_cfg)
    held = {}

    def init(k):
        p, held["specs"] = rm.init(k)
        return p

    rshapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    with FakeTensorMode():
        model = build_model(cfg, device="cpu")
        shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    specs = model.specs
    assert set(specs) == set(shapes)
    for mesh_name, (sizes, names) in MESHES.items():
        rmesh = ref_sl.abstract_mesh(sizes, names)
        mesh = dict(zip(names, sizes))
        rsh = ref_sl.param_shardings(held["specs"], rshapes, rmesh)
        sh = sl.param_shardings(specs, shapes, mesh)
        n = 0
        for k, s in sh.items():
            path, layer = reference_path(k)
            want = rsh
            for p in path:
                want = want[p]
            want = tuple(want.spec)
            if layer is not None:
                assert want[0] is None, k
                want = want[1:]
            assert s.spec == want, (mesh_name, k, s.spec, want)
            # and the single-spec function agrees on the same leaf
            assert sl.logical_to_spec(specs[k], shape=shapes[k],
                                      mesh=mesh) == want
            n += 1
        assert n == len(shapes)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_activation_and_batch_specs_equal_reference(mesh_name):
    sizes, names = MESHES[mesh_name]
    rmesh = ref_sl.abstract_mesh(sizes, names)
    mesh = dict(zip(names, sizes))
    shapes = [(32, 128, 8, 4, 64), (32, 128, 1, 16, 64), (3, 128, 2, 3, 64),
              (32, 128, 16, 64), (32, 128, 5, 64), (32, 128, 4096),
              (5, 128, 4096), (32, 96, 100), (64, 4096), (8, 40, 1408),
              (8, 48, 4096), (32, 16, 8192, 16), (32, 8192, 16),
              (7, 10, 12)]
    fns = ("qkv_spec", "heads_concat_spec", "residual_spec",
           "seq_parallel_spec", "moe_buffer_spec", "moe_hidden_spec",
           "moe_out_spec", "ssm_state_spec")
    for name in fns:
        for shape in shapes:
            try:
                want = getattr(ref_sl, name)(rmesh, shape)
            except IndexError:
                continue
            assert getattr(sl, name)(mesh, shape) == tuple(want), (name,
                                                                   shape)
    assert sl.batch_axes(mesh) == ref_sl.batch_axes(rmesh)
    assert sl.batch_spec(mesh) == tuple(ref_sl.batch_spec(rmesh))
    assert sl.batch_sharding(mesh).spec == tuple(
        ref_sl.batch_sharding(rmesh).spec)


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "paligemma-3b",
                                  "zamba2-1.2b", "falcon-mamba-7b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("batch", [1, 32])
def test_cache_specs_equal_reference(arch, batch):
    ref_cfg, cfg = ref_get_smoke(arch), get_smoke_config(arch)
    rm = ref_build(ref_cfg)
    rcache = jax.eval_shape(lambda: rm.init_cache(batch, 64))
    cache = build_model(cfg, device="cpu").init_cache(batch, 64)
    if cfg.family == "encdec":       # the cache prefill fills in
        rcache = rcache._replace(enc_out=jax.ShapeDtypeStruct(
            (batch, 12, cfg.d_model), jnp.float32))
        cache = cache._replace(enc_out=torch.zeros(batch, 12, cfg.d_model))
    for mesh_name, (sizes, names) in MESHES.items():
        rmesh = ref_sl.abstract_mesh(sizes, names)
        want = ref_sl.cache_shardings(rmesh, rcache, ref_cfg)
        got = sl.cache_shardings(dict(zip(names, sizes)), cache, cfg)
        for f in cache._fields:
            w, g = getattr(want, f), getattr(got, f)
            assert (w is None) == (g is None), f
            if g is not None:
                assert g.spec == tuple(w.spec), (mesh_name, f)
