"""The port's sharded serving against the reference's own: the
reference's ``prefill`` and ``decode_step`` jitted with ``cache_shardings``
as their ``out_shardings`` (GSPMD over 4 forced host devices, a (2, 2)
("data", "model") mesh, as ``repro.launch.dryrun`` lowers them) against the
port's ``make_prefill_step`` / ``make_serve_step`` on a (2, 2) gloo mesh of
4 rank processes, from the reference's initial weights.  One architecture
for each cache layout: granite-34b (1 kv head: the positions over "model")
and granite-moe-3b-a800m (kv heads over "model", MoE).  Greedy decoding on
the gathered logits; logits rtol 1e-5, with 1e-5 of the largest |logit|
as the floor for entries near 0 (XLA's and torch's f32 sums differ there:
granite-moe's step-3 logits come 1.1e-6 of the largest apart at one entry
of 1,024), the greedy tokens equal.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_sharded_train import SRC, run_ranks

STEPS = 3
MAX_LEN = 24

_REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.distributed import sharding as shard_lib
from repro.launch.mesh import make_mesh
from repro.models.model import build_model

arch, where, steps, max_len = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    int(sys.argv[4])
cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
model = build_model(cfg, q_chunk=64, ssm_chunk=8)
params, specs = model.init(jax.random.PRNGKey(0))
flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
np.savez(where + "/ref_init.npz", **flat)
tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16))
np.save(where + "/tokens.npy", tokens)
mesh = make_mesh((2, 2), ("data", "model"))
p_sh = shard_lib.param_shardings(specs, params, mesh)
b_sh = NamedSharding(mesh, P("data", None))
lg_sh = NamedSharding(mesh, P("data", None, "model"))
with mesh, shard_lib.activation_hints(mesh):
    def prefill(p, b):
        return model.prefill(p, b, max_len=max_len)

    cache_shape = jax.eval_shape(lambda p, b: prefill(p, b)[1], params,
                                 {"tokens": tokens})
    c_sh = shard_lib.cache_shardings(mesh, cache_shape, cfg)
    fn = jax.jit(prefill, in_shardings=(p_sh, {"tokens": b_sh}),
                 out_shardings=(lg_sh, c_sh))
    step = jax.jit(lambda p, c, t: model.decode_step(p, c, t),
                   in_shardings=(p_sh, c_sh, b_sh),
                   out_shardings=(lg_sh, c_sh))
    lg, cache = fn(params, {"tokens": jnp.asarray(tokens)})
    out = {"logits0": np.asarray(lg)}
    for i in range(steps):
        tok = jnp.argmax(lg, -1)
        lg, cache = step(params, cache, tok)
        out[f"logits{i + 1}"] = np.asarray(lg)
np.savez(where + "/ref_out.npz", **out)
"""

_PORT = r"""
import dataclasses, datetime, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import build_model, params_from_reference
from repro_torch.distributed.sharding import full_tensor
from repro_torch.train.loop import (make_prefill_step, make_serve_step,
                                    serve_params)

rank, where = int(sys.argv[1]), sys.argv[2]
arch, steps, max_len = open(where + "/arch").read().split()
dist.init_process_group(
    "gloo", store=dist.FileStore(where + "/store", 4), rank=rank,
    world_size=4, timeout=datetime.timedelta(seconds=120))
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
model = build_model(cfg, device="cpu", q_chunk=64, ssm_chunk=8)
tree = {}
for k, v in np.load(where + "/ref_init.npz").items():
    node = tree
    *path, leaf = k.split("/")
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = v
model.load_state_dict(params_from_reference(cfg, tree))
params = serve_params(model, mesh)
prefill = make_prefill_step(model, mesh, max_len=int(max_len))
step = make_serve_step(model, mesh)
lg, cache = prefill(params, {"tokens": np.load(where + "/tokens.npy")})
lg = full_tensor(lg, mesh)
out = {"logits0": lg.numpy()}
for i in range(int(steps)):
    lg, cache = step(params, cache, lg.argmax(-1))
    lg = full_tensor(lg, mesh)
    out[f"logits{i + 1}"] = lg.numpy()
if rank == 0:
    np.savez(where + "/port_out.npz", **out)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("arch", ["granite-34b", "granite-moe-3b-a800m"])
def test_sharded_serving_against_reference_gspmd(arch, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF, arch, str(tmp_path),
                        str(STEPS), str(MAX_LEN)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    (tmp_path / "arch").write_text(f"{arch} {STEPS} {MAX_LEN}")
    run_ranks(_PORT, tmp_path)
    want = dict(np.load(tmp_path / "ref_out.npz"))
    got = dict(np.load(tmp_path / "port_out.npz"))
    assert set(got) == set(want) == {f"logits{i}" for i in range(STEPS + 1)}
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)
        np.testing.assert_array_equal(got[k].argmax(-1), w.argmax(-1))
