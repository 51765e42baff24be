"""The port's roofline twin (``repro_torch.roofline``): the dispatch-trace
counter against exact counts (the twins of
``tests/test_sharding_roofline.py``'s loop and collective tests), and the
per-device dot FLOPs of the ten smoke configs' sharded train steps on a
(2, 2) mesh against the reference's ``hlo_parse`` of its own compiled
sharded step (within 15%: the two programs split some small projections
differently, e.g. Mamba-2's B / C columns, which every "model" rank of the
port projects whole).

The MoE configs are held against the reference's program that splits the
expert work as the port does.  The port's ``moe_dispatch_hint`` (on by
default) splits the capacity slots over "data" and the experts over
"model": 1/4 of the expert products a device.  XLA does that with the
reference's hint off; with it on, GSPMD keeps each expert's whole capacity
on every "data" rank for part of the products (0.375 of them a device), so
the reference counts 21-26% more there.  The test holds the port within
15% of the hint-off program and at most the hint-on one."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import fake_mesh, lower_cell
from repro_torch.roofline import analysis
from repro_torch.roofline.trace_count import LiveBytes, TraceCount

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
SHAPE = ShapeConfig("t", 64, 8, "train")
MODEL_KW = {"q_chunk": 64, "ssm_chunk": 8, "seq_parallel": False,
            "moe_dispatch_hint": True}
FLOPS_RTOL = 0.15


def test_trace_count_loop():
    a = torch.randn(128, 128)
    with TraceCount() as tc:
        c = a
        for _ in range(10):
            c = c @ a
    assert tc.flops == 10 * 2 * 128 ** 3


def test_trace_count_nested_loops():
    a = torch.randn(64, 64)
    with TraceCount() as tc:
        c = a
        for _ in range(3):
            for _ in range(5):
                c = c @ a
    assert tc.flops == 15 * 2 * 64 ** 3


def test_trace_count_batched_and_backward():
    """bmm / addmm and the backward's products count as well."""
    a = torch.randn(4, 8, 16, requires_grad=True)
    b = torch.randn(4, 16, 32)
    w = torch.randn(32, 8, requires_grad=True)
    with TraceCount() as tc:
        y = torch.addmm(torch.zeros(8), torch.bmm(a, b).reshape(-1, 32), w)
        y.sum().backward()
    fwd = 2 * 4 * 8 * 16 * 32 + 2 * 32 * 32 * 8
    # d(bmm)/da, d(addmm)/dw, d(addmm)/d(bmm out); b takes no gradient
    bwd = 2 * 4 * 8 * 32 * 16 + 2 * 32 * 32 * 8 + 2 * 32 * 8 * 32
    assert tc.flops == fwd + bwd


def test_collective_bytes():
    """Each collective's output bytes on the rank, by kind, on a fake
    process group: an all-gather to f32[8,128], an all-reduce of
    bf16[64] (its tensors come in a list), a reduce-scatter to f32[4,4]."""
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        gd, gm = mesh.get_group("data"), mesh.get_group("model")
        with TraceCount() as tc:
            out = torch.empty(8, 128)
            dist.all_gather_into_tensor(out, torch.empty(4, 128), group=gd)
            dist.all_reduce(torch.empty(64, dtype=torch.bfloat16), group=gm)
            dist.reduce_scatter_tensor(torch.empty(4, 4),
                                       torch.empty(16, 4), group=gm)
    assert tc.coll_by_kind == {"all-gather": 8 * 128 * 4,
                               "all-reduce": 64 * 2,
                               "reduce-scatter": 16 * 4}
    assert tc.coll_bytes == 8 * 128 * 4 + 64 * 2 + 16 * 4
    assert tc.coll_calls == {"all-gather": 1, "all-reduce": 1,
                             "reduce-scatter": 1}


def test_live_bytes_peak():
    """The peak counts a storage once whatever its views, frees it with its
    last view, and leaves out what was excluded."""
    keep = torch.empty(1000)
    with LiveBytes() as lb:
        lb.exclude([keep])
        keep.mul_(2)
        a = torch.empty(100)
        v = a[10:]
        del a
        b = torch.empty(50)
        del v, b
        torch.empty(10)
    assert lb.peak == 4 * 150 and lb.live == 0


def test_roofline_terms():
    class Counts:
        flops, coll_bytes = 989e12, 450e9
        coll_by_kind = {"all-reduce": 450e9}

    rl = analysis.analyze(Counts, chips=4, model_flops=2 * 989e12,
                          hbm_bytes_per_device=3.35e12 * 2)
    assert (rl.compute_s, rl.collective_s, rl.memory_s) == (1.0, 1.0, 2.0)
    assert rl.bottleneck == "memory" and rl.useful_ratio == 0.5
    rl = analysis.Roofline(8 * 989e12, 0.0, 0.0, {}, 8).finalize(989e12)
    assert rl.compute_s == 1.0 and rl.bottleneck == "compute"


_REF = r"""
import json, os, sys
import repro.launch.dryrun as D
# the module asks for 512 host devices on import; the (2, 2) mesh needs 4
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from repro.configs import ARCH_IDS, get_smoke_config
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_mesh

D.get_config = get_smoke_config
mesh = make_mesh((2, 2), ("data", "model"))
kw = json.loads(sys.argv[1])
out = {}
for arch in ARCH_IDS:
    hints = (True, False) if get_smoke_config(arch).family == "moe" else (
        True,)
    for hint in hints:
        rec = D.lower_cell(arch, ShapeConfig("t", 64, 8, "train"), mesh,
                           model_kw=dict(kw, moe_dispatch_hint=hint),
                           microbatches=2)
        out[f"{arch}|{hint}"] = rec["roofline"]["flops"]
print("FLOPS" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_flops():
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF, json.dumps(MODEL_KW)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("FLOPS")][-1]
    return json.loads(line[len("FLOPS"):])


@pytest.fixture(scope="module")
def port_cells():
    out = {}
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        for arch in ARCH_IDS:
            out[arch] = lower_cell(arch, SHAPE, mesh, model_kw=dict(MODEL_KW),
                                   microbatches=2,
                                   cfg=get_smoke_config(arch))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_device_flops_against_reference(arch, reference_flops,
                                            port_cells):
    rec = port_cells[arch]
    assert rec["status"] == "ok"
    got = rec["roofline"]["flops"]
    if get_smoke_config(arch).family == "moe":
        assert got <= reference_flops[f"{arch}|True"]
        want = reference_flops[f"{arch}|False"]
    else:
        want = reference_flops[f"{arch}|True"]
    assert abs(got - want) <= FLOPS_RTOL * want, (arch, got, want,
                                                  got / want)
    # a (2, 2) step splits its work: collectives of every FSDP / TP kind
    assert rec["roofline"]["coll_breakdown"]["all-gather"] > 0
    assert rec["roofline"]["coll_breakdown"]["reduce-scatter"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
