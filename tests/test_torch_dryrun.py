"""The port's dry-run (``repro_torch.launch.dryrun``), the twin of
``tests/test_dryrun.py``: ``lower_cell`` traces a full-size train cell's
sharded step on a fake (2, 4) mesh (fake tensors: no storage) and gives a
complete record, and so the prefill and decode cells' sharded serving
steps; ``input_specs`` has the reference's shapes and dtypes for every
(arch x shape) cell; the CLI's resumable JSON and its ``long_500k`` skip.

Every serving cell is traced at full width and depth, zamba2's and
falcon-mamba's prefill_32k too: the selective scan is one op a call
(``kernels.selective_scan``), ~22 s and ~6 s on one CPU core.  The prefill
cells attend in one query
chunk (``q_chunk`` = the sequence): the trace costs ~1 ms an op, and 32
chunks a layer made granite-34b's cell ~50 s alone, ~4 min with the
suite's other workers."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.model import input_specs as ref_input_specs
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.models.model import input_specs
from repro_torch.roofline import analysis as roofline

_DTYPES = {torch.int32: jnp.int32, torch.float32: jnp.float32}


def test_lower_cell_small_mesh():
    with dryrun.fake_mesh((2, 4), ("data", "model")) as mesh:
        rec = dryrun.lower_cell("stablelm-1.6b", SHAPES["train_4k"], mesh,
                                microbatches=4)
    assert rec["status"] == "ok", rec
    assert rec["mesh"] == "2x4" and rec["chips"] == 8
    rl = rec["roofline"]
    assert rl["flops"] > 0 and rl["coll_bytes"] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < rl["useful_ratio"] < 1.5
    assert rec["memory"]["temp_size_in_bytes"] > 0
    # FSDP gathers over "data" and reduce-scatters back; TP all-reduces
    assert set(rl["coll_breakdown"]) == {"all-gather", "all-reduce",
                                         "reduce-scatter"}
    # the local state: a (2, 4) share of bf16 weights and f32 moments
    n = rec["param_count"]
    state = rec["memory"]["output_size_in_bytes"]
    assert 0.9 * n * 10 / 8 < state < 1.1 * n * 10 / 8


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch, shape):
    got = input_specs(get_config(arch), SHAPES[shape])
    want = ref_input_specs(ref_get_config(arch), SHAPES[shape])
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), (k, t.shape)
        assert _DTYPES[t.dtype] == want[k].dtype, k


SERVE_ARCHS = ("stablelm-1.6b", "granite-34b", "zamba2-1.2b",
               "falcon-mamba-7b")
REF_KEYS = {"arch", "shape", "mesh", "chips", "status", "memory",
            "roofline", "param_count", "active_param_count"}


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serving_cell(arch, shape):
    """A prefill or decode cell's sharded serving step, traced: the
    reference's keys, the decode cache's bytes over the chips in the memory
    term, and the roofline's checks of ``tests/test_dryrun.py``."""
    cfg, shp = get_config(arch), SHAPES[shape]
    kw = {"q_chunk": shp.seq_len} if shp.kind == "prefill" else {}
    with dryrun.fake_mesh((2, 4), ("data", "model")) as mesh:
        rec = dryrun.lower_cell(arch, shp, mesh, model_kw=kw)
    assert rec["status"] == "ok", rec
    assert REF_KEYS <= set(rec) and rec["trace_s"] >= 0
    assert rec["mesh"] == "2x4" and rec["chips"] == 8
    rl = rec["roofline"]
    assert rl["flops"] > 0 and rl["coll_bytes"] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < rl["useful_ratio"] < 1.5
    assert rec["memory"]["temp_size_in_bytes"] > 0
    kv = rec["kv_bytes_local"]
    sizes = {"data": 2, "model": 4}
    assert rl["hbm_bytes"] == roofline.analytic_hbm_bytes(
        cfg, shp, sizes, kv_cache_bytes=kv)
    b, s = shp.global_batch, shp.seq_len
    if shp.kind == "prefill":
        assert kv == 0
        # the cache of seq_len + 8 positions is the step's output
        assert rec["cache_bytes_local"] > 0
        return
    # every layer's K and V (and the SSM states), over the 8 chips
    n_attn = sum(blk != "mamba2" and blk != "mamba1"
                 for blk in cfg.block_pattern())
    want = 2 * n_attn * b * s * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    if cfg.family in ("hybrid", "ssm"):
        di = cfg.ssm_expand * cfg.d_model
        n_ssm = cfg.num_layers - n_attn
        conv_width = di + (2 * cfg.ssm_state if cfg.family == "hybrid" else 0)
        want += n_ssm * b * ((cfg.ssm_conv - 1) * conv_width * 2
                             + di * cfg.ssm_state * 4)
    assert kv == want / 8
    assert kv <= rec["memory"]["argument_size_in_bytes"]
    assert rec["cache_bytes_local"] * 8 >= want


def test_cell_microbatches():
    sizes = {"pod": 2, "data": 16, "model": 16}
    cfg = get_config("stablelm-1.6b")
    assert dryrun._cell_microbatches(cfg, SHAPES["train_4k"], sizes) == 8
    assert dryrun._cell_microbatches(cfg, SHAPES["train_4k"],
                                     {"data": 16, "model": 16}) == 16
    assert dryrun._cell_microbatches(cfg, SHAPES["decode_32k"], sizes) == 1


def test_cli_skips_and_resumes(tmp_path, monkeypatch, capsys):
    """``main``: a quadratic-attention arch's long_500k cell is skipped by
    design, serving cells are traced, and a second run keeps the file's
    records (``--force`` redoes them)."""
    monkeypatch.setattr(dryrun, "PRODUCTION_MESHES",
                        {False: ((2, 4), ("data", "model")),
                         True: ((2, 2, 2), ("pod", "data", "model"))})
    out = tmp_path / "dry.json"
    argv = ["--arch", "stablelm-1.6b", "--shape", "long_500k,decode_32k",
            "--mesh", "both", "--out", str(out)]
    dryrun.main(argv)
    recs = json.loads(out.read_text())
    assert set(recs) == {"stablelm-1.6b|long_500k|2x4",
                         "stablelm-1.6b|decode_32k|2x4",
                         "stablelm-1.6b|long_500k|2x2x2",
                         "stablelm-1.6b|decode_32k|2x2x2"}
    assert recs["stablelm-1.6b|long_500k|2x4"]["status"] == "skipped"
    assert recs["stablelm-1.6b|decode_32k|2x2x2"]["status"] == "ok"
    assert recs["stablelm-1.6b|decode_32k|2x4"]["status"] == "ok"
    # an "ok" record in the file is kept; others are redone
    recs["stablelm-1.6b|decode_32k|2x4"]["trace_s"] = -1.0
    out.write_text(json.dumps(recs))
    dryrun.main(argv)
    assert "[skip] stablelm-1.6b|decode_32k|2x4" in capsys.readouterr().out
    assert json.loads(out.read_text())["stablelm-1.6b|decode_32k|2x4"][
        "trace_s"] == -1.0
    dryrun.main(argv + ["--force"])
    rec = json.loads(out.read_text())["stablelm-1.6b|decode_32k|2x4"]
    assert rec["status"] == "ok" and rec["trace_s"] >= 0
