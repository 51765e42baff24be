"""The dry-run's SSM train cells (``repro_torch.launch.dryrun``):
``lower_cell`` traces ``train_4k`` for zamba2-1.2b and falcon-mamba-7b at
full width on a fake (2, 4) mesh, cut in depth (zamba2 to its first
six layers, so its shared attention block runs once; falcon-mamba to
two), one microbatch.  The selective scan and its backward are one op a
call each (``kernels.selective_scan``), so the trace does not step
through the 4,096 positions.  The full-depth cells on the (16, 16)
production mesh run in ``chip_smoke.py`` (PERF.md)."""
import dataclasses

import pytest

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun


@pytest.mark.parametrize("arch,layers", [("zamba2-1.2b", 6),
                                         ("falcon-mamba-7b", 2)])
def test_ssm_train_cell_cut_depth(arch, layers):
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    with dryrun.fake_mesh((2, 4), ("data", "model")) as mesh:
        rec = dryrun.lower_cell(arch, SHAPES["train_4k"], mesh,
                                microbatches=1, cfg=cfg)
    assert rec["status"] == "ok", rec
    assert rec["model_kw"]["seq_parallel"] is True
    rl = rec["roofline"]
    assert rl["flops"] > 0 and rl["coll_bytes"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
