"""The checks of ``tests/test_torch_models.py``'s ``_Served`` (loss,
prefill and decode logits and caches, the caller's cache, teacher forcing,
parameter counts) for every architecture in the configs' own dtype,
bfloat16, at the bf16 bar stated there; and the measurement behind the
hybrid's looser bar.

    PYTHONPATH=src:tests python tests/test_torch_models_bf16.py

prints, for every architecture, how far apart the logits are (prefill and
three decode steps, one set of bf16 weights): port and reference in bf16,
each bf16 side against the reference in f32 on the same weights, and port
against reference in f32."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import port_model
from repro.configs import ARCH_IDS, get_smoke_config
from repro.models.model import build_model as ref_build
from test_torch_models import B, S, STEPS, _Served, _batch


class TestServedBF16(_Served):
    DTYPE = "bfloat16"


def logit_distances(arch: str) -> dict:
    """Max |difference| of the logits over prefill and STEPS decode steps:
    the port and the reference in bf16 (``port_ref``), the reference's and
    the port's bf16 against the reference in f32 on the same weights
    (``ref_ref32``, ``port_ref32``), and the two in f32 (``f32``)."""
    cfg = get_smoke_config(arch)
    kw = dict(q_chunk=64, ssm_chunk=8)
    rm = ref_build(cfg, **kw)
    rp = jax.jit(lambda k: rm.init(k)[0])(jax.random.PRNGKey(0))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rm32 = ref_build(cfg32, **kw)
    rp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), rp)
    rng = np.random.default_rng(1)
    prompt = {k: v for k, v in _batch(cfg, rng).items() if k != "labels"}
    steps = rng.integers(0, cfg.vocab_size, (STEPS, B, 1))
    max_len = S + 8 + cfg.frontend_tokens

    def ref_logits(model, params):
        lg, cache = jax.jit(model.prefill, static_argnames="max_len")(
            params, {k: jnp.asarray(v) for k, v in prompt.items()},
            max_len=max_len)
        out = [lg]
        decode = jax.jit(model.decode_step)
        for t in steps:
            lg, cache = decode(params, cache, jnp.asarray(t, jnp.int32))
            out.append(lg)
        return [np.asarray(x).astype(np.float32) for x in out]

    def port_logits(model):
        lg, cache = model.prefill(
            {k: torch.from_numpy(np.array(v)) for k, v in prompt.items()},
            max_len=max_len)
        out = [lg]
        for t in steps:
            lg, cache = model.decode_step(cache, torch.from_numpy(t))
            out.append(lg)
        return [x.float().numpy() for x in out]

    def dist(a, b):
        return float(max(np.abs(x - y).max() for x, y in zip(a, b)))

    ref16, ref32 = ref_logits(rm, rp), ref_logits(rm32, rp32)
    port16 = port_logits(port_model(cfg, rp, **kw))
    port32 = port_logits(port_model(cfg32, rp32, **kw))
    return {"port_ref": dist(port16, ref16), "ref_ref32": dist(ref16, ref32),
            "port_ref32": dist(port16, ref32), "f32": dist(port32, ref32)}


def test_hybrid_bf16_is_no_farther_from_f32_than_the_reference():
    """The hybrid's looser bf16 bar is rounding, not a fault: on the same
    weights the port's bf16 logits are no farther from the reference's f32
    logits than the reference's own bf16 logits are."""
    d = logit_distances("zamba2-1.2b")
    assert d["f32"] <= 1e-3, d
    assert d["port_ref32"] <= d["ref_ref32"], d


if __name__ == "__main__":
    for arch in ARCH_IDS:
        print(arch, json.dumps(logit_distances(arch)), flush=True)
