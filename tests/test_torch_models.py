"""The port's model zoo (``repro_torch.models.model``) against the JAX
reference on the CPU, every architecture at its smoke config: the
reference's ``model.init`` weights carried across by
``params_from_reference`` (``tests/_torch_port.port_model``), the same
numpy batch through both.

Bars: f32 rtol/atol 1e-4 for logits, the loss and every cache tensor (the
SSM and hybrid families 1e-3: the port's step-by-step scan against the
reference's associative one); bf16 5e-2, the reference's own chunked-prefill
bar (tests/test_models.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import port_model
from repro.configs import ARCH_IDS, get_smoke_config
from repro.models.model import build_model as ref_build

B, S, STEPS = 2, 12, 3


def _tol(cfg):
    if cfg.dtype == "bfloat16":
        # zamba2-smoke's bf16 logits differ from the reference's by up to
        # 0.125 (prefill and 3 steps), where the reference's own bf16 logits
        # are 0.145 from its f32 ones on the same weights and the port's
        # 0.060 (PERF.md): bf16 rounding, which the 3 mamba2 and 2 shared
        # attention layers compound
        if cfg.family == "hybrid":
            return dict(rtol=5e-2, atol=1.5e-1)
        return dict(rtol=5e-2, atol=5e-2)
    if cfg.family in ("ssm", "hybrid"):
        return dict(rtol=1e-3, atol=1e-3)
    return dict(rtol=1e-4, atol=1e-4)


def _f(a):
    """A torch tensor or reference array as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _batch(cfg, rng, b=B, s=S):
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        batch["frontend"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frontend"] = rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
    return batch


def _ref(batch):
    return {k: jnp.asarray(v, jnp.int32 if k in ("tokens", "labels")
                           else jnp.float32) for k, v in batch.items()}


def _port(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _caches(cache):
    return [c for c in cache[:5] if c is not None]


class _Served:
    """The checks of one architecture served by both packages, in the
    dtype ``DTYPE`` (one subclass a dtype, one file each, so that each
    file stays near a minute)."""

    DTYPE = None

    @pytest.fixture(scope="class", params=ARCH_IDS)
    def served(self, request):
        """Both models on one batch: the loss, then prefill and STEPS decode
        steps (logits and caches after each)."""
        cfg = dataclasses.replace(get_smoke_config(request.param),
                                  dtype=self.DTYPE)
        kw = dict(q_chunk=64, ssm_chunk=8)
        rm = ref_build(cfg, **kw)
        rp = jax.jit(lambda k: rm.init(k)[0])(jax.random.PRNGKey(0))
        pm = port_model(cfg, rp, **kw)
        rng = np.random.default_rng(1)
        batch = _batch(cfg, rng)
        steps = rng.integers(0, cfg.vocab_size, (STEPS, B, 1))
        max_len = S + 8 + cfg.frontend_tokens
        out = {"cfg": cfg, "rp": rp, "pm": pm, "batch": batch,
               "steps": steps, "ref": {}, "port": {}}
        prompt = {k: v for k, v in batch.items() if k != "labels"}
        # the reference jitted: one compile a function, not one a call
        ref_fns = (jax.jit(rm.loss),
                   jax.jit(rm.prefill, static_argnames="max_len"),
                   jax.jit(rm.decode_step))
        for side, (loss, prefill, decode), conv, args in (
                ("ref", ref_fns, _ref, (rp,)),
                ("port", (pm.loss, pm.prefill, pm.decode_step), _port, ())):
            rec = out[side]
            rec["loss"] = loss(*args, conv(batch))
            lg, cache = prefill(*args, conv(prompt), max_len=max_len)
            rec["logits"], rec["caches"] = [lg], [cache]
            for t in steps:
                tok = jnp.asarray(t, jnp.int32) if side == "ref" \
                    else torch.from_numpy(t)
                lg, cache = decode(*args, cache, tok)
                rec["logits"].append(lg)
                rec["caches"].append(cache)
        return out

    def test_param_count_equals_reference_leaves(self, served):
        n_ref = sum(x.size for x in jax.tree_util.tree_leaves(served["rp"]))
        assert sum(p.numel() for p in served["pm"].parameters()) == n_ref
        # the analytic count is the reference's, which leaves out ln_f,
        # frontend_proj and the SSM vectors
        assert served["cfg"].param_count() <= n_ref

    def test_loss_matches_reference(self, served):
        (rl, rmet), (pl, pmet) = served["ref"]["loss"], served["port"]["loss"]
        tol = _tol(served["cfg"])
        np.testing.assert_allclose(_f(pl), _f(rl), **tol)
        np.testing.assert_allclose(_f(pmet["nll"]), _f(rmet["nll"]), **tol)
        np.testing.assert_allclose(_f(pmet["aux"]), _f(rmet["aux"]), **tol)

    def test_prefill_and_decode_match_reference(self, served):
        """Logits and every cache tensor after the prefill and each decode
        step; the cache's length counts the prompt (and the prefix)."""
        tol = _tol(served["cfg"])
        ref, port = served["ref"], served["port"]
        for i, (rl, pl) in enumerate(zip(ref["logits"], port["logits"])):
            assert tuple(pl.shape) == rl.shape
            np.testing.assert_allclose(_f(pl), _f(rl), **tol,
                                       err_msg=f"logits after step {i}")
        for i, (rc, pc) in enumerate(zip(ref["caches"], port["caches"])):
            assert pc.length == int(rc.length)
            for name, a, b in zip(rc._fields, rc[:5], pc[:5]):
                assert (a is None) == (b is None), name
                if a is not None:
                    assert tuple(b.shape) == a.shape, name
                    np.testing.assert_allclose(
                        _f(b), _f(a), **tol, err_msg=f"{name} after step {i}")

    def test_decode_leaves_callers_cache(self, served):
        pm = served["pm"]
        cache = served["port"]["caches"][-1]
        before = [c.clone() for c in _caches(cache)]
        pm.decode_step(cache, torch.zeros((B, 1), dtype=torch.long))
        assert all(torch.equal(a, b) for a, b in zip(before, _caches(cache)))

    def test_decode_matches_teacher_forcing(self, served):
        """The port's own identity (tests/test_models.py's): decoding the last
        token after a prefill of the others gives the full forward's logits at
        that position, at a capacity that drops no MoE token."""
        cfg = served["cfg"]
        pm = served["pm"]
        pm.moe_capacity = 50.0
        try:
            batch = _port({k: v for k, v in served["batch"].items()
                           if k != "labels"})
            toks = batch["tokens"]
            if cfg.family == "encdec":
                batch["frontend"] = batch["frontend"][:, : S - 1]
                enc_out, enc_pos = pm._encode(batch["frontend"])
                x, pos, _ = pm._embed_inputs(batch)
                h, _, _ = pm._decoder_stack(x, pos, enc_out=enc_out,
                                            enc_positions=enc_pos)
            else:
                x, pos, pre = pm._embed_inputs(batch)
                h, _, _ = pm._decoder_stack(x, pos, prefix_len=pre)
            full = pm._logits(h)
            _, cache = pm.prefill(dict(batch, tokens=toks[:, : S - 1]),
                                  max_len=S + 4 + cfg.frontend_tokens)
            lg, _ = pm.decode_step(cache, toks[:, S - 1 :])
        finally:
            pm.moe_capacity = 1.25
        off = cfg.frontend_tokens if cfg.family == "vlm" else 0
        np.testing.assert_allclose(_f(lg[:, 0]), _f(full[:, S - 1 + off]),
                                   **_tol(cfg))


class TestServedF32(_Served):
    DTYPE = "float32"


CHUNKED = ["stablelm-1.6b", "mixtral-8x22b", "granite-moe-3b-a800m",
           "falcon-mamba-7b", "zamba2-1.2b"]


@pytest.mark.parametrize("arch", CHUNKED)
def test_prefill_chunked_matches_reference(arch):
    """128 tokens in segments of 32 (mixtral-smoke's window is 64, so its
    2x-window ring is full): logits, caches, and one decode step after."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    kw = dict(q_chunk=512, ssm_chunk=8, moe_capacity=50.0)
    rm = ref_build(cfg, **kw)
    rp = jax.jit(lambda k: rm.init(k)[0])(jax.random.PRNGKey(3))
    pm = port_model(cfg, rp, **kw)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, 128))
    rlg, rc = rm.prefill_chunked(rp, {"tokens": jnp.asarray(toks, jnp.int32)},
                                 seg_len=32)
    plg, pc = pm.prefill_chunked({"tokens": torch.from_numpy(toks)},
                                 seg_len=32)
    tol = _tol(cfg)
    np.testing.assert_allclose(_f(plg), _f(rlg), **tol)
    assert pc.length == int(rc.length) == 128
    for a, b in zip(rc[:4], pc[:4]):
        if a is not None:
            np.testing.assert_allclose(_f(b), _f(a), **tol)
    rlg, _ = rm.decode_step(rp, rc, jnp.asarray(toks[:, :1], jnp.int32))
    plg, _ = pm.decode_step(pc, torch.from_numpy(toks[:, :1]))
    np.testing.assert_allclose(_f(plg), _f(rlg), **tol)


def test_decode_past_the_window_ring_wraps():
    """mixtral-smoke (window 64): a 60-token prefill into a 64-slot ring,
    then 12 decode steps, the last 8 of them past the wrap; bf16, the
    config's own dtype."""
    cfg = get_smoke_config("mixtral-8x22b")
    rm = ref_build(cfg, q_chunk=64)
    rp = jax.jit(lambda k: rm.init(k)[0])(jax.random.PRNGKey(5))
    pm = port_model(cfg, rp, q_chunk=64)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (B, 60))
    rlg, rc = rm.prefill(rp, {"tokens": jnp.asarray(toks, jnp.int32)},
                         max_len=128)
    plg, pc = pm.prefill({"tokens": torch.from_numpy(toks)}, max_len=128)
    assert pc.kv_k.shape[2] == 64
    tol = _tol(cfg)
    ref_decode = jax.jit(rm.decode_step)
    for t in rng.integers(0, cfg.vocab_size, (12, B, 1)):
        rlg, rc = ref_decode(rp, rc, jnp.asarray(t, jnp.int32))
        plg, pc = pm.decode_step(pc, torch.from_numpy(t))
        np.testing.assert_allclose(_f(plg), _f(rlg), **tol)
    assert pc.length == 72
    np.testing.assert_allclose(_f(pc.kv_k), _f(rc.kv_k), **tol)


def test_specs_cover_every_parameter():
    """``init``'s logical-axis specs are keyed by the state dict's names,
    one axis name (or None) per dimension."""
    from repro_torch.configs import get_smoke_config as port_smoke
    from repro_torch.models.model import build_model

    for arch in ARCH_IDS:
        pm = build_model(port_smoke(arch), device="cpu")
        sd = pm.state_dict()
        assert set(pm.specs) == set(sd), arch
        assert all(len(pm.specs[k]) == v.dim() for k, v in sd.items()), arch


def test_entry_points_default_to_the_card():
    from repro_torch.configs import get_smoke_config as port_smoke
    from repro_torch.models.model import build_model

    if torch.cuda.is_available():
        pytest.skip("checks the default where there is no card")
    with pytest.raises(RuntimeError):
        build_model(port_smoke("stablelm-1.6b"))

