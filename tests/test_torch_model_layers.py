"""The port's model-zoo configs, layers and SSM blocks
(``repro_torch.configs``, ``repro_torch.models.layers`` / ``ssm``) against
the JAX reference on the CPU: the same numpy inputs and the reference's own
weights through both.

Bars: f32 rtol/atol 1e-4 (the selective scan too: the port scans a chunk
step by step where the reference runs an associative scan, which
reassociates f32 products and sums); bf16 5e-2; MoE routing (experts,
``keep``, ``dest``) exact in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import port_model
from repro import configs as R
from repro.models import layers as RL
from repro.models import ssm as RS
from repro.models.model import build_model as ref_build
from repro_torch import configs as P
from repro_torch.models import layers as PL
from repro_torch.models import ssm as PS

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)

# the reference jitted: one compile a shape, not one an op
ref_attention = jax.jit(RL.attention, static_argnames=(
    "cfg", "q_chunk", "prefix_len", "attend_cache"))
ref_moe = jax.jit(RL.moe, static_argnames=("cfg", "capacity_factor",
                                           "dispatch_hint"))


def _np(a):
    return np.asarray(np.asarray(a).astype(np.float32)) \
        if np.asarray(a).dtype.name == "bfloat16" else np.asarray(a)


def _t(a):
    """A reference array (or a pytree dict of them) as torch tensors."""
    if isinstance(a, dict):
        return {k: _t(v) for k, v in a.items()}
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               _np(want).astype(np.float32), **tol)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    assert P.ARCH_IDS == R.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in P.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in R.SHAPES.items()}
    assert (P.BLOCK_ATTN, P.BLOCK_MAMBA1, P.BLOCK_MAMBA2,
            P.BLOCK_SHARED_ATTN) == ("attn", "mamba1", "mamba2", "shared_attn")
    with pytest.raises(KeyError):
        P.get_config("no-such-arch")


@pytest.mark.parametrize("arch", R.ARCH_IDS)
def test_configs_match_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        got, want = getattr(P, get)(arch), getattr(R, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), get
        assert got.to_json() == want.to_json()
        assert P.ModelConfig.from_json(want.to_json()) == got
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert got.block_pattern() == want.block_pattern()
        assert (got.resolved_head_dim, got.attention_free,
                got.subquadratic) == (want.resolved_head_dim,
                                      want.attention_free, want.subquadratic)
    cells = [(dataclasses.asdict(s), ok, why)
             for s, ok, why in P.shape_cells(arch)]
    assert cells == [(dataclasses.asdict(s), ok, why)
                     for s, ok, why in R.shape_cells(arch)]


# ---------------------------------------------------------------------------
# norm / rope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    want = RL.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w), 1e-5)
    got = PL.rms_norm(_t(jnp.asarray(x, dtype)), torch.from_numpy(w), 1e-5)
    assert got.dtype == PL.torch_dtype(dtype)
    _close(got, want, F32 if dtype == "float32" else BF16)


def test_rope_rotates_halves():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7))
    want = RL.rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 10000.0)
    got = PL.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    _close(got, want, F32)
    # position 0 is the identity; the interleaved-pair form would differ
    z = PL.rope(torch.from_numpy(x), torch.zeros((2, 7), dtype=torch.long),
                10000.0)
    np.testing.assert_allclose(z.numpy(), x, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (arch, overrides, prefix_len)
    "mha": ("stablelm-1.6b", {}, 0),
    "gqa": ("mistral-nemo-12b", {}, 0),
    "mqa": ("granite-34b", {}, 0),
    "swa": ("mixtral-8x22b", {"sliding_window": 5}, 0),
    "prefix_softcap": ("paligemma-3b", {}, 6),
}


def _attn_setup(case, seed=0):
    arch, over, prefix = ATTN_CASES[case]
    cfg = dataclasses.replace(_f32(R.get_smoke_config(arch)), **over)
    p, _ = RL.init_attention(jax.random.PRNGKey(seed), cfg)
    if cfg.logit_softcap:
        # large logits, so the soft cap bites
        p = dict(p, wq=p["wq"] * 8.0)
    return cfg, p, prefix


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_no_cache(case):
    cfg, p, prefix = _attn_setup(case)
    rng = np.random.default_rng(2)
    b, s = 2, 16
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s))
    want, _ = ref_attention(p, jnp.asarray(x), cfg, jnp.asarray(pos),
                           q_chunk=8, prefix_len=prefix)
    got, cache = PL.attention(_t(p), torch.from_numpy(x), cfg,
                              torch.from_numpy(pos.copy()), q_chunk=8,
                              prefix_len=prefix)
    assert cache is None
    _close(got, want, F32)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_with_cache(case):
    """Prefill 10 into a 16-slot cache, then three one-token steps over the
    cache: outputs and caches after each."""
    cfg, p, prefix = _attn_setup(case, seed=1)
    rng = np.random.default_rng(3)
    b, s0, cap = 2, 10, 16
    hd, nkv = cfg.resolved_head_dim, cfg.num_kv_heads
    ck = np.zeros((b, cap, nkv, hd), np.float32)
    rc = (jnp.asarray(ck), jnp.asarray(ck))
    pc = (torch.from_numpy(ck.copy()), torch.from_numpy(ck.copy()))
    length = 0
    for s in (s0, 1, 1, 1):
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(length, length + s), (b, s)).copy()
        want, rc = ref_attention(p, jnp.asarray(x), cfg, jnp.asarray(pos), rc,
                                jnp.int32(length), prefix_len=prefix)
        got, pc = PL.attention(_t(p), torch.from_numpy(x), cfg,
                               torch.from_numpy(pos), pc, length,
                               prefix_len=prefix)
        _close(got, want, F32)
        _close(pc[0], rc[0], F32)
        _close(pc[1], rc[1], F32)
        length += s


def test_attention_ring_wrap_and_chunked_segments():
    """A sliding window of 4 in an 8-slot ring: 8-token segments over the
    cache (``attend_cache``), then single steps well past the wrap."""
    cfg, p, _ = _attn_setup("swa", seed=2)
    cfg = dataclasses.replace(cfg, sliding_window=4)
    rng = np.random.default_rng(4)
    b, cap = 2, 8
    hd, nkv = cfg.resolved_head_dim, cfg.num_kv_heads
    ck = np.zeros((b, cap, nkv, hd), np.float32)
    rc = (jnp.asarray(ck), jnp.asarray(ck))
    pc = (torch.from_numpy(ck.copy()), torch.from_numpy(ck.copy()))
    length = 0
    for s in (4, 4, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 4):
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(length, length + s), (b, s)).copy()
        want, rc = ref_attention(p, jnp.asarray(x), cfg, jnp.asarray(pos), rc,
                                jnp.int32(length), attend_cache=True)
        got, pc = PL.attention(_t(p), torch.from_numpy(x), cfg,
                               torch.from_numpy(pos), pc, length,
                               attend_cache=True)
        _close(got, want, F32)
        _close(pc[0], rc[0], F32)
        length += s
    assert length > 2 * cap


def test_attention_prefill_longer_than_cache_raises():
    cfg, p, _ = _attn_setup("gqa")
    x = torch.zeros((1, 9, cfg.d_model))
    kv = torch.zeros((1, 8, cfg.num_kv_heads, cfg.resolved_head_dim))
    with pytest.raises(ValueError, match="exceeds non-ring cache"):
        PL.attention(_t(p), x, cfg, torch.arange(9)[None], (kv, kv), 0)


def test_attention_leaves_callers_cache():
    cfg, p, _ = _attn_setup("mqa")
    kv = torch.randn((2, 8, cfg.num_kv_heads, cfg.resolved_head_dim))
    before = kv.clone()
    _, (nk, nv) = PL.attention(_t(p), torch.randn((2, 1, cfg.d_model)), cfg,
                               torch.full((2, 1), 3), (kv, kv), 3)
    assert torch.equal(kv, before)
    assert not torch.equal(nk, before)


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-34b"])
def test_mlp(arch):
    cfg = _f32(R.get_smoke_config(arch))
    p, _ = RL.init_mlp(jax.random.PRNGKey(0), cfg)
    x = np.random.default_rng(5).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    _close(PL.mlp(_t(p), torch.from_numpy(x)), RL.mlp(p, jnp.asarray(x)), F32)


def test_gelu_mlp_is_the_tanh_form():
    """With an identity output matrix the MLP is gelu itself: the tanh form
    matches the reference to 1e-6, the erf form (PyTorch's default) is off
    by more than the f32 bar."""
    cfg = dataclasses.replace(_f32(R.get_smoke_config("granite-34b")),
                              d_ff=64)
    d = cfg.d_model
    x = np.linspace(-4, 4, 2 * 3 * d, dtype=np.float32).reshape(2, 3, d)
    p = {"wi_up": jnp.eye(d), "wo": jnp.eye(d)}
    want = np.asarray(RL.mlp(p, jnp.asarray(x)))
    got = PL.mlp(_t(p), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


def _ref_route(p, x, cfg, cf):
    """The reference ``moe``'s routing (layers.py:304-315), step for step."""
    t = x.shape[0] * x.shape[1]
    e, kk = cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(t, -1)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], axis=-1)
    _, gate_idx = jax.lax.top_k(probs, kk)
    cap = max(int(np.ceil(t * kk / e * cf)), 4)
    flat_idx = gate_idx.reshape(-1)
    oh = jax.nn.one_hot(flat_idx, e, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, axis=0) - oh,
                              flat_idx[:, None], 1)[:, 0]
    keep = pos < cap
    return (np.asarray(gate_idx), cap, np.asarray(keep),
            np.asarray(jnp.where(keep, flat_idx * cap + pos, e * cap)))


@pytest.mark.parametrize("cf,drops", [(1.25, True), (50.0, False)])
@pytest.mark.parametrize("tie", [False, True])
def test_moe_matches_reference(cf, drops, tie):
    cfg = _f32(R.get_smoke_config("granite-moe-3b-a800m"))
    p, _ = RL.init_moe(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    if tie:
        # every expert equally likely: top-k takes experts 0..k-1, in order,
        # and the capacity drops the later tokens
        p = dict(p, router=jnp.zeros_like(p["router"]))
    else:
        # lean the tokens towards expert 0, so that it overflows
        x = x + 2.0 * np.asarray(p["router"])[:, 0] / np.linalg.norm(
            np.asarray(p["router"])[:, 0])
    gate_idx, cap, keep, dest = _ref_route(p, jnp.asarray(x), cfg, cf)
    r = PL.moe_route(_t(p), torch.from_numpy(x).reshape(32, -1), cfg, cf)
    assert r["cap"] == cap
    np.testing.assert_array_equal(r["gate_idx"].numpy(), gate_idx)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    np.testing.assert_array_equal(r["dest"].numpy(), dest)
    assert bool((~keep).any()) == drops
    if tie:
        assert (gate_idx == np.arange(cfg.experts_per_token)).all()
    want, want_aux = ref_moe(p, jnp.asarray(x), cfg, cf)
    got, got_aux = PL.moe(_t(p), torch.from_numpy(x), cfg, cf)
    _close(got, want, F32)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)


def test_moe_bf16():
    cfg = R.get_smoke_config("mixtral-8x22b")
    p, _ = RL.init_moe(jax.random.PRNGKey(1), cfg)
    x = np.random.default_rng(7).standard_normal((2, 8, cfg.d_model))
    xb = jnp.asarray(x, jnp.bfloat16)
    want, _ = ref_moe(p, xb, cfg)
    got, _ = PL.moe(_t(p), _t(xb), cfg)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16)


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 12, 5])
def test_selective_scan(chunk):
    """chunk < S (3 chunks), chunk = S, and S not a multiple of chunk."""
    rng = np.random.default_rng(8)
    b, s, di, ds = 2, 12, 16, 4
    dt_ = np.abs(rng.standard_normal((b, s, di))).astype(np.float32) * 0.3
    a = -np.exp(rng.standard_normal((di, ds))).astype(np.float32)
    xi, bi, ci = (rng.standard_normal(sh).astype(np.float32)
                  for sh in ((b, s, di), (b, s, ds), (b, s, ds)))
    h0 = rng.standard_normal((b, di, ds)).astype(np.float32)
    args = (dt_, a, xi, bi, ci, h0)
    want_y, want_h = RS.selective_scan(*map(jnp.asarray, args), chunk)
    got_y, got_h = PS.selective_scan(*map(torch.from_numpy, args), chunk)
    _close(got_y, want_y, F32)
    _close(got_h, want_h, F32)


@pytest.mark.parametrize("kind", ["mamba", "mamba2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_blocks_zero_and_carried_state(kind, dtype):
    """12 tokens from zero state, then 4 more from the carried state (and
    one decode step): outputs and both parts of the state."""
    arch = "falcon-mamba-7b" if kind == "mamba" else "zamba2-1.2b"
    cfg = dataclasses.replace(R.get_smoke_config(arch), dtype=dtype)
    init, fn = {"mamba": (RS.init_mamba, RS.mamba),
                "mamba2": (RS.init_mamba2, RS.mamba2)}[kind]
    fn = jax.jit(fn, static_argnames=("cfg", "chunk"))
    pfn = getattr(PS, kind)
    p, _ = init(jax.random.PRNGKey(0), cfg)
    if kind == "mamba2":      # a non-trivial decay, skip and norm
        rng0 = np.random.default_rng(0)
        p = dict(p, **{k: jnp.asarray(rng0.standard_normal(p[k].shape) * 0.5,
                                      jnp.float32)
                       for k in ("dt_bias", "a_log", "d_skip", "norm_w")})
    tol = F32 if dtype == "float32" else BF16
    rng = np.random.default_rng(9)
    rst = pst = None
    for s in (12, 4, 1):
        x = jnp.asarray(rng.standard_normal((2, s, cfg.d_model)), dtype)
        want, rst = fn(p, x, cfg, state=rst, chunk=4)
        got, pst = pfn(_t(p), _t(x), cfg, state=pst, chunk=4)
        _close(got, want, tol)
        _close(pst[0], rst[0], tol)
        _close(pst[1], rst[1], tol)


def test_init_shapes_and_dtypes_match_reference():
    """Every ``init_*`` gives the reference's keys, shapes, dtypes, specs and
    scales (the std of each drawn matrix within 10% of the reference's);
    mamba's numpy-drawn dt_bias and the constant vectors are equal."""
    g = torch.Generator().manual_seed(0)
    cases = [(RL.init_attention, PL.init_attention, "paligemma-3b"),
             (RL.init_mlp, PL.init_mlp, "granite-34b"),
             (RL.init_mlp, PL.init_mlp, "stablelm-1.6b"),
             (RL.init_moe, PL.init_moe, "mixtral-8x22b"),
             (RS.init_mamba, PS.init_mamba, "falcon-mamba-7b"),
             (RS.init_mamba2, PS.init_mamba2, "zamba2-1.2b")]
    for rinit, pinit, arch in cases:
        cfg = R.get_smoke_config(arch)
        rp, rs = rinit(jax.random.PRNGKey(0), cfg)
        pp, ps = pinit(g, cfg)
        assert ps == rs, arch
        assert set(pp) == set(rp), arch
        for k in rp:
            assert tuple(pp[k].shape) == rp[k].shape, (arch, k)
            assert str(pp[k].dtype).split(".")[-1] == str(rp[k].dtype), \
                (arch, k)
            want = _np(rp[k]).astype(np.float32)
            if k in ("dt_bias", "a_log", "d_skip", "norm_w"):
                np.testing.assert_allclose(pp[k].numpy(), want, rtol=1e-6,
                                           err_msg=f"{arch} {k}")
            else:
                np.testing.assert_allclose(float(pp[k].float().std()),
                                           float(want.std()), rtol=0.1,
                                           err_msg=f"{arch} {k}")


def test_attention_fully_masked_row_is_uniform():
    """A query placed before every cached key sees none of them: the -1e30
    fill (not -inf) gives it the uniform average of the values, as in the
    reference, where -inf would give NaN."""
    cfg, p, _ = _attn_setup("gqa", seed=3)
    rng = np.random.default_rng(10)
    b, cap = 2, 8
    kv = rng.standard_normal((b, cap, cfg.num_kv_heads,
                              cfg.resolved_head_dim)).astype(np.float32)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    pos = np.full((b, 1), -1)
    want, _ = ref_attention(p, jnp.asarray(x), cfg, jnp.asarray(pos),
                           (jnp.asarray(kv), jnp.asarray(kv)), jnp.int32(3))
    got, _ = PL.attention(_t(p), torch.from_numpy(x), cfg,
                          torch.from_numpy(pos), (torch.from_numpy(kv),
                                                  torch.from_numpy(kv)), 3)
    assert np.isfinite(got.numpy()).all()
    _close(got, want, F32)


@pytest.mark.parametrize("case", ["gqa", "prefix_softcap"])
def test_attention_bf16(case):
    cfg, p, prefix = _attn_setup(case, seed=4)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    p = {k: v.astype(jnp.bfloat16) for k, v in p.items()}
    x = jnp.asarray(np.random.default_rng(11).standard_normal(
        (2, 12, cfg.d_model)), jnp.bfloat16)
    pos = np.broadcast_to(np.arange(12), (2, 12)).copy()
    want, _ = ref_attention(p, x, cfg, jnp.asarray(pos), prefix_len=prefix)
    got, _ = PL.attention(_t(p), _t(x), cfg, torch.from_numpy(pos),
                          prefix_len=prefix)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16)


@pytest.mark.parametrize("arch", R.ARCH_IDS)
def test_weights_carried_across_exactly(arch):
    """``port_model`` holds the reference's ``model.init`` weights: every
    leaf of the reference pytree, layer i of a stacked group at
    ``<group>.<i>.<path>``, equal bit for bit, and nothing else."""
    cfg = R.get_smoke_config(arch)
    rm = ref_build(cfg)
    rp = jax.jit(lambda k: rm.init(k)[0])(jax.random.PRNGKey(0))
    sd = port_model(cfg, rp).state_dict()
    seen = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(rp):
        keys = [k.key for k in path]
        names = ([".".join(keys)] if keys[0] not in (
            "blocks", "enc_blocks", "cross_blocks") else
            [".".join([keys[0], str(i), *keys[1:]])
             for i in range(leaf.shape[0])])
        parts = [leaf] if len(names) == 1 else list(leaf)
        for name, part in zip(names, parts):
            np.testing.assert_array_equal(
                sd[name].float().numpy(), _np(part).astype(np.float32),
                err_msg=name)
            seen.add(name)
    assert seen == set(sd)
