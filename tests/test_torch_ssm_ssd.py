"""The SSD kernels' plain version (``selective_scan_ssd_plain`` and
``selective_scan_ssd_bwd_plain`` in ``repro_torch.kernels.selective_scan``),
the chunked matrix form of the Mamba-2 scan that
``csrc/selective_scan_ssd.cu`` computes, on the CPU: its outputs against the
plain loop (``selective_scan_heads_plain``) and the reference's chunked
associative scan (``repro.models.ssm.selective_scan`` over the heads' dt and
a repeated as ``repro.models.ssm.mamba2`` repeats them), each within 1e-5 of
the largest |y| and |h_last|; its six gradients against the loop's autograd,
each within 1e-5 of its own largest magnitude; the same with every product's
inputs rounded to TF32 as the kernels' three-pass split takes them, and what
one TF32 pass gives; and the shape rule that sends a Mamba-2 call to the SSD
kernels or to the step kernels.  The kernels against these versions on the
card are in ``tests/test_torch_cuda.py``."""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import selective_scan as ref_selective_scan
from repro_torch.kernels import loader
from repro_torch.kernels import selective_scan as ss

B, NH, Q = 2, 4, ss.SSD_CHUNK
TOL = 1e-5          # of each output's (gradient's) largest magnitude
# S: one step, a ragged chunk, one chunk, three chunks and a ragged one;
# (head width, state width) alternating between 16 x 8 and 8 x 16
SHAPES = [(1, 16, 8), (37, 8, 16), (Q, 16, 8), (3 * Q + 5, 8, 16)]
SHAPE_IDS = ["S1", "S37", "S=Q", "S=3Q+5"]


def _inputs(seed, s, hd, ds, carried):
    """(dt, a, x, b, c, h0) as float32 numpy, drawn as zamba2's blocks make
    them: dt = softplus(N(0, 1)) a head, a = -exp(N(0, 0.5^2))."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, s, NH))))
    a = -np.exp(0.5 * rng.standard_normal(NH))
    x, b, c = (rng.standard_normal(sh) for sh in ((B, s, NH * hd), (B, s, ds),
                                                 (B, s, ds)))
    h0 = (rng.standard_normal((B, NH * hd, ds)) if carried
          else np.zeros((B, NH * hd, ds)))
    return [np.asarray(t, np.float32) for t in (dt, a, x, b, c, h0)]


def _torch(args):
    return [torch.from_numpy(t) for t in args]


def _cotangents(seed, s, hd, ds):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
            for sh in ((B, s, NH * hd), (B, NH * hd, ds))]


def _rel(got, want) -> float:
    """The largest |got - want| over the largest |want| (0 where both are
    all zeros: da with a zero state and one step)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    return err / float(np.abs(want).max()) if err else 0.0


def _ref(args):
    """The reference's scan over dt and a repeated per channel and state."""
    dt, a, x, b, c, h0 = map(jnp.asarray, args)
    hd = x.shape[-1] // NH
    dt = jnp.repeat(dt, hd, axis=-1)
    a = jnp.repeat(a, hd)[:, None] * jnp.ones((1, b.shape[-1]))
    return ref_selective_scan(dt, a, x, b, c, h0, 256)


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("s,hd,ds", SHAPES, ids=SHAPE_IDS)
def test_ssd_plain_matches_loop_and_reference(s, hd, ds, carried):
    args = _inputs(1, s, hd, ds, carried)
    got = ss.selective_scan_ssd_plain(*_torch(args))
    loop = ss.selective_scan_heads_plain(*_torch(args), 256)
    ref = _ref(args)
    for g, lp, r in zip(got, loop, ref):
        assert g.shape == lp.shape and g.dtype == torch.float32
        assert _rel(g, lp) <= TOL
        assert _rel(g, np.asarray(r)) <= TOL


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("s,hd,ds", SHAPES, ids=SHAPE_IDS)
def test_ssd_plain_gradients_match_the_loops(s, hd, ds, carried):
    """The three-pass SSD backward against the loop's autograd (the op's
    CPU backward), every gradient, both outputs' cotangents."""
    args = _inputs(2, s, hd, ds, carried)
    gy, gh = _cotangents(3, s, hd, ds)
    got = ss.selective_scan_ssd_bwd_plain(*_torch(args), gy, gh)
    want = ss.selective_scan_heads_bwd_plain(*_torch(args), gy, gh, 256)
    for name, g, w in zip(("dt", "a", "x", "b", "c", "h0"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _rel(g, w) <= TOL, (name, _rel(g, w))


def test_tf32_three_passes_hold_the_bar_one_does_not():
    """Every product's inputs rounded to TF32 (10 mantissa bits, as
    ``cvt.rna`` rounds): the kernels' three-pass split (hi.hi + hi.lo +
    lo.hi) holds 1e-5 of the loop's outputs and gradients at zamba2's head
    and state widths; one pass leaves ~5e-4 (measured 4.6e-4 .. 5.7e-4 on
    the forward), past the bar."""
    s, hd, ds = 2 * Q + 11, 64, 64
    args = _torch(_inputs(4, s, hd, ds, True))
    loop = ss.selective_scan_heads_plain(*args, 256)
    three = ss.selective_scan_ssd_plain(*args, tf32="3pass")
    one = ss.selective_scan_ssd_plain(*args, tf32="1pass")
    for g3, g1, w in zip(three, one, loop):
        assert _rel(g3, w) <= TOL
        assert 1e-4 < _rel(g1, w) < 1e-3
    gy, gh = _cotangents(5, s, hd, ds)
    want = ss.selective_scan_heads_bwd_plain(*args, gy, gh, 256)
    got = ss.selective_scan_ssd_bwd_plain(*args, gy, gh, tf32="3pass")
    for name, g, w in zip(("dt", "a", "x", "b", "c", "h0"), got, want):
        assert _rel(g, w) <= TOL, (name, _rel(g, w))


def test_tf32_rounding_is_round_to_nearest_away():
    """``_tf32`` keeps 10 mantissa bits, ties away from zero, and its
    three-pass split of a product is exact to ~2^-21."""
    v = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 3.0, 1.0 + 3 * 2.0 ** -11])
    got = ss._tf32(v).tolist()
    assert got == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0,
                   1.0 + 2 * 2.0 ** -10]
    rng = np.random.default_rng(6)
    p, q = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
            for sh in ((64, 64), (64, 64)))
    exact = p.double() @ q.double()
    assert _rel(ss._mm(p, q, "3pass"), exact) < 2e-6
    assert _rel(ss._mm(p, q, "1pass"), exact) > 1e-4
    with pytest.raises(ValueError):
        ss._mm(p, q, "2pass")


@pytest.mark.parametrize("s,hd,ds,ssd", [
    (2048, 64, 64, True), (4096, 64, 64, True), (300, 64, 64, True),
    (2, 8, 8, True), (37, 64, 16, True), (1, 64, 64, False),
    (20, 3, 5, False), (33, 32, 12, False), (9, 128, 64, False),
    (9, 64, 128, False)],
    ids=["zamba2-prefill", "zamba2-train", "ragged", "smallest", "ds16",
         "decode", "odd", "ds12", "hd128", "ds128"])
def test_ssd_route(s, hd, ds, ssd):
    """Mamba-2 calls with head and state widths multiples of 8 up to 64 and
    S > 1 take the SSD kernels; decode (S = 1) and every other width the
    step kernels."""
    assert ss.ssd_route(s, hd, ds) is ssd


@pytest.mark.parametrize("s,ssd", [
    (1, False), (2, False), (16, False), (19, False), (20, True), (37, True),
    (300, True), (4096, True)])
def test_ssd_route_backward(s, ssd):
    """The backward takes the SSD kernels from S = SSD_BWD_MIN_STEPS, where
    they overtake the step kernel (at widths the forward's SSD takes); the
    forward from S = 2."""
    assert ss.SSD_BWD_MIN_STEPS == 20
    assert ss.ssd_route(s, 64, 64, bwd=True) is ssd
    assert ss.ssd_route(s, 64, 64) is (s > 1)
    assert not ss.ssd_route(s, 64, 12, bwd=True)


def _record_launches(monkeypatch) -> list:
    """The kernels' launches recorded instead of made, with stub workspaces:
    a list of (library, C entry, counter, int arguments)."""
    calls = []
    monkeypatch.setattr(loader, "check", lambda *a, **k: None)
    monkeypatch.setattr(loader, "stream", lambda t: ctypes.c_void_p(None))
    monkeypatch.setattr(loader, "launch",
                        lambda lib, ent, counter, dev, *args: calls.append(
                            (lib, ent, counter, [a.value for a in args
                                                 if isinstance(a, ctypes.c_int)])))
    lib = type("Lib", (), {})()
    lib.selective_scan_ssd_workspace = lambda *a: 16
    lib.selective_scan_ssd_bwd_workspace = lambda *a: 16
    lib.selective_scan_bwd_workspace = lambda *a: 16
    monkeypatch.setattr(loader, "library", lambda name: lib)
    return calls


def test_short_call_runs_the_ssd_forward_and_the_step_backward(monkeypatch):
    """At S = 8 (below SSD_BWD_MIN_STEPS) the forward wrapper launches the
    SSD forward and the backward wrapper the step backward."""
    calls = _record_launches(monkeypatch)
    args = _torch(_inputs(7, 8, 8, 16, True))
    gy, gh = _cotangents(8, 8, 8, 16)
    ss.selective_scan_heads_cuda(*args)
    ss.selective_scan_heads_bwd_cuda(*args, gy, gh)
    assert [c[1:3] for c in calls] == [
        ("selective_scan_ssd_launch", "selective_scan_ssd"),
        ("selective_scan_bwd_launch", "selective_scan_bwd")]


@pytest.mark.parametrize("s,nh,ds,entry", [
    (40, 4, 16, "selective_scan_ssd_launch"),
    (1, 4, 16, "selective_scan_heads_launch"),
    (40, 4, 12, "selective_scan_heads_launch")])
def test_wrappers_launch_the_route_the_shape_picks(monkeypatch, s, nh, ds,
                                                   entry):
    """With the launch recorded instead of made (no card here): the forward
    and backward wrappers call the SSD entries (counted apart, under
    ``selective_scan_ssd`` / ``_ssd_bwd``) for an SSD shape and the step
    entries otherwise, with the SSD's sizes (B, S, nh, hd, ds)."""
    calls = _record_launches(monkeypatch)
    args = _torch(_inputs(7, s, 8, ds, True))
    gy, gh = _cotangents(8, s, 8, ds)
    ss.selective_scan_heads_cuda(*args)
    ss.selective_scan_heads_bwd_cuda(*args, gy, gh)
    ssd = entry == "selective_scan_ssd_launch"
    assert [c[1] for c in calls] == (
        ["selective_scan_ssd_launch", "selective_scan_ssd_bwd_launch"] if ssd
        else ["selective_scan_heads_launch", "selective_scan_bwd_launch"])
    assert [c[2] for c in calls] == (
        ["selective_scan_ssd", "selective_scan_ssd_bwd"] if ssd
        else ["selective_scan", "selective_scan_bwd"])
    if ssd:
        assert calls[0][3] == calls[1][3] == [B, s, nh, 8, ds]
