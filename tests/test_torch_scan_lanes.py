"""The step scan's forward kernel (``csrc/selective_scan.cu``) in its own
order, on the CPU: a channel's states split 4 a lane over a group of
kDS / 4 lanes (kDS the state width padded to a power of two >= 4), each
lane's 4 products summed in order, the lanes' partial sums then summed as
the kernel's xor shuffles sum them, and Mamba-1's decay taken as exp2 of dt
times the rate prescaled by log2 e.  This blueprint is held against the
reference's chunked associative scan (``repro.models.ssm.selective_scan``)
within 1e-5 of the largest |y| and |h_last|, the bar the kernel is held to
against the plain version on the card (``tests/test_torch_cuda.py``):
Mamba-1 at ds 4 and 16 (and 12, padded to 16), Mamba-2's per-head decay
at ds 64, S = 1, 37 and 64, zero and carried state."""
import functools
import math

import jax
import numpy as np
import pytest
import torch

from repro.models.ssm import selective_scan as ref_selective_scan

B, DI, NH = 2, 24, 3
LOG2E = 1.4426950408889634


def _inputs(seed, s, ds, heads):
    """(dt, a, x, b, c, h0) as numpy f32 over 2 * B rows: h0 zero in the
    first B, drawn in the last B (one reference call serves both)."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((2 * B, s, NH if heads else DI))
                         - 1.0))
    a = -np.exp(rng.standard_normal((NH,) if heads else (DI, ds)))
    x, b, c = (rng.standard_normal(sh) for sh in ((2 * B, s, DI),
                                                 (2 * B, s, ds),
                                                 (2 * B, s, ds)))
    h0 = rng.standard_normal((2 * B, DI, ds))
    h0[:B] = 0.0
    return [np.asarray(t, np.float32) for t in (dt, a, x, b, c, h0)]


def scan_lanes_blueprint(dt, a, x, b, c, h0, heads: bool):
    """The kernel's arithmetic in float32: dt, x (B, S, di); Mamba-1's a
    (di, ds) or, with ``heads``, dt (B, S, nh) and a (nh,); b, c (B, S,
    ds); h0 (B, di, ds) -> (y (B, S, di), h_last)."""
    bsz, s, di = x.shape
    ds = b.shape[-1]
    kds = max(4, 1 << (ds - 1).bit_length())
    pad = kds - ds
    b, c, h = (torch.nn.functional.pad(t, (0, pad)) for t in (b, c, h0))
    if heads:
        hd = di // a.shape[0]
        dt_ch = dt.repeat_interleave(hd, dim=-1)           # (B, S, di)
        dec = torch.exp(dt * a).repeat_interleave(hd, dim=-1)
    else:
        dt_ch = dt
        rate = torch.nn.functional.pad(a * LOG2E, (0, pad))   # (di, kds)
    ys = []
    for t in range(s):
        u = (dt_ch[:, t] * x[:, t])[..., None]                # (B, di, 1)
        decay = (dec[:, t, :, None] if heads
                 else torch.exp2(dt_ch[:, t, :, None] * rate))
        h = decay * h + u * b[:, t, None, :]
        # a lane's 4 products in order, then the tree over the lanes: the
        # xor shuffle at offset G/2 first leaves lane 0 p0 + p_{G/2}, ...
        prod = (h * c[:, t, None, :]).view(bsz, di, kds // 4, 4)
        p = ((prod[..., 0] + prod[..., 1]) + prod[..., 2]) + prod[..., 3]
        while p.shape[-1] > 1:
            half = p.shape[-1] // 2
            p = p[..., :half] + p[..., half:]
        ys.append(p[..., 0])
    return torch.stack(ys, 1), h[..., :ds]


@functools.lru_cache(maxsize=None)
def _case(s, ds, heads):
    """The inputs and the reference's (y, h_last) for one shape."""
    args = _inputs(7 * s + ds, s, ds, heads)
    dt, a, x, b, c, h0 = args
    if heads:
        hd = x.shape[-1] // a.shape[0]
        dt = np.repeat(dt, hd, axis=-1)
        a = np.repeat(a, hd)[:, None].repeat(b.shape[-1], axis=1)
    y, h = ref_selective_scan(dt, a, x, b, c, h0, chunk=64)
    return args, (np.asarray(y), np.asarray(h))


@pytest.fixture(scope="module", autouse=True)
def _jax_on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("s", [1, 37, 64])
@pytest.mark.parametrize("ds,heads", [(4, False), (16, False), (64, True)],
                         ids=["mamba1_ds4", "mamba1_ds16", "mamba2_ds64"])
def test_lane_blueprint_matches_reference(ds, heads, s, carried):
    args, want = _case(s, ds, heads)
    rows = slice(B, 2 * B) if carried else slice(0, B)
    ins = [torch.as_tensor(t if i == 1 else t[rows])
           for i, t in enumerate(args)]
    got = scan_lanes_blueprint(*ins, heads)
    for g, w in zip(got, want):
        w = w[rows]
        assert g.dtype == torch.float32 and g.shape == w.shape
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()), err


def test_lane_blueprint_pads_odd_state_widths():
    """ds = 12 pads to 16 (a lane of zero states, zero rates): the same
    function as the blueprint at ds = 16 would give, within the bar."""
    args, want = _case(37, 12, False)
    got = scan_lanes_blueprint(*(torch.as_tensor(t) for t in args), False)
    for g, w in zip(got, want):
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()), err


def test_lane_tree_is_the_xor_shuffle_order():
    """The blueprint's halving sum gives lane 0 the value the kernel's xor
    shuffles (offsets G/2, ..., 1) give every lane of the group."""
    rng = np.random.default_rng(3)
    for g in (1, 2, 4, 8, 16, 32):
        parts = rng.standard_normal(g).astype(np.float32)
        lanes = parts.copy()
        off = g // 2
        while off:
            lanes = lanes + lanes[np.arange(g) ^ off]
            off //= 2
        p = torch.as_tensor(parts)
        while p.shape[-1] > 1:
            p = p[: p.shape[-1] // 2] + p[p.shape[-1] // 2:]
        assert np.all(lanes == lanes[0]) or g == 1
        assert lanes[0] == float(p[0]), g
        assert math.isfinite(lanes[0])
