"""Mamba-1's tiled backward kernel (``csrc/selective_scan_bwd.cu``
``scan_bwd_tiles_kernel``) in its own order, on the CPU: a channel's states
4 a lane over kDS / 4 lanes (kDS the state width padded to a power of two
>= 4), 1024 / kDS channels a block; time in chunks of min(32, 2 kDS) steps
(zero steps past S, which leave every state as it is), walked forward
storing each chunk's starting state, then in reverse: each chunk rerun
storing its 8-step tiles' starting states, each tile rerun keeping its
states and decays, then stepped back through.  A decay is 0.5 * 2^(dt a
log2 e + 1).  A lane's products are summed in order, the lanes' sums (du,
the decay's gradient) in the xor shuffles' tree; dB's and dC's terms over a
warp's channels in the butterfly's tree, then over the block's 8 warps in
warp order, then over the blocks in order; da over the batch rows in
order.  This blueprint is held against the reference's ``jax.vjp`` of its
chunked associative scan (``repro.models.ssm.selective_scan``) within 1e-5
of each gradient's largest magnitude, the bar the kernel is held to against
the plain backward on the card (``tests/test_torch_cuda.py``): ds 4 and 16,
S = 37 (across tiles and a 32-step chunk) and 130 (across the 128-step
chunks of the reference and of the first design), each case's batch rows
half from a zero state and half from a carried one (one reference call
serves both)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models.ssm import selective_scan as ref_selective_scan

B, DI = 4, 80
LOG2E = 1.4426950408889634
TILE, WARPS = 8, 8


def _tree(p):
    """The xor shuffles' sum over the last dim, as lane 0 (and every lane)
    ends with it: halves added, the upper onto the lower."""
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    return p[..., 0]


def scan_bwd_tiles_blueprint(dt, a, x, b, c, h0, gy, gh):
    """The tiled kernel's arithmetic in float32: Mamba-1's dt, x, gy (B, S,
    di), a (di, ds), b, c (B, S, ds), h0, gh (B, di, ds) -> (ddt, da, dx,
    db, dc, dh0)."""
    bsz, s, di = x.shape
    ds = b.shape[-1]
    kds = max(4, 1 << (ds - 1).bit_length())
    kg, cpb = kds // 4, 1024 // kds
    chunk = min(32, 2 * kds)
    nc, nblk = -(-s // chunk), -(-di // cpb)
    sp, dp = nc * chunk, nblk * cpb
    dt_, x_, gy_ = (F.pad(t, (0, dp - di, 0, sp - s)) for t in (dt, x, gy))
    b_, c_ = (F.pad(t, (0, kds - ds, 0, sp - s)) for t in (b, c))
    a_, h0_, gh_ = (F.pad(t, (0, kds - ds, 0, dp - di)) for t in (a, h0, gh))
    rate2 = a_ * LOG2E

    def decay(t):
        return 0.5 * torch.exp2(dt_[:, t, :, None] * rate2 + 1.0)

    def u(t):
        return (dt_[:, t] * x_[:, t])[..., None]

    def step(h, t):
        return decay(t) * h + u(t) * b_[:, t, None, :]

    def lanes(p):                # (B, dp, kds) products -> a channel's sum
        p = p.view(bsz, dp, kg, 4)
        return _tree(((p[..., 0] + p[..., 1]) + p[..., 2]) + p[..., 3])

    def channels(v):             # (B, dp, kds) -> the blocks' (B, nblk, kds)
        w = _tree(v.view(bsz, nblk, WARPS, -1, kds).transpose(-1, -2))
        acc = torch.zeros((bsz, nblk, kds))
        for k in range(WARPS):
            acc = acc + w[:, :, k]
        return acc

    h, ckpt = h0_, []
    for ci in range(nc):                          # pass 1
        ckpt.append(h)
        if ci < nc - 1:
            for t in range(ci * chunk, (ci + 1) * chunk):
                h = step(h, t)
    g, dacc = gh_, torch.zeros_like(gh_)
    dx, ddt = torch.zeros_like(x_), torch.zeros_like(x_)
    pdb = torch.zeros((bsz, nblk, sp, kds))
    pdc = torch.zeros_like(pdb)
    for ci in reversed(range(nc)):
        h, starts = ckpt[ci], []
        for k in range(chunk // TILE):            # pass 2
            starts.append(h)
            for t in range(ci * chunk + k * TILE, ci * chunk + (k + 1) * TILE):
                h = step(h, t)
        for k in reversed(range(chunk // TILE)):  # pass 3
            t0 = ci * chunk + k * TILE
            hs, decs = [starts[k]], []
            for t in range(t0, t0 + TILE):
                decs.append(decay(t))
                hs.append(decs[-1] * hs[-1] + u(t) * b_[:, t, None, :])
                pdc[:, :, t] = channels(gy_[:, t, :, None] * hs[-1])
            for tt in reversed(range(TILE)):
                t = t0 + tt
                gt = gy_[:, t, :, None] * c_[:, t, None, :] + g
                du = lanes(gt * b_[:, t, None, :])
                ga = gt * hs[tt] * decs[tt]
                gdec = lanes(a_ * ga)
                dacc = dacc + dt_[:, t, :, None] * ga
                pdb[:, :, t] = channels(gt * u(t))
                g = decs[tt] * gt
                dx[:, t] = du * dt_[:, t]
                ddt[:, t] = du * x_[:, t] + gdec
    db, dc = torch.zeros((bsz, s, ds)), torch.zeros((bsz, s, ds))
    for k in range(nblk):
        db = db + pdb[:, k, :s, :ds]
        dc = dc + pdc[:, k, :s, :ds]
    da = torch.zeros((di, ds))
    for k in range(bsz):
        da = da + dacc[k, :di, :ds]
    return (ddt[:, :s, :di], da, dx[:, :s, :di], db, dc, g[:, :di, :ds])


def _inputs(seed, s, ds):
    """The six inputs and two cotangents, numpy f32; h0 zero in the first
    B / 2 rows."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, s, DI)) - 1.0))
    a = -np.exp(rng.standard_normal((DI, ds)))
    x, b, c, gy = (rng.standard_normal(sh) for sh in
                   ((B, s, DI), (B, s, ds), (B, s, ds), (B, s, DI)))
    h0 = rng.standard_normal((B, DI, ds))
    h0[:B // 2] = 0.0
    gh = rng.standard_normal((B, DI, ds))
    return [np.asarray(t, np.float32) for t in (dt, a, x, b, c, h0, gy, gh)]


def _case(s, ds):
    """The inputs and the reference's six gradients for one case."""
    args = _inputs(11 * s + ds, s, ds)

    def fn(*ins):
        return ref_selective_scan(*ins, 128)

    _, vjp = jax.vjp(fn, *map(jnp.asarray, args[:6]))
    want = vjp((jnp.asarray(args[6]), jnp.asarray(args[7])))
    return args, [np.asarray(w) for w in want]


@pytest.mark.parametrize("s", [37, 130])
@pytest.mark.parametrize("ds", [4, 16])
def test_blueprint_matches_reference_vjp(ds, s):
    args, want = _case(s, ds)
    got = scan_bwd_tiles_blueprint(*map(torch.from_numpy, args))
    for name, g_, w in zip(("ddt", "da", "dx", "db", "dc", "dh0"), got,
                           want):
        err = float(np.abs(g_.numpy() - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()), (name, err)
