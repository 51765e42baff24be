"""Selective scan of the SSM blocks (Mamba-1 for falcon-mamba, Mamba-2 /
SSD for zamba2), forward and backward.

Replaces no Pallas kernel: it ports ``src/repro/models/ssm.py::
selective_scan``, which the reference runs outside Pallas as a chunked
``jax.lax.associative_scan`` (its TPU form of the CUDA implementations'
fused scan), and its JAX gradient, with the CUDA kernels of
``csrc/selective_scan.cu`` (forward: a (batch row, channel)'s states split
4 a lane over a group of lanes, in registers, stepping through time) and
``csrc/selective_scan_bwd.cu`` (backward: a reverse scan over states
recomputed from stored chunk boundaries, Mamba-1's in chunks staged in
shared memory ahead of use and 8-step register tiles; its header has the
designs) — the step kernels — and, for Mamba-2, ``csrc/selective_scan_ssd.cu``: the same
function in its chunked matrix (state-space duality, SSD) form, forward and
backward, on the tensor cores.  ``ssd_route`` picks the route by shape
(Mamba-2, head and state widths multiples of 8 up to 64, S > 1 forward and
S >= SSD_BWD_MIN_STEPS backward: zamba2's prefill and training); decode,
short backwards, other widths and Mamba-1 keep the step kernels.
``selective_scan_ssd_plain`` / ``selective_scan_ssd_bwd_plain`` are the
SSD kernels' blueprint in plain PyTorch (tests and the smoke use them;
``tf32`` rounds their products' inputs as the kernels' three TF32 passes
take them).  From h0, for each step t:

    h_t = exp(dt_t a) * h_{t-1} + (dt_t x_t) b_t,    y_t = <h_t, c_t>

returning (y (B, S, di), h_last (B, di, ds)) in float32.  Two entries:

* ``selective_scan`` — Mamba-1's per-channel decay: dt (B, S, di), a (di,
  ds);
* ``selective_scan_heads`` — Mamba-2's per-head scalar decay: dt (B, S,
  nh), a (nh,), the head width di / nh; the same products as the
  per-channel form over the repeated dt and a, without repeating them.

Each is one op in a trace (``torch.library.custom_op``, namespace
``repro_torch``): the plain version is its CPU implementation, the kernel
its CUDA one (a CUDA tensor launches the kernel or raises), and its fake
implementation gives the outputs' shapes, so a ``FakeTensorMode`` trace
(``launch.dryrun``) sees one node a call.  Its gradient is one op too,
``repro_torch::selective_scan_bwd`` (``::selective_scan_heads_bwd``): (dt,
a, x, b, c, h0, gy, gh_last, chunk) -> (ddt, da, dx, db, dc, dh0), each
shaped as its input, in float32.  Its CPU implementation reruns the plain
version under autograd (the loop's own gradients, bit for bit; a custom
op's implementation runs below autograd, so ``_autograd_dispatch`` turns
it back on there), its CUDA one the backward kernel, its fake one the six
shapes.  The backward op has no gradient of its own (double backward
raises).

What bounds the kernels on the card: the forward, the bytes of dt, x and y
at zamba2's shapes, the B * S * di * ds exps at falcon-mamba's; the
backward, the same bytes with gy, dx and ddt added, or the same exps
(Mamba-1's tiled kernel takes each at most three times, in three forward
passes whose decays the reverse step reuses; Mamba-2's step kernel four
times).  The SSD kernels' three-pass TF32 products take about as long at
the tensor cores' rate as zamba2's bytes (``csrc/selective_scan_ssd.cu``).
The launches count under ``selective_scan`` / ``selective_scan_bwd`` (the
step kernels) and ``selective_scan_ssd`` / ``selective_scan_ssd_bwd``
(``loader.MODEL_LAUNCHES``).
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import loader

MAX_STATE = 128          # the kernel's register state, padded to 4..128
SSD_CHUNK = 64           # the SSD kernels' chunk of steps
SSD_MAX_WIDTH = 64       # their widest head and state (padded to it)
# the shortest S whose backward runs the SSD kernels: they pad a call to a
# whole chunk (~0.15 ms at zamba2's widths, B = 8, on an H100) while the step
# backward grows ~6 us a step from ~0.05 ms at S = 2, so the two cross near
# S = 19 (``scripts/ssd_scan_cost.py``); the SSD forward is the faster one
# from S = 2 on
SSD_BWD_MIN_STEPS = 20


def selective_scan_plain(dt: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, h0: torch.Tensor,
                         chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, Mamba-1: dt, x (B, S, di), a (di, ds), b, c
    (B, S, ds), h0 (B, di, ds) -> (y (B, S, di), h_last).  The (chunk, di,
    ds) decay and input tensors are built one chunk at a time (a chunk of S
    when S is not a multiple of ``chunk``), then stepped one position at a
    time where the reference runs an associative scan: the two agree up to
    the reassociation of f32 products and sums."""
    s = x.shape[1]
    if s % chunk != 0:
        chunk = s
    h = h0
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        dtk, xk, bk, ck = dt[:, sl], x[:, sl], b[:, sl], c[:, sl]
        a_bar = torch.exp(dtk[..., None] * a[None, None])       # (B,c,di,ds)
        b_bar = (dtk * xk)[..., None] * bk[:, :, None, :]
        for t in range(a_bar.shape[1]):
            h = a_bar[:, t] * h + b_bar[:, t]
            ys.append((h * ck[:, t, None, :]).sum(-1))          # (B, di)
    return torch.stack(ys, dim=1), h


def selective_scan_heads_plain(dt: torch.Tensor, a: torch.Tensor,
                               x: torch.Tensor, b: torch.Tensor,
                               c: torch.Tensor, h0: torch.Tensor,
                               chunk: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Plain PyTorch version, Mamba-2: dt (B, S, nh) and a (nh,) repeated
    over each head's di / nh channels and ds states, then
    ``selective_scan_plain``."""
    hd = x.shape[-1] // a.shape[0]
    a_mat = a.repeat_interleave(hd)[:, None].expand(-1, b.shape[-1])
    return selective_scan_plain(dt.repeat_interleave(hd, dim=-1), a_mat, x,
                                b, c, h0, chunk)


def _tf32(v: torch.Tensor, truncate: bool = False) -> torch.Tensor:
    """``v`` rounded to TF32 (10 mantissa bits, ties away from zero, as
    ``cvt.rna.tf32.f32`` and the SSD kernels' integer rounding round it),
    or with ``truncate`` cut to it (as the tensor cores read a float32
    operand), held in float32."""
    bits = v.contiguous().view(torch.int32)
    return ((bits if truncate else bits + 0x1000) & -0x2000).view(
        torch.float32)


def _mm(p: torch.Tensor, q: torch.Tensor, tf32) -> torch.Tensor:
    """``p @ q`` as the tensor cores take it: ``tf32`` None in float32,
    "1pass" on inputs rounded to TF32, "3pass" as hi.hi + hi.lo + lo.hi
    with hi = v rounded to TF32 and lo = v - hi cut to TF32 (the SSD
    kernels' split)."""
    if tf32 is None:
        return p @ q
    ph, qh = _tf32(p), _tf32(q)
    if tf32 == "1pass":
        return ph @ qh
    if tf32 != "3pass":
        raise ValueError(f"tf32 must be None, '1pass' or '3pass', not "
                         f"{tf32!r}")
    return (ph @ _tf32(q - qh, truncate=True)
            + _tf32(p - ph, truncate=True) @ qh + ph @ qh)


def _ssd_chunks(dt, x, b, c, chunk: int, *more) -> tuple:
    """The time axis cut into ``chunk``-step chunks, the last padded with
    zeros (dt = 0 there: no decay, no input): dt (B, nc, nh, Q), x and each
    of ``more`` (B, nc, nh, Q, hd), b and c (B, nc, Q, ds)."""
    bsz, s, di = x.shape
    nh = dt.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def cut(t):
        return torch.nn.functional.pad(t, (0, 0, 0, pad)).reshape(
            bsz, nc, chunk, *t.shape[2:])

    def heads(t):
        return cut(t).reshape(bsz, nc, chunk, nh, di // nh).transpose(2, 3)

    return (cut(dt).transpose(2, 3), heads(x), cut(b), cut(c),
            *map(heads, more))


def _ssd_decays(la: torch.Tensor) -> tuple:
    """From a chunk's log-decays la (..., Q), all <= 0: E[i, j] = exp(sum of
    la over j < k <= i) for j <= i, else 0; exp of the prefix sums (k <= i),
    of the suffix sums (k > j) and of the whole chunk.  Each exponent is
    summed directly, never taken as a difference of prefix sums: its terms
    have one sign, so it is as exact as its own magnitude allows, where
    L_i - L_j would lose the digits of L_i."""
    q = la.shape[-1]
    tri = torch.ones(q, q, dtype=torch.bool, device=la.device)
    terms = la[..., :, None].expand(*la.shape, q)       # [k, j] = la_k
    seg = torch.cumsum(terms.masked_fill(~tri.tril(-1), 0.0), dim=-2)
    e = torch.exp(seg).masked_fill(~tri.tril(0), 0.0)
    rc = torch.flip(torch.cumsum(torch.flip(la, (-1,)), -1), (-1,))
    ls = torch.cat([rc[..., 1:], torch.zeros_like(rc[..., :1])], -1)
    return (e, torch.exp(torch.cumsum(la, -1)), torch.exp(ls),
            torch.exp(rc[..., 0]))


def _ssd_common(dt, a, x, b, c, chunk, tf32, *more) -> tuple:
    """The chunked operands, the decays, U = dt x and G = C B^T."""
    dt_c, x_c, b_c, c_c, *more_c = _ssd_chunks(dt, x, b, c, chunk, *more)
    e, elp, els, eltot = _ssd_decays(dt_c * a[:, None])
    u = dt_c[..., None] * x_c
    g = _mm(c_c, b_c.transpose(-1, -2), tf32)                 # (B,nc,Q,Q)
    return dt_c, x_c, b_c, c_c, more_c, e, elp, els, eltot, u, g


def selective_scan_ssd_plain(dt, a, x, b, c, h0, chunk: int = SSD_CHUNK,
                             tf32=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the SSD kernels' forward, Mamba-2: the scan
    of ``selective_scan_heads_plain`` in its chunked matrix form.  Per chunk
    of Q = ``chunk`` steps and head, with la = dt a, U = dt x (Q, hd) and
    the decays of ``_ssd_decays``:

        G = C B^T (shared by the heads),  Y = (G o E) U + exp(Lp) o C H^T,
        H <- exp(Ltot) H + (exp(Ls) o U)^T B

    from H = h0; ``tf32`` rounds each product's inputs (``_mm``).  Tests
    and the smoke use it; the op's CPU version stays the loop."""
    bsz, s, di = x.shape
    nh = a.shape[0]
    (_, _, b_c, c_c, _, e, elp, els, eltot, u, g) = _ssd_common(
        dt, a, x, b, c, chunk, tf32)
    yd = _mm(g[:, :, None] * e, u, tf32)               # (B,nc,nh,Q,hd)
    h = h0.reshape(bsz, nh, di // nh, -1)
    ys = []
    for k in range(b_c.shape[1]):
        ys.append(yd[:, k] + elp[:, k, ..., None]
                  * _mm(c_c[:, k, None], h.transpose(-1, -2), tf32))
        h = (eltot[:, k, :, None, None] * h
             + _mm((els[:, k, ..., None] * u[:, k]).transpose(-1, -2),
                   b_c[:, k, None], tf32))
    y = torch.stack(ys, 1).transpose(2, 3).reshape(bsz, -1, di)[:, :s]
    return y, h.reshape(bsz, di, -1)


def selective_scan_ssd_bwd_plain(dt, a, x, b, c, h0, gy, gh_last,
                                 chunk: int = SSD_CHUNK,
                                 tf32=None) -> tuple:
    """Plain PyTorch version of the SSD kernels' backward: the gradients of
    ``selective_scan_ssd_plain`` at the cotangents gy of y and gh_last of
    h_last -> (ddt, da, dx, db, dc, dh0), in the three passes the kernels
    run: (1) the state entering each chunk, forward; (2) its cotangent
    leaving each chunk, in reverse, dH <- exp(Ltot) dH + (exp(Lp) o dY)^T
    C, ending at dh0; (3) each chunk's gradients from the two, with M = G o
    E and dM = dY U^T:

        dU = M^T dY + exp(Ls) o B dH^T          (dx = dU dt)
        dC = (dM o E) B + exp(Lp) o dY H        (summed over the heads)
        dB = (dM o E)^T C + exp(Ls) o U dH      (the same)

    and the log-decays' cotangent, a reverse cumulative sum within the chunk
    of the row sums minus the column sums of dM o M, plus the state terms
    r_i = <C_i, exp(Lp_i) (dY H)_i> and -q_j = -<U_j, exp(Ls_j) (B dH^T)_j>,
    with exp(Ltot) <dH, H> + sum q entering at the chunk's end, in float64;
    ddt = dla a + <dU, x>, da = sum dla dt."""
    bsz, s, di = x.shape
    nh = a.shape[0]
    (dt_c, x_c, b_c, c_c, (gy_c,), e, elp, els, eltot, u, g) = _ssd_common(
        dt, a, x, b, c, chunk, tf32, gy)
    nc = b_c.shape[1]
    h = h0.reshape(bsz, nh, di // nh, -1)
    hs = []
    for k in range(nc):                                 # pass 1
        hs.append(h)
        h = (eltot[:, k, :, None, None] * h
             + _mm((els[:, k, ..., None] * u[:, k]).transpose(-1, -2),
                   b_c[:, k, None], tf32))
    dh = gh_last.reshape(h.shape)
    dhs = [None] * nc
    for k in reversed(range(nc)):                       # pass 2
        dhs[k] = dh
        dh = (eltot[:, k, :, None, None] * dh
              + _mm((elp[:, k, ..., None] * gy_c[:, k]).transpose(-1, -2),
                    c_c[:, k, None], tf32))
    hp, dhn = torch.stack(hs, 1), torch.stack(dhs, 1)   # (B,nc,nh,hd,ds)
    m = g[:, :, None] * e                               # pass 3
    dm = _mm(gy_c, u.transpose(-1, -2), tf32)
    dg = dm * e
    du_state = els[..., None] * _mm(b_c[:, :, None], dhn.transpose(-1, -2),
                                    tf32)
    du = du_state + _mm(m.transpose(-1, -2), gy_c, tf32)
    dc_state = elp[..., None] * _mm(gy_c, hp, tf32)
    dc = (dc_state + _mm(dg, b_c[:, :, None], tf32)).sum(2)
    db = (els[..., None] * _mm(u, dhn, tf32)
          + _mm(dg.transpose(-1, -2), c_c[:, :, None], tf32)).sum(2)
    # summed in float64: the row and column sums cancel (each term enters
    # both), and in float32 their rounding left da 2.5e-5 of its max
    p = (dm * m).double()
    q = (u * du_state).sum(-1).double()
    z = (p.sum(-1) - p.sum(-2)
         + (c_c[:, :, None] * dc_state).sum(-1).double() - q)
    z[..., -1] += (eltot * (dhn * hp).sum((-1, -2))).double() + q.sum(-1)
    dla = torch.flip(torch.cumsum(torch.flip(z, (-1,)), -1), (-1,)).float()

    def whole(t):                                       # (B, S, nh[, hd])
        t = t.transpose(2, 3)
        return t.reshape(bsz, -1, *t.shape[3:])[:, :s]

    ddt = whole(dla * a[:, None] + (du * x_c).sum(-1))
    dx = whole(du * dt_c[..., None]).reshape(bsz, s, di)
    da = (dla * dt_c).sum((0, 1, 3))
    db, dc = (t.reshape(bsz, -1, t.shape[-1])[:, :s] for t in (db, dc))
    return ddt, da, dx, db, dc, dh.reshape(h0.shape)


def _operands(name: str, dt, a, x, b, c, h0, heads: bool) -> tuple:
    """The contiguous f32 CUDA operands and (B, S, di, ds, nh); raises on a
    device, dtype or shape the kernel does not take."""
    ops = [t.contiguous() for t in (dt, a, x, b, c, h0)]
    for t, what, ndim in zip(ops, ("dt", "a", "x", "b", "c", "h0"),
                             (3, 1 if heads else 2, 3, 3, 3, 3)):
        loader.check(t, f"{name} {what}", torch.float32, ndim)
    dt, a, x, b, c, h0 = ops
    bsz, s, di = x.shape
    ds = b.shape[-1]
    nh = a.shape[0] if heads else 0
    want_dt = (bsz, s, nh) if heads else (bsz, s, di)
    fits = (dt.shape == want_dt and b.shape == c.shape == (bsz, s, ds)
            and h0.shape == (bsz, di, ds) and 0 < ds <= MAX_STATE
            and (nh > 0 and di % nh == 0 if heads else a.shape == (di, ds))
            and len({t.device for t in ops}) == 1)
    if not fits:
        raise ValueError(
            f"{name}: dt {tuple(dt.shape)}, a {tuple(a.shape)}, x "
            f"{tuple(x.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}, h0 "
            f"{tuple(h0.shape)} do not fit (state width 1..{MAX_STATE})")
    return ops, (bsz, s, di, ds, nh)


def _outputs(x: torch.Tensor, ds: int) -> Tuple[torch.Tensor, torch.Tensor]:
    bsz, _, di = x.shape
    return (torch.empty(x.shape, dtype=torch.float32, device=x.device),
            torch.empty((bsz, di, ds), dtype=torch.float32, device=x.device))


def selective_scan_cuda(dt, a, x, b, c, h0) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Launch the CUDA kernel, Mamba-1's entry (shapes as the plain
    version's; any strides, copied to contiguous)."""
    (dt, a, x, b, c, h0), (bsz, s, di, ds, _) = _operands(
        "selective_scan", dt, a, x, b, c, h0, heads=False)
    y, h_last = _outputs(x, ds)
    loader.launch(
        "selective_scan", "selective_scan_launch", "selective_scan",
        x.device, *map(loader.ptr, (dt, a, x, b, c, h0, y, h_last)),
        loader.c_int(bsz), loader.c_int(s), loader.c_int(di),
        loader.c_int(ds), loader.stream(x))
    return y, h_last


def ssd_route(s: int, hd: int, ds: int, bwd: bool = False) -> bool:
    """Whether a Mamba-2 call of S = ``s`` steps, head width ``hd`` and
    state width ``ds`` runs the SSD kernels (``csrc/selective_scan_ssd.cu``:
    widths multiples of 8 up to SSD_MAX_WIDTH; the forward at S > 1, the
    backward (``bwd``) at S >= SSD_BWD_MIN_STEPS); every other one, and
    every Mamba-1 call, runs the step kernels.  Chosen by shape, never by a
    failure."""
    return (s >= (SSD_BWD_MIN_STEPS if bwd else 2) and hd % 8 == 0
            and ds % 8 == 0 and 0 < hd <= SSD_MAX_WIDTH
            and 0 < ds <= SSD_MAX_WIDTH)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its address is not 16-byte aligned (the
    SSD kernels copy their tiles 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def selective_scan_heads_cuda(dt, a, x, b, c, h0) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
    """Launch a CUDA kernel, Mamba-2's entry: dt (B, S, nh), a (nh,); the
    SSD kernel where ``ssd_route`` says so, else the step kernel."""
    ins, dims = _operands("selective_scan_heads", dt, a, x, b, c, h0,
                          heads=True)
    bsz, s, di, ds, nh = dims
    launch = (_heads_ssd_cuda if ssd_route(s, di // nh, ds)
              else _heads_step_cuda)
    return launch(ins, dims)


def _heads_step_cuda(ins, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step kernel's Mamba-2 launch on ``_operands``' (ins, dims)."""
    dt, a, x, b, c, h0 = ins
    bsz, s, di, ds, nh = dims
    y, h_last = _outputs(x, ds)
    loader.launch(
        "selective_scan", "selective_scan_heads_launch", "selective_scan",
        x.device, *map(loader.ptr, (dt, a, x, b, c, h0, y, h_last)),
        loader.c_int(bsz), loader.c_int(s), loader.c_int(nh),
        loader.c_int(di // nh), loader.c_int(ds), loader.stream(x))
    return y, h_last


def _heads_ssd_cuda(ins, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD forward's launch on ``_operands``' (ins, dims), on shapes
    ``ssd_route`` takes."""
    dt, a, x, b, c, h0 = ins
    bsz, s, di, ds, nh = dims
    y, h_last = _outputs(x, ds)
    x, b, c, h0 = map(_aligned, (x, b, c, h0))
    dims = (bsz, s, nh, di // nh, ds)
    ws = _ssd_workspace("selective_scan_ssd_workspace", dims, x.device)
    loader.launch(
        "selective_scan_ssd", "selective_scan_ssd_launch",
        "selective_scan_ssd", x.device,
        *map(loader.ptr, (dt, a, x, b, c, h0, y, h_last, ws)),
        *map(loader.c_int, dims), loader.stream(x))
    return y, h_last


@contextlib.contextmanager
def _autograd_dispatch():
    """Autograd back on inside a custom op's implementation, which the op
    runs below autograd (its dispatch keys excluded from the thread's
    dispatch): the keys are taken out of the exclusion for the block."""
    C = torch._C
    keys = C._dispatch_tls_local_exclude_set()
    for k in (C.DispatchKey.AutogradCPU, C.DispatchKey.AutogradCUDA,
              C.DispatchKey.AutogradOther, C.DispatchKey.AutogradNestedTensor):
        keys = keys.remove(k)
    with C._ForceDispatchKeyGuard(C._dispatch_tls_local_include_set(), keys):
        yield


def _rerun(plain, dt, a, x, b, c, h0, gy, gh_last, chunk) -> tuple:
    """The gradients of every input of ``plain`` at (gy, gh_last): the plain
    version rerun under autograd."""
    ins = [t.detach().requires_grad_() for t in (dt, a, x, b, c, h0)]
    with _autograd_dispatch(), torch.enable_grad():
        outs = plain(*ins, chunk)
        return torch.autograd.grad(outs, ins, (gy, gh_last))


def selective_scan_bwd_plain(dt, a, x, b, c, h0, gy, gh_last,
                             chunk: int) -> tuple:
    """Plain PyTorch backward, Mamba-1: ``selective_scan_plain`` rerun and
    differentiated at the cotangents gy (B, S, di) of y and gh_last (B, di,
    ds) of h_last -> (ddt, da, dx, db, dc, dh0), shaped as the inputs."""
    return _rerun(selective_scan_plain, dt, a, x, b, c, h0, gy, gh_last,
                  chunk)


def selective_scan_heads_bwd_plain(dt, a, x, b, c, h0, gy, gh_last,
                                   chunk: int) -> tuple:
    """Plain PyTorch backward, Mamba-2: as ``selective_scan_bwd_plain``
    over ``selective_scan_heads_plain``; ddt (B, S, nh), da (nh,)."""
    return _rerun(selective_scan_heads_plain, dt, a, x, b, c, h0, gy,
                  gh_last, chunk)


def selective_scan_bwd_cuda(dt, a, x, b, c, h0, gy, gh_last) -> tuple:
    """Launch the backward kernel, Mamba-1's entry (shapes as the plain
    version's; any strides, copied to contiguous)."""
    return _bwd_step_cuda(*_bwd_operands(
        "selective_scan_bwd", dt, a, x, b, c, h0, gy, gh_last, heads=False),
        heads=False)


def selective_scan_heads_bwd_cuda(dt, a, x, b, c, h0, gy, gh_last) -> tuple:
    """Launch the backward kernels, Mamba-2's entry: dt (B, S, nh), a
    (nh,); the SSD kernels where ``ssd_route`` says so, else the step
    kernel."""
    operands = _bwd_operands("selective_scan_heads_bwd", dt, a, x, b, c,
                             h0, gy, gh_last, heads=True)
    bsz, s, di, ds, nh = operands[-1]
    if ssd_route(s, di // nh, ds, bwd=True):
        return _ssd_bwd_cuda(*operands)
    return _bwd_step_cuda(*operands, heads=True)


def _bwd_operands(name, dt, a, x, b, c, h0, gy, gh_last, heads: bool):
    """The backward's checked operands: (ins, gy, gh_last, grads, dims),
    ``ins`` and ``dims`` as ``_operands`` gives them and ``grads`` the six
    gradients' empty outputs."""
    ins, dims = _operands(name, dt, a, x, b, c, h0, heads)
    x, h0 = ins[2], ins[5]
    gy, gh_last = gy.contiguous(), gh_last.contiguous()
    loader.check(gy, f"{name} gy", torch.float32, 3)
    loader.check(gh_last, f"{name} gh_last", torch.float32, 3)
    if (gy.shape != x.shape or gh_last.shape != h0.shape
            or gy.device != x.device or gh_last.device != x.device):
        raise ValueError(
            f"{name}: gy {tuple(gy.shape)} and gh_last "
            f"{tuple(gh_last.shape)} must be shaped as y {tuple(x.shape)} "
            f"and h_last {tuple(h0.shape)}, on {x.device}")
    grads = [torch.empty(t.shape, dtype=torch.float32, device=x.device)
             for t in ins]
    return ins, gy, gh_last, grads, dims


def _bwd_step_cuda(ins, gy, gh_last, grads, dims, heads: bool) -> tuple:
    """The step backward kernel's launch on ``_bwd_operands``' operands
    into ``grads``."""
    bsz, s, di, ds, nh = dims
    x = ins[2]
    lib = loader.library("selective_scan_bwd")
    lib.selective_scan_bwd_workspace.argtypes = [ctypes.c_int] * 5
    lib.selective_scan_bwd_workspace.restype = ctypes.c_longlong
    n_ws = lib.selective_scan_bwd_workspace(bsz, s, di, ds, int(heads))
    # the stored states and the partial sums (the kernel's header)
    ws = torch.empty((n_ws,), dtype=torch.float32, device=x.device)
    loader.launch(
        "selective_scan_bwd", "selective_scan_bwd_launch",
        "selective_scan_bwd", x.device,
        *map(loader.ptr, (*ins, gy, gh_last, *grads, ws)),
        loader.c_int(bsz), loader.c_int(s), loader.c_int(di),
        loader.c_int(ds), loader.c_int(nh), loader.c_int(int(heads)),
        loader.stream(x))
    return tuple(grads)


def _ssd_workspace(entry: str, dims: tuple, device) -> torch.Tensor:
    """The workspace the SSD library's C entry ``entry`` sizes, in floats,
    for dims (B, S, nh, hd, ds): allocated here, the kernels allocate
    nothing."""
    fn = getattr(loader.library("selective_scan_ssd"), entry)
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return torch.empty((fn(*dims),), dtype=torch.float32, device=device)


def _ssd_bwd_cuda(ins, gy, gh_last, grads, dims) -> tuple:
    """The SSD backward kernels' launch (three kernels, one C entry) on
    ``_bwd_operands``' operands into ``grads``, with a workspace of the
    chunk states, their cotangents and the ordered sums' partials (the
    source's header)."""
    bsz, s, di, ds, nh = dims
    dims = (bsz, s, nh, di // nh, ds)
    dt, a, x, b, c, h0 = ins
    x, b, c, h0, gy, gh_last = map(_aligned, (x, b, c, h0, gy, gh_last))
    ws = _ssd_workspace("selective_scan_ssd_bwd_workspace", dims, x.device)
    loader.launch(
        "selective_scan_ssd", "selective_scan_ssd_bwd_launch",
        "selective_scan_ssd_bwd", x.device,
        *map(loader.ptr, (dt, a, x, b, c, h0, gy, gh_last, *grads, ws)),
        *map(loader.c_int, dims), loader.stream(x))
    return tuple(grads)


def _bwd_op(name: str, plain, cuda):
    """``repro_torch::<name>``, the gradient op: ``plain`` on the CPU,
    ``cuda`` on the card, the six input shapes under fake tensors; its own
    backward raises."""

    @torch.library.custom_op(f"repro_torch::{name}", mutates_args=(),
                             device_types="cpu")
    def op(dt: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
           b: torch.Tensor, c: torch.Tensor, h0: torch.Tensor,
           gy: torch.Tensor, gh_last: torch.Tensor,
           chunk: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor, torch.Tensor]:
        return tuple(plain(dt, a, x, b, c, h0, gy, gh_last, chunk))

    @op.register_kernel("cuda")
    def _(dt, a, x, b, c, h0, gy, gh_last, chunk):
        return cuda(dt, a, x, b, c, h0, gy, gh_last)

    @op.register_fake
    def _(dt, a, x, b, c, h0, gy, gh_last, chunk):
        return tuple(t.new_empty(t.shape, dtype=torch.float32)
                     for t in (dt, a, x, b, c, h0))

    def backward(ctx, *grads):
        raise NotImplementedError(
            f"repro_torch::{name} has no gradient: the selective scan's "
            "double backward is not implemented")

    op.register_autograd(backward,
                         setup_context=lambda ctx, inputs, output: None)
    return op


def _custom_op(name: str, plain, cuda, bwd):
    """``repro_torch::<name>``: ``plain`` on the CPU, ``cuda`` on the card,
    the output shapes under fake tensors, gradients by the op ``bwd``."""

    @torch.library.custom_op(f"repro_torch::{name}", mutates_args=(),
                             device_types="cpu")
    def op(dt: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
           b: torch.Tensor, c: torch.Tensor, h0: torch.Tensor,
           chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return plain(dt, a, x, b, c, h0, chunk)

    @op.register_kernel("cuda")
    def _(dt, a, x, b, c, h0, chunk):
        return cuda(dt, a, x, b, c, h0)

    @op.register_fake
    def _(dt, a, x, b, c, h0, chunk):
        return (x.new_empty(x.shape, dtype=torch.float32),
                h0.new_empty(h0.shape, dtype=torch.float32))

    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:6])
        ctx.chunk = inputs[6]

    def backward(ctx, gy, gh):
        need = ctx.needs_input_grad[:6]
        ins = ctx.saved_tensors
        x, h0 = ins[2], ins[5]
        if gy is None:
            gy = x.new_zeros(x.shape, dtype=torch.float32)
        if gh is None:
            gh = h0.new_zeros(h0.shape, dtype=torch.float32)
        grads = bwd(*ins, gy, gh, ctx.chunk)
        return (*(g if n else None for g, n in zip(grads, need)), None)

    op.register_autograd(backward, setup_context=setup_context)
    return op


scan_bwd_op = _bwd_op("selective_scan_bwd", selective_scan_bwd_plain,
                      selective_scan_bwd_cuda)
scan_heads_bwd_op = _bwd_op("selective_scan_heads_bwd",
                            selective_scan_heads_bwd_plain,
                            selective_scan_heads_bwd_cuda)
scan_op = _custom_op("selective_scan", selective_scan_plain,
                     selective_scan_cuda, scan_bwd_op)
scan_heads_op = _custom_op("selective_scan_heads", selective_scan_heads_plain,
                           selective_scan_heads_cuda, scan_heads_bwd_op)
