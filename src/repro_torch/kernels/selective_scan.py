"""Selective scan of the SSM blocks (Mamba-1 for falcon-mamba, Mamba-2 /
SSD for zamba2), forward and backward.

Replaces no Pallas kernel: it ports ``src/repro/models/ssm.py::
selective_scan``, which the reference runs outside Pallas as a chunked
``jax.lax.associative_scan`` (its TPU form of the CUDA implementations'
fused scan), and its JAX gradient, with the CUDA kernels of
``csrc/selective_scan.cu`` (forward: a thread a (batch row, channel) with
its state in registers, stepping through time) and
``csrc/selective_scan_bwd.cu`` (backward: a reverse scan over states
recomputed from stored chunk boundaries; its header has the design).  From
h0, for each step t:

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
backward, the same bytes with gy, dx and ddt added, or the same exps (the
kernel takes each four times: three forward reruns and the reverse step).
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import loader

MAX_STATE = 128          # the kernel's register state, padded to 4..128


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


def selective_scan_heads_cuda(dt, a, x, b, c, h0) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
    """Launch the CUDA kernel, Mamba-2's entry: dt (B, S, nh), a (nh,)."""
    (dt, a, x, b, c, h0), (bsz, s, di, ds, nh) = _operands(
        "selective_scan_heads", dt, a, x, b, c, h0, heads=True)
    y, h_last = _outputs(x, ds)
    loader.launch(
        "selective_scan", "selective_scan_heads_launch", "selective_scan",
        x.device, *map(loader.ptr, (dt, a, x, b, c, h0, y, h_last)),
        loader.c_int(bsz), loader.c_int(s), loader.c_int(nh),
        loader.c_int(di // nh), loader.c_int(ds), loader.stream(x))
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
    return _bwd_cuda("selective_scan_bwd", dt, a, x, b, c, h0, gy, gh_last,
                     heads=False)


def selective_scan_heads_bwd_cuda(dt, a, x, b, c, h0, gy,
                                  gh_last) -> tuple:
    """Launch the backward kernel, Mamba-2's entry: dt (B, S, nh), a
    (nh,)."""
    return _bwd_cuda("selective_scan_heads_bwd", dt, a, x, b, c, h0, gy,
                     gh_last, heads=True)


def _bwd_cuda(name, dt, a, x, b, c, h0, gy, gh_last, heads: bool) -> tuple:
    ins, (bsz, s, di, ds, nh) = _operands(name, dt, a, x, b, c, h0, heads)
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
    lib = loader.library("selective_scan_bwd")
    lib.selective_scan_bwd_workspace.argtypes = [ctypes.c_int] * 5
    lib.selective_scan_bwd_workspace.restype = ctypes.c_longlong
    n_ws = lib.selective_scan_bwd_workspace(bsz, s, di, ds, int(heads))
    # the stored states and the partial sums (the kernel's header)
    ws = torch.empty((n_ws,), dtype=torch.float32, device=x.device)
    grads = [torch.empty(t.shape, dtype=torch.float32, device=x.device)
             for t in ins]
    loader.launch(
        "selective_scan_bwd", "selective_scan_bwd_launch",
        "selective_scan_bwd", x.device,
        *map(loader.ptr, (*ins, gy, gh_last, *grads, ws)),
        loader.c_int(bsz), loader.c_int(s), loader.c_int(di),
        loader.c_int(ds), loader.c_int(nh), loader.c_int(int(heads)),
        loader.stream(x))
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
