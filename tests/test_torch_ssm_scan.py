"""The selective scan as one op (``repro_torch.kernels.selective_scan``), on
the CPU: its plain version against the reference's chunked associative scan
(``repro.models.ssm.selective_scan``) at rtol 1e-5, the per-head entry
bit-equal to the per-channel one on the repeated inputs, one traced node a
call under ``FakeTensorMode`` with the outputs' shapes and dtypes, and
gradients through the op equal to the loop's own.  The backward op
(``repro_torch::selective_scan_bwd`` / ``::selective_scan_heads_bwd``):
its gradients against the reference's ``jax.vjp`` to 1e-5 of each
gradient's largest magnitude (Mamba-2 through the reference's repeated dt
and a, summed back per head by the vjp), one traced node a backward, a
missing cotangent taken as zeros, no double backward.  The CUDA kernels
against the plain versions are in ``tests/test_torch_cuda.py`` (needs a
card)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models.ssm import selective_scan as ref_selective_scan
from repro_torch.kernels import ops
from repro_torch.kernels.selective_scan import (
    selective_scan_bwd_plain, selective_scan_heads_bwd_plain,
    selective_scan_heads_plain, selective_scan_plain,
)

B, DI, DS, NH = 2, 32, 8, 4


def _inputs(seed, s, heads=False, carried=True):
    """(dt, a, x, b, c, h0) as numpy f32: Mamba-1's (B, S, di) dt and (di,
    ds) decay, or Mamba-2's (B, S, nh) dt and (nh,) decay."""
    rng = np.random.default_rng(seed)
    dt = np.abs(rng.standard_normal((B, s, NH if heads else DI))) * 0.3
    a = -np.exp(rng.standard_normal((NH,) if heads else (DI, DS)))
    x, b, c = (rng.standard_normal(sh) for sh in ((B, s, DI), (B, s, DS),
                                                 (B, s, DS)))
    h0 = (rng.standard_normal((B, DI, DS)) if carried
          else np.zeros((B, DI, DS)))
    return [np.asarray(t, np.float32) for t in (dt, a, x, b, c, h0)]


def _torch(args, grad=False):
    return [torch.from_numpy(t).requires_grad_(grad) for t in args]


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("s,chunk", [(40, 8), (40, 40), (37, 8)],
                         ids=["chunk<S", "chunk=S", "ragged"])
def test_plain_matches_reference(s, chunk, carried):
    """chunk < S (5 chunks), chunk = S, and S not a multiple of the chunk,
    from a zero and a carried state."""
    args = _inputs(1, s, carried=carried)
    want_y, want_h = ref_selective_scan(*map(jnp.asarray, args), chunk)
    got_y, got_h = selective_scan_plain(*_torch(args), chunk)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("s", [1, 37])
def test_heads_entry_equals_repeated_inputs(s):
    """Mamba-2's entry is the per-channel scan over dt and a repeated over
    each head's channels and states, bit for bit (as ``mamba2`` built them
    before the per-head entry); the op's CPU path is the same."""
    dt, a, x, b, c, h0 = _torch(_inputs(2, s, heads=True))
    hd = DI // NH
    dt_rep = dt.repeat_interleave(hd, dim=-1)
    a_mat = a.repeat_interleave(hd)[:, None] * torch.ones((1, DS))
    want = selective_scan_plain(dt_rep, a_mat, x, b, c, h0, 8)
    for got in (selective_scan_heads_plain(dt, a, x, b, c, h0, 8),
                ops.selective_scan_heads(dt, a, x, b, c, h0, 8)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


class _Ops(TorchDispatchMode):
    """Records the ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("heads", [False, True], ids=["mamba1", "mamba2"])
def test_one_traced_node_a_call(heads):
    """Under ``FakeTensorMode`` (the dry-run's trace) a call is one op, not
    one a position, with the outputs' shapes and float32."""
    s = 4096
    name = "selective_scan_heads" if heads else "selective_scan"
    with FakeTensorMode():
        args = [torch.empty(t.shape) for t in _inputs(3, 1, heads)]
        dt, a, x, b, c, h0 = args
        dt, x, b, c = (t.expand(B, s, t.shape[-1]) for t in (dt, x, b, c))
        with _Ops() as seen:
            y, h = getattr(ops, name)(dt, a, x, b, c, h0, 256)
    assert seen.seen == [f"repro_torch.{name}.default"]
    assert tuple(y.shape) == (B, s, DI) and tuple(h.shape) == (B, DI, DS)
    assert y.dtype == h.dtype == torch.float32


@pytest.mark.parametrize("heads", [False, True], ids=["mamba1", "mamba2"])
def test_gradients_equal_the_loops(heads):
    """Gradients through the op (its backward reruns the plain version)
    equal the plain loop's own, for every input, both outputs used."""
    args = _inputs(4, 13, heads)
    plain = selective_scan_heads_plain if heads else selective_scan_plain
    op = ops.selective_scan_heads if heads else ops.selective_scan
    rng = np.random.default_rng(5)
    wy = torch.from_numpy(rng.standard_normal((B, 13, DI)).astype(np.float32))
    wh = torch.from_numpy(rng.standard_normal((B, DI, DS)).astype(np.float32))
    grads = []
    for fn in (op, plain):
        ins = _torch(args, grad=True)
        y, h = fn(*ins, 4)
        grads.append(torch.autograd.grad((y * wy).sum() + (h * wh).sum(),
                                         ins))
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def _ref_vjp(args, heads, chunk, gy, gh):
    """The reference's gradients of every input at (gy, gh): Mamba-2's dt
    and a repeated as ``repro.models.ssm.mamba2`` repeats them."""
    def fn(dt, a, x, b, c, h0):
        if heads:
            hd = DI // NH
            dt = jnp.repeat(dt, hd, axis=-1)
            a = jnp.repeat(a, hd)[:, None] * jnp.ones((1, DS))
        return ref_selective_scan(dt, a, x, b, c, h0, chunk)

    _, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    return [np.asarray(g) for g in vjp((jnp.asarray(gy), jnp.asarray(gh)))]


def _cotangents(seed, s):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, s, DI)).astype(np.float32),
            rng.standard_normal((B, DI, DS)).astype(np.float32))


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("s,chunk", [(40, 8), (37, 8)],
                         ids=["chunk<S", "ragged"])
@pytest.mark.parametrize("heads", [False, True], ids=["mamba1", "mamba2"])
def test_gradients_match_reference_vjp(heads, s, chunk, carried):
    """Gradients through the op (both outputs used) against the
    reference's ``jax.vjp`` of its chunked associative scan, each within
    1e-5 of its largest magnitude; the op's equal the plain backward's bit
    for bit."""
    args = _inputs(6, s, heads, carried)
    gy, gh = _cotangents(7, s)
    op = ops.selective_scan_heads if heads else ops.selective_scan
    ins = _torch(args, grad=True)
    y, h = op(*ins, chunk)
    got = torch.autograd.grad((y, h), ins, (torch.from_numpy(gy),
                                            torch.from_numpy(gh)))
    plain = (selective_scan_heads_bwd_plain if heads
             else selective_scan_bwd_plain)
    direct = plain(*_torch(args), torch.from_numpy(gy), torch.from_numpy(gh),
                   chunk)
    want = _ref_vjp(args, heads, chunk, gy, gh)
    for name, g, d, w in zip(("dt", "a", "x", "b", "c", "h0"), got, direct,
                             want):
        assert torch.equal(g, d), name
        assert g.shape == w.shape, name
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("heads", [False, True], ids=["mamba1", "mamba2"])
def test_one_traced_node_a_backward(heads):
    """Under ``FakeTensorMode`` a forward is one op and its backward one
    op, with each gradient shaped and typed as its input."""
    s = 4096
    name = "selective_scan_heads" if heads else "selective_scan"
    with FakeTensorMode():
        dt, a, x, b, c, h0 = [torch.empty(t.shape)
                              for t in _inputs(3, 1, heads)]
        dt, x, b, c = (t.expand(B, s, t.shape[-1]) for t in (dt, x, b, c))
        ins = [t.requires_grad_() for t in (dt, a, x, b, c, h0)]
        gy, gh = torch.empty((B, s, DI)), torch.empty((B, DI, DS))
        with _Ops() as seen:
            y, h = getattr(ops, name)(*ins, 256)
            grads = torch.autograd.grad((y, h), ins, (gy, gh))
    mine = [f for f in seen.seen if f.startswith("repro_torch.")]
    assert mine == [f"repro_torch.{name}.default",
                    f"repro_torch.{name}_bwd.default"]
    for g, t in zip(grads, ins):
        assert g.shape == t.shape and g.dtype == torch.float32


@pytest.mark.parametrize("heads", [False, True], ids=["mamba1", "mamba2"])
def test_unused_output_takes_zero_cotangent(heads):
    """Only y used (h_last's cotangent None) or only h_last: the gradients
    equal the plain loop's, whose autograd takes the missing cotangent as
    zeros (only h_last used, c gets none there, and zeros through the op);
    an input that needs no gradient gets none."""
    args = _inputs(8, 11, heads)
    op = ops.selective_scan_heads if heads else ops.selective_scan
    plain = selective_scan_heads_plain if heads else selective_scan_plain
    for pick in (0, 1):
        grads = []
        for fn in (op, plain):
            ins = _torch(args, grad=True)
            ins[5].requires_grad_(False)
            out = fn(*ins, 4)[pick]
            grads.append(torch.autograd.grad((out * out).sum(), ins[:5],
                                             allow_unused=True))
        for got, want in zip(*grads):
            assert torch.equal(got, torch.zeros_like(got) if want is None
                               else want)
    ins = _torch(args)
    ins[2].requires_grad_()
    y, _ = op(*ins, 4)
    y.sum().backward()
    assert ins[2].grad is not None and ins[0].grad is None


@pytest.mark.parametrize("heads", [False, True], ids=["mamba1", "mamba2"])
def test_double_backward_raises(heads):
    args = _inputs(9, 5, heads)
    op = ops.selective_scan_heads if heads else ops.selective_scan
    ins = _torch(args, grad=True)
    y, _ = op(*ins, 4)
    (gx,) = torch.autograd.grad(y.sum(), [ins[2]], create_graph=True)
    with pytest.raises(NotImplementedError, match="double backward"):
        gx.sum().backward()
