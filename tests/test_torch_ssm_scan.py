"""The selective scan as one op (``repro_torch.kernels.selective_scan``), on
the CPU: its plain version against the reference's chunked associative scan
(``repro.models.ssm.selective_scan``) at rtol 1e-5, the per-head entry
bit-equal to the per-channel one on the repeated inputs, one traced node a
call under ``FakeTensorMode`` with the outputs' shapes and dtypes, and
gradients through the op equal to the loop's own.  The CUDA kernel against
the plain version is in ``tests/test_torch_cuda.py`` (needs a card)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models.ssm import selective_scan as ref_selective_scan
from repro_torch.kernels import ops
from repro_torch.kernels.selective_scan import (
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
