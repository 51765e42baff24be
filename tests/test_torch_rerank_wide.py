"""The masked rerank's wide kernel (``csrc/l2_rerank.cu``
``l2_rerank_wide_kernel``, rows wider than 128) in its own order, on the CPU:
a block of 512 threads takes a window of candidates, and each thread sums
its 2,048 / 512 = 4 elements of an asked-for row in every 2,048-wide pass
(one float4 load, or four scalar ones when D % 4 != 0), pass by pass and
load by load;
a warp's butterfly of xor shuffles sums its threads' partials, and the
sixteen warps' partials are summed in warp order.  This blueprint is held
against the reference's ``repro.kernels.ref.l2_rerank_ref`` (the TPU
kernel's expanded form over the gathered rows) at ``tests/test_kernels.py``'s
tolerances, rtol 1e-4 / atol 1e-3, with ``acc`` passed through bit for bit
where the mask is False: D = 300 (one pass, most threads idle), 1,024 (half
a pass), 2,048 (the image retriever's, one full pass) and 2,049 (scalar
loads, two passes).  The rows in flight and the window change when a row
is loaded, not the order its terms are summed in."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import l2_rerank_ref

THREADS = 512                    # a block
PER = 2048 // THREADS            # a thread's elements a pass


def rerank_wide_blueprint(queries, ids, base, acc, mask, metric):
    """The wide kernel's arithmetic in float32: (Q, D) queries, (Q, K) ids,
    (N, D) base, (Q, K) acc and mask -> (Q, K)."""
    d = base.shape[1]
    vec = 4 if d % 4 == 0 else 1
    warps, loads, width = THREADS // 32, PER // vec, PER * THREADS
    qi, ki = mask.nonzero(as_tuple=True)
    npass = -(-d // width)
    pad = npass * width - d
    x = torch.nn.functional.pad(base[ids[qi, ki].long()], (0, pad))
    q = torch.nn.functional.pad(queries[qi], (0, pad))
    # element of (pass, load j, warp, lane, component) as the kernel reads it
    shape = (len(qi), npass, loads, warps, 32, vec)
    terms = ((x - q) ** 2 if metric == "l2" else q * x).view(shape)
    s = torch.zeros((len(qi), warps, 32))
    for p in range(npass):
        for j in range(loads):
            for v in range(vec):
                s = s + terms[:, p, j, :, :, v]
    for off in (16, 8, 4, 2, 1):          # the warp's butterfly, lane 0's
        s = s + s[..., torch.arange(32) ^ off]
    dist = torch.zeros(len(qi))
    for w in range(warps):                 # the warps in warp order
        dist = dist + s[:, w, 0]
    out = acc.clone()
    out[qi, ki] = dist if metric == "l2" else -dist
    return out


@pytest.mark.parametrize("d", [300, 1024, 2048, 2049])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_blueprint_matches_reference(d, metric):
    rng = np.random.default_rng(d)
    q, k, n = 3, 40, 60
    queries = rng.standard_normal((q, d)).astype(np.float32)
    base = rng.standard_normal((n, d)).astype(np.float32)
    ids = rng.integers(0, n, (q, k)).astype(np.int32)
    mask = rng.random((q, k)) < 0.3
    ids[~mask & (rng.random((q, k)) < 0.5)] = -1     # never read
    acc = rng.standard_normal((q, k)).astype(np.float32)
    got = rerank_wide_blueprint(*map(torch.from_numpy,
                                     (queries, ids, base, acc, mask)),
                                metric).numpy()
    want = np.asarray(l2_rerank_ref(jnp.asarray(queries),
                                    jnp.asarray(base[np.maximum(ids, 0)]),
                                    metric))
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got[~mask], acc[~mask])

