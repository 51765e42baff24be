"""The port's kernel modules on the CPU: each plain version against the
reference's oracle (``repro.kernels.ref``) and the reference's Pallas kernel
run in interpret mode (``repro.kernels.ops``), over the shape sweeps of
tests/test_kernels.py.  Tolerances as there: rtol/atol 1e-4 for ADT and
lookup, 1e-4/1e-3 for rerank, exact for the sort, ties included.

The search's merge (``bitonic_merge_topl``) is held against the reference's
``_merge_sort_topl``, the masked lookup against the reference's
``jnp.where(fresh, pq_distance(...), inf)`` and the masked rerank against
the reference's ``jnp.where(need, _exact_dist(...), acc)``.

Also: the CUDA entries refuse CPU tensors (they never hand back the plain
result), the CPU path refuses negative ids, and no module of the port — nor
chip_smoke.py — imports jax or repro.
"""
import ast
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pq as ref_pq
from repro.kernels import ops as ref_ops
from repro_torch.kernels import bitonic_topk, l2_rerank, ops, pq_adt, pq_lookup
from repro_torch.kernels import ref as port_ref

RNG = np.random.default_rng(0)
# the module, not the ``search`` function that ``repro.core`` re-exports
ref_search = importlib.import_module("repro.core.search")
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("q,m,c,dsub", [(1, 8, 64, 2), (8, 16, 256, 4),
                                        (4, 32, 256, 3), (2, 25, 128, 4),
                                        (3, 4, 64, 64)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pq_adt_plain_matches_reference(q, m, c, dsub, metric):
    qs = RNG.standard_normal((q, m * dsub)).astype(np.float32)
    cents = RNG.standard_normal((m, c, dsub)).astype(np.float32)
    got = ops.pq_adt(torch.as_tensor(qs), torch.as_tensor(cents), metric)
    for want in (ref_ops.pq_adt_ref(jnp.asarray(qs), jnp.asarray(cents), metric),
                 ref_ops.pq_adt(jnp.asarray(qs), jnp.asarray(cents), metric)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,m,c", [(1, 8, 16), (37, 16, 64), (300, 32, 256)])
def test_pq_lookup_plain_matches_reference(n, m, c):
    codes = RNG.integers(0, c, (n, m)).astype(np.uint8)
    adt = RNG.standard_normal((m, c)).astype(np.float32)
    got = ops.pq_lookup(torch.as_tensor(codes), torch.as_tensor(adt))
    for want in (ref_ops.pq_lookup_ref(jnp.asarray(codes), jnp.asarray(adt)),
                 ref_ops.pq_lookup(jnp.asarray(codes), jnp.asarray(adt))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    # the gather entry over a lane's rows is the same function
    ids = RNG.integers(0, n, (3, 11)).astype(np.int32)
    adts = np.stack([adt] * 3)
    g = ops.pq_lookup_gather(torch.as_tensor(ids), torch.as_tensor(codes),
                             torch.as_tensor(adts))
    np.testing.assert_allclose(g.numpy(), got.numpy()[ids], rtol=1e-6)


@pytest.mark.parametrize("q,n,m,c", [(3, 11, 8, 16), (4, 64, 25, 64),
                                     (2, 96, 32, 256)])
def test_pq_lookup_gather_masked_plain_matches_reference(q, n, m, c):
    """The masked lookup is the reference round's
    ``jnp.where(fresh, pq_distance(codes[ids], adt), inf)``, lane by lane."""
    big_n = 200
    codes = RNG.integers(0, c, (big_n, m)).astype(np.uint8)
    # an L2 table holds squared distances: non-negative, so no sum cancels
    # and the two summation orders agree to rtol 1e-5
    adts = RNG.random((q, m, c)).astype(np.float32)
    ids = RNG.integers(0, big_n, (q, n)).astype(np.int32)
    fresh = RNG.random((q, n)) < 0.6
    got = ops.pq_lookup_gather(torch.as_tensor(ids), torch.as_tensor(codes),
                               torch.as_tensor(adts), torch.as_tensor(fresh))
    want = jax.vmap(lambda i, a, f: jnp.where(
        f, ref_pq.pq_distance(jnp.asarray(codes)[i], a), jnp.inf))(
        jnp.asarray(ids), jnp.asarray(adts), jnp.asarray(fresh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert np.isinf(got.numpy()[~fresh]).all()


@pytest.mark.parametrize("shared", [False, True],
                         ids=["adt_per_probe", "adt_per_query"])
def test_pq_lookup_lists_plain_matches_reference(shared):
    """The lists entry is the reference's ``pq_lookup`` of each probed
    list's first ``length`` rows against the probe's ADT (one a probe, or
    one a query shared by its probes), then +inf to ``max_len``: against
    the oracle and the Pallas kernel in interpret mode, list by list, with
    an empty list, a one-row list and a full one among the probes."""
    q, p, nlist, max_len, m, c = 3, 2, 5, 40, 8, 16
    lengths = np.array([0, 1, max_len, 17, 29], np.int32)
    codes = RNG.integers(0, c, (nlist, max_len, m)).astype(np.uint8)
    probes = np.array([[0, 1], [2, 3], [4, 2]], np.int32)
    adts = RNG.random((q if shared else q * p, m, c)).astype(np.float32)
    got = ops.pq_lookup_lists(*(torch.as_tensor(a) for a in
                                (probes, lengths, codes, adts))).numpy()
    assert got.shape == (q, p, max_len)
    for i in range(q):
        for j in range(p):
            lst, n = probes[i, j], lengths[probes[i, j]]
            assert np.isinf(got[i, j, n:]).all()
            if n == 0:
                continue
            adt = jnp.asarray(adts[i if shared else i * p + j])
            rows = jnp.asarray(codes[lst, :n])
            for want in (ref_ops.pq_lookup_ref(rows, adt),
                         ref_ops.pq_lookup(rows, adt)):
                np.testing.assert_allclose(got[i, j, :n], np.asarray(want),
                                           rtol=1e-4, atol=1e-4)


def _merge_inputs(q, l, n, zeros=False):
    """A lane's list with a sorted prefix and +inf tail (-1 ids), and fresh
    candidates: few distinct keys, so ties between list and fresh entries
    and inside each are common; some fresh keys are +inf (not fresh)."""
    d = np.sort(RNG.integers(0, 6, (q, l)).astype(np.float32), axis=1)
    n_valid = RNG.integers(1, l + 1, q)
    tail = np.arange(l)[None, :] >= n_valid[:, None]
    d[tail] = np.inf
    ids = np.where(tail, -1, RNG.integers(0, 1000, (q, l))).astype(np.int32)
    acc = np.where(RNG.random((q, l)) < 0.3,
                   RNG.standard_normal((q, l)), np.inf).astype(np.float32)
    ev = RNG.random((q, l)) < 0.5
    nd = RNG.integers(0, 6, (q, n)).astype(np.float32)
    stale = RNG.random((q, n)) < 0.3
    nd[stale] = np.inf
    n_ids = np.where(stale, -1, RNG.integers(0, 1000, (q, n))).astype(np.int32)
    if zeros:                       # -0.0 and +0.0 tie like any equal keys
        d = np.where(d == 0, np.float32(-0.0), d)
        nd = np.where((nd == 0) & (RNG.random((q, n)) < 0.5),
                      np.float32(-0.0), nd)
    return ids, d, acc, ev, n_ids, nd


@pytest.mark.parametrize("l,n", [(16, 8), (128, 64)])
@pytest.mark.parametrize("zeros", [False, True], ids=["ties", "signed_zeros"])
def test_bitonic_merge_plain_matches_reference(l, n, zeros):
    """The search's merge equals the reference's ``_merge_sort_topl`` (jnp
    path, stable argsort) lane by lane, ties and +inf included: all four
    columns, bit for bit."""
    cols = _merge_inputs(5, l, n, zeros)
    got = ops.bitonic_merge_topl(*(torch.as_tensor(a) for a in cols))
    want = jax.vmap(ref_search._merge_sort_topl)(*(jnp.asarray(a)
                                                   for a in cols))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.numpy().dtype == np.asarray(w).dtype


@pytest.mark.parametrize("q,l", [(1, 32), (5, 64), (16, 256)])
def test_bitonic_plain_matches_reference(q, l):
    keys = RNG.standard_normal((q, l)).astype(np.float32)
    vals = RNG.integers(0, 1 << 20, (q, l)).astype(np.int32)
    gk, gv = ops.bitonic_sort_pairs(torch.as_tensor(keys), torch.as_tensor(vals))
    for wk, wv in (ref_ops.bitonic_sort_pairs_ref(jnp.asarray(keys),
                                                  jnp.asarray(vals)),
                   ref_ops.bitonic_sort_pairs(jnp.asarray(keys),
                                              jnp.asarray(vals))):
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_bitonic_plain_ties_match_stable_reference():
    """Ties (and +inf padding) keep input order, like the reference's
    stable argsort — the order the port's CUDA network reproduces."""
    keys = RNG.integers(0, 4, (6, 128)).astype(np.float32)
    keys[:, 100:] = np.inf
    vals = np.tile(np.arange(128, dtype=np.int32), (6, 1))
    gk, gv = ops.bitonic_sort_pairs(torch.as_tensor(keys), torch.as_tensor(vals))
    wk, wv = ref_ops.bitonic_sort_pairs_ref(jnp.asarray(keys), jnp.asarray(vals))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("q,k,d", [(1, 16, 32), (6, 64, 128), (3, 128, 96)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_l2_rerank_plain_matches_reference(q, k, d, metric):
    qs = RNG.standard_normal((q, d)).astype(np.float32)
    cands = RNG.standard_normal((q, k, d)).astype(np.float32)
    got = ops.l2_rerank(torch.as_tensor(qs), torch.as_tensor(cands), metric)
    for want in (ref_ops.l2_rerank_ref(jnp.asarray(qs), jnp.asarray(cands), metric),
                 ref_ops.l2_rerank(jnp.asarray(qs), jnp.asarray(cands), metric)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-3)
    # the masked entry, asked for every row, reads the same rows out of a
    # base table and computes their direct form
    base = cands.reshape(q * k, d)
    ids = np.arange(q * k, dtype=np.int32).reshape(q, k)
    g = ops.l2_rerank_masked(torch.as_tensor(qs), torch.as_tensor(ids),
                             torch.as_tensor(base), torch.zeros((q, k)),
                             torch.ones((q, k), dtype=torch.bool), metric)
    direct = l2_rerank.exact_dist(torch.as_tensor(qs), torch.as_tensor(cands),
                                  metric)
    np.testing.assert_allclose(g.numpy(), direct.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("q,k,d", [(3, 37, 36), (4, 128, 128), (2, 45, 21)])
@pytest.mark.parametrize("density", [1.0, 0.05, 0.0],
                         ids=["all", "sparse", "none"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_l2_rerank_masked_plain_matches_reference(q, k, d, density, metric):
    """The masked entry is the reference round's
    ``jnp.where(need, _exact_dist(q, base[max(ids, 0)]), acc)`` (jnp path,
    direct form), lane by lane; where the mask is False it hands back acc
    bit for bit, and a -1 id there is never read."""
    big_n = 300
    base = RNG.standard_normal((big_n, d)).astype(np.float32)
    qs = RNG.standard_normal((q, d)).astype(np.float32)
    mask = RNG.random((q, k)) < density
    ids = RNG.integers(0, big_n, (q, k)).astype(np.int32)
    ids[~mask & (RNG.random((q, k)) < 0.5)] = -1          # unread padding
    acc = np.where(RNG.random((q, k)) < 0.5, np.inf,
                   RNG.standard_normal((q, k))).astype(np.float32)
    got = ops.l2_rerank_masked(*(torch.as_tensor(a) for a in
                                 (qs, ids, base, acc, mask)), metric)
    want = jax.vmap(lambda qv, i, a, m: jnp.where(
        m, ref_search._exact_dist(qv, jnp.asarray(base)[jnp.maximum(i, 0)],
                                  metric), a))(
        jnp.asarray(qs), jnp.asarray(ids), jnp.asarray(acc), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_array_equal(got.numpy()[~mask], acc[~mask])


def test_ref_module_names_the_plain_versions():
    assert port_ref.pq_adt_ref is pq_adt.pq_adt_plain
    assert port_ref.pq_lookup_ref is pq_lookup.pq_lookup_plain
    assert port_ref.bitonic_sort_pairs_ref is bitonic_topk.bitonic_sort_pairs_plain
    assert port_ref.l2_rerank_ref is l2_rerank.l2_rerank_plain


def _cuda_entries():
    f32 = torch.zeros((4, 8))
    i32 = torch.zeros((4, 8), dtype=torch.int32)
    u8 = torch.zeros((4, 8), dtype=torch.uint8)
    return [
        ("pq_adt", lambda: pq_adt.pq_adt_cuda(f32, torch.zeros((2, 4, 4)))),
        ("pq_lookup", lambda: pq_lookup.pq_lookup_cuda(u8, f32)),
        ("pq_lookup_gather", lambda: pq_lookup.pq_lookup_gather_cuda(
            i32, u8, torch.zeros((4, 8, 4)))),
        ("pq_lookup_gather_masked", lambda: pq_lookup.pq_lookup_gather_cuda(
            i32, u8, torch.zeros((4, 8, 4)), torch.ones((4, 8), dtype=bool))),
        ("pq_lookup_lists", lambda: pq_lookup.pq_lookup_lists_cuda(
            i32[:, :2].contiguous(), torch.full((4,), 8, dtype=torch.int32),
            torch.zeros((4, 8, 8), dtype=torch.uint8),
            torch.zeros((8, 8, 4)))),
        ("bitonic", lambda: bitonic_topk.bitonic_sort_pairs_cuda(f32, i32)),
        ("bitonic_merge_topl", lambda: bitonic_topk.bitonic_merge_topl_cuda(
            i32, f32, f32, torch.zeros((4, 8), dtype=bool), i32, f32)),
        ("l2_rerank", lambda: l2_rerank.l2_rerank_cuda(
            torch.zeros((4, 8)), torch.zeros((4, 3, 8)))),
        ("l2_rerank_masked", lambda: l2_rerank.l2_rerank_masked_cuda(
            torch.zeros((4, 8)), i32[:, :3].contiguous(), f32,
            torch.zeros((4, 3)), torch.ones((4, 3), dtype=bool))),
    ]


@pytest.mark.parametrize("name,call", _cuda_entries(),
                         ids=[n for n, _ in _cuda_entries()])
def test_cuda_entries_refuse_cpu_tensors(name, call):
    """A CUDA entry given CPU tensors raises; it never falls back to the
    plain version."""
    from repro_torch.kernels import loader

    before = dict(loader.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert loader.LAUNCHES == before


def test_plain_gathers_refuse_negative_ids():
    ids = torch.tensor([[0, -1]], dtype=torch.int32)
    with pytest.raises(ValueError, match="negative"):
        ops.pq_lookup_gather(ids, torch.zeros((4, 2), dtype=torch.uint8),
                             torch.zeros((1, 2, 4)))
    # the masked rerank refuses a negative id only where the mask asks for
    # its row: elsewhere it hands back acc and never reads the id
    acc = torch.tensor([[1.5, 2.5]])
    with pytest.raises(ValueError, match="negative"):
        ops.l2_rerank_masked(torch.zeros((1, 8)), ids, torch.zeros((4, 8)),
                             acc, torch.tensor([[True, True]]))
    got = ops.l2_rerank_masked(torch.ones((1, 8)), ids, torch.zeros((4, 8)),
                               acc, torch.tensor([[True, False]]))
    assert got.tolist() == [[8.0, 2.5]]


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "rel", sorted(str(p.relative_to(REPO)) for p in
                  (REPO / "src" / "repro_torch").rglob("*.py"))
    + ["chip_smoke.py"])
def test_port_imports_neither_jax_nor_repro(rel):
    roots = _imported_roots(REPO / rel)
    assert not roots & {"jax", "jaxlib", "repro"}, (rel, roots)
