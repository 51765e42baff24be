"""The rank merge (``csrc/bitonic_topk.cu`` ``rank_merge_kernel``, the
search's merge for lists of 256 or more and wherever the list and the fresh
slots exceed one warp's 1024 elements) in its own arithmetic, on the CPU:
every entry is one 64-bit word (order-preserving key, position), the fresh
words are sorted in runs, and
each word's output slot is its index in its own run plus the number of
words below it in every other run.  The blueprint is held bit for bit
against ``bitonic_merge_topl_plain`` and the reference's
``_merge_sort_topl`` (vmapped over lanes) with tied distances, -0.0 beside
+0.0, +inf padding and -1 ids.  Also: the route rule the wrapper and the
smoke read (``bitonic_topk.merge_kernel``), and the kernel's precondition
on the search's own calls: a masked search at selectivity <= 1/8 (L = 8 x
the list size) hands every merge an ascending list."""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _torch_port import port_index
from repro_torch.configs.base import FilterConfig
from repro_torch.core.search import graph_search
from repro_torch.filter import FilterSpec, adapt_search_cfg, random_attributes
from repro_torch.kernels import ops
from repro_torch.kernels.bitonic_topk import (
    RANK_FROM, WARP_ROW, bitonic_merge_topl_plain, merge_kernel,
)

ref_search = importlib.import_module("repro.core.search")
RUN = 1024          # the kernel's longest run of fresh words


def pack(keys: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The kernel's words as signed int64 in the same order: -0.0 made
    +0.0, a set sign bit flips every bit, a clear one is set; the key's 32
    bits high (shifted by 2^31 so that signed order is the unsigned one),
    the position low."""
    u = (keys + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u >= 1 << 31, u ^ 0xFFFFFFFF, u | (1 << 31))
    return (u - (1 << 31)) * (1 << 32) + pos


def rank_merge_blueprint(ids, dists, acc, evaluated, n_ids, n_dists,
                         run: int = RUN):
    """The rank merge over (Q, L) list and (Q, n) fresh columns -> the four
    (Q, L) columns of the new list."""
    q, l = ids.shape
    n = n_ids.shape[1]
    lw = pack(dists, torch.arange(l))                      # ascending
    fw = pack(n_dists, l + torch.arange(n))
    runs = [fw[:, r:r + run].sort(dim=1).values for r in range(0, n, run)]

    def below(sorted_run, words):         # words of the run below each
        return torch.searchsorted(sorted_run, words, side="left")

    list_slot = torch.arange(l).expand(q, l).clone()
    for r in runs:
        list_slot += below(r, lw)
    outs = [torch.empty_like(t) for t in (ids, dists, acc, evaluated)]
    rows = torch.arange(q)[:, None]
    keep = list_slot < l
    for o, col in zip(outs, (ids, dists, acc, evaluated)):
        o[rows.expand(q, l)[keep], list_slot[keep]] = col[keep]
    for k, r in enumerate(runs):
        slot = torch.arange(r.shape[1]) + below(lw, r)
        for k2, r2 in enumerate(runs):
            if k2 != k:
                slot += below(r2, r)
        keep = slot < l
        src = (r % (1 << 32) - l)[keep]                   # fresh position
        at = (rows.expand_as(r)[keep], slot[keep])
        outs[0][at] = n_ids[at[0], src]
        outs[1][at] = n_dists[at[0], src]
        outs[2][at] = float("inf")
        outs[3][at] = False
    return tuple(outs)


def _inputs(rng, q, l, n, zeros):
    """A lane's list (sorted prefix, +inf tail with -1 ids) and fresh
    candidates (some +inf and -1): few distinct keys, so ties within and
    across the two parts are common; with ``zeros`` the zero keys are
    -0.0 or +0.0 at random."""
    d = np.sort(rng.integers(0, 6, (q, l)).astype(np.float32), axis=1)
    tail = np.arange(l)[None, :] >= rng.integers(1, l + 1, q)[:, None]
    d[tail] = np.inf
    ids = np.where(tail, -1, rng.integers(0, 10**6, (q, l))).astype(np.int32)
    acc = np.where(rng.random((q, l)) < 0.3, rng.standard_normal((q, l)),
                   np.inf).astype(np.float32)
    ev = rng.random((q, l)) < 0.5
    nd = rng.integers(0, 6, (q, n)).astype(np.float32)
    stale = rng.random((q, n)) < 0.3
    nd[stale] = np.inf
    n_ids = np.where(stale, -1, rng.integers(0, 10**6, (q, n))).astype(
        np.int32)
    if zeros:
        d = np.where((d == 0) & (rng.random((q, l)) < 0.5), np.float32(-0.0),
                     d)
        nd = np.where((nd == 0) & (rng.random((q, n)) < 0.5),
                      np.float32(-0.0), nd)
    return ids, d, acc, ev, n_ids, nd


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        if g.dtype == np.float32:       # -0.0 is copied, not rebuilt
            np.testing.assert_array_equal(np.signbit(g), np.signbit(w))


_REF_MERGE = jax.jit(jax.vmap(ref_search._merge_sort_topl))


@functools.lru_cache(maxsize=None)
def _case(l, n):
    """Lanes with ties only (rows 0-2) and with signed zeros (rows 3-5),
    and the reference's merge of all six (one compile a shape)."""
    rng = np.random.default_rng(l + n)
    cols = [np.concatenate(p) for p in zip(_inputs(rng, 3, l, n, False),
                                           _inputs(rng, 3, l, n, True))]
    return cols, [np.asarray(t) for t in _REF_MERGE(*map(jnp.asarray, cols))]


@pytest.mark.parametrize("zeros", [False, True], ids=["ties", "signed_zeros"])
@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("l", [256, 1024, 2048])
def test_rank_blueprint_matches_plain_and_reference(l, n, zeros):
    cols, want = _case(l, n)
    rows = slice(3, 6) if zeros else slice(0, 3)
    cols = [torch.as_tensor(a[rows]) for a in cols]
    got = rank_merge_blueprint(*cols)
    _assert_bit_equal(got, bitonic_merge_topl_plain(*cols))
    _assert_bit_equal(got, [w[rows] for w in want])


@settings(max_examples=12, deadline=None)
@given(l=st.integers(1, 300), n=st.integers(0, 300), run=st.sampled_from(
    [32, 64, 128]), seed=st.integers(0, 2**16))
def test_rank_blueprint_with_several_runs(l, n, run, seed):
    """Fresh words in several sorted runs (the kernel's runs of 1024 above
    n = 1024, here shorter): each word also counts the words below it in
    the other runs."""
    cols = _inputs(np.random.default_rng(seed), 2, l, n, zeros=True)
    got = rank_merge_blueprint(*(torch.as_tensor(a) for a in cols), run=run)
    _assert_bit_equal(got, bitonic_merge_topl_plain(
        *(torch.as_tensor(a) for a in cols)))


def test_merge_route_rule():
    """The warp merge for lists shorter than 256 whose row (L +
    next_pow2(n), at least 32) fits one warp's 1024 elements, the rank
    merge otherwise: the unfiltered search's L = 128 (n = 64 or 256 at beam
    4) and the retriever's L = 64 stay on the warp, the masked search's L =
    512 and 1,024 rank."""
    assert (RANK_FROM, WARP_ROW) == (256, 1024)
    cases = {(128, 64): "warp", (128, 256): "warp", (64, 32): "warp",
             (255, 512): "warp", (255, 513): "rank", (200, 1000): "rank",
             (256, 64): "rank", (512, 64): "rank", (1024, 64): "rank",
             (1024, 256): "rank", (2048, 64): "rank", (5, 1000): "rank",
             (16, 8): "warp", (100, 60): "warp"}
    for (l, n), kind in cases.items():
        assert merge_kernel(l, n) == f"{kind}_merge_kernel", (l, n)


def test_masked_search_hands_the_merge_sorted_lists(tiny_index, monkeypatch):
    """The rank and warp merges trap on a list that does not ascend: at
    selectivity <= 1/8 the masked search's list is 8 x the list size, and
    every merge it runs gets distances that ascend row by row."""
    port = port_index(tiny_index)
    store = random_attributes(tiny_index.dataset.num_base,
                              {"category": 8, "price": 1000}, seed=5)
    mask = store.mask(FilterSpec.range("price", 0, 99))
    sel = float(mask.mean())
    assert sel <= 1 / 8
    cfg = adapt_search_cfg(port.config.search, sel, FilterConfig())
    assert cfg.list_size == 8 * port.config.search.list_size
    seen = []
    real = ops.bitonic_merge_topl

    def spy(ids, dists, acc, evaluated, n_ids, n_dists):
        seen.append(ids.shape[1])
        assert bool((dists[:, 1:] >= dists[:, :-1]).all())
        assert not bool(torch.isnan(dists).any())
        return real(ids, dists, acc, evaluated, n_ids, n_dists)

    monkeypatch.setattr(ops, "bitonic_merge_topl", spy)
    res = graph_search(port.corpus(), port.dataset.queries[:8], cfg, "l2",
                       node_mask=mask)
    assert seen and set(seen) == {cfg.list_size}
    ids = res.ids.numpy()
    assert mask[ids[ids >= 0]].all()
