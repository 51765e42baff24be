"""The port's IVF-PQ baseline (``repro_torch.core.ivf``) against the
reference's (``repro.core.ivf``) on the CPU, on the 1500 x 64 sift-like set
of tests/test_ivf_reorder.py:

* ``search_ivf`` over a reference index carried across
  (``ivf_from_arrays``) gives the reference's ids and scanned counts
  exactly and its distances to rtol 1e-5 (plus 1e-6 of the largest, the
  search bar of tests/test_torch_core.py), residual and not, l2 and ip,
  nprobe 1 and 4;
* ``fill_lists`` gives the reference's list layout for the reference's
  assignment;
* ``build_ivf`` reaches the reference's recall@10 within 0.01;
* the lists' lengths (what the lookup scores of each list) count the ids
  before the -1 padding, after ``build_ivf`` and ``ivf_from_arrays``, and
  ``ivf_from_arrays`` refuses padding that is not trailing.
"""
import numpy as np
import pytest
import torch

from repro.configs.base import DatasetConfig
from repro.configs.base import PQConfig as RefPQConfig
from repro.core import recall_at_k
from repro.core.dataset import make_dataset
from repro.core.ivf import build_ivf as ref_build_ivf
from repro.core.ivf import search_ivf as ref_search_ivf
from repro_torch.configs.base import PQConfig
from repro_torch.core.ivf import (
    build_ivf, fill_lists, ivf_from_arrays, search_ivf,
)

PQ = dict(num_subvectors=16, num_centroids=64, kmeans_iters=5)
NLIST = 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's tiny tensors: the suite runs
    in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    return make_dataset(DatasetConfig(name="sift-like", num_base=1500,
                                      num_queries=24, dim=64,
                                      num_clusters=12, seed=0))


@pytest.fixture(scope="module")
def ref_ivfs(ds):
    """The reference's indexes, built once per (residual, metric)."""
    built = {}

    def get(residual, metric):
        if (residual, metric) not in built:
            built[residual, metric] = ref_build_ivf(
                ds.base, RefPQConfig(**PQ), metric, nlist=NLIST,
                residual=residual)
        return built[residual, metric]

    return get


def _port(ref):
    return ivf_from_arrays(
        coarse_centroids=ref.coarse_centroids, lists=ref.lists,
        list_codes=ref.list_codes, centroids=ref.codebook.centroids,
        residual=ref.residual, metric=ref.metric, device="cpu")


@pytest.mark.parametrize("nprobe", [1, 4])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("residual", [True, False],
                         ids=["residual", "raw"])
def test_search_ivf_matches_reference(ds, ref_ivfs, residual, metric,
                                      nprobe):
    ref = ref_ivfs(residual, metric)
    want_ids, want_d, want_n = ref_search_ivf(ref, ds.queries, 10,
                                              nprobe=nprobe)
    got_ids, got_d, got_n = search_ivf(_port(ref), ds.queries, 10,
                                       nprobe=nprobe)
    np.testing.assert_array_equal(got_ids, np.asarray(want_ids))
    np.testing.assert_array_equal(got_n, np.asarray(want_n))
    wd = np.asarray(want_d)
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(got_d), fin)
    np.testing.assert_allclose(got_d[fin], wd[fin], rtol=1e-5,
                               atol=1e-6 * np.abs(wd[fin]).max())


def test_fill_lists_matches_reference_layout(ds, ref_ivfs):
    """The reference's assignment (read back from its lists) and codes
    through ``fill_lists``: its lists and list codes, padding included."""
    ref = ref_ivfs(True, "l2")
    lists = np.asarray(ref.lists)
    valid = lists >= 0
    assign = np.empty(ds.num_base, np.int64)
    codes = np.empty((ds.num_base, ref.list_codes.shape[2]), np.uint8)
    rows = np.nonzero(valid)
    assign[lists[valid]] = rows[0]
    codes[lists[valid]] = np.asarray(ref.list_codes)[rows]
    got_lists, got_codes, got_lengths = fill_lists(torch.as_tensor(assign),
                                                   torch.as_tensor(codes),
                                                   NLIST)
    np.testing.assert_array_equal(got_lists.numpy(), lists)
    np.testing.assert_array_equal(got_lengths.numpy(), valid.sum(1))
    assert got_lengths.dtype == torch.int32
    np.testing.assert_array_equal(got_codes.numpy(),
                                  np.asarray(ref.list_codes))


@pytest.mark.parametrize("residual", [True, False],
                         ids=["residual", "raw"])
def test_build_ivf_recall_matches_reference(ds, ref_ivfs, residual):
    ref = ref_ivfs(residual, "l2")
    stages = {}
    idx = build_ivf(ds.base, PQConfig(**PQ), "l2", nlist=NLIST,
                    residual=residual, device="cpu", stage_times=stages)
    assert set(stages) == {"coarse_kmeans", "train_pq", "encode",
                           "fill_lists"}
    assert idx.lists.dtype == torch.int32 and idx.lists.shape[0] == NLIST
    ids = idx.lists.numpy()
    assert np.array_equal(np.sort(ids[ids >= 0]), np.arange(ds.num_base))
    for nprobe in (1, 4):
        got = recall_at_k(search_ivf(idx, ds.queries, 10, nprobe)[0],
                          ds.gt, 10)
        want = recall_at_k(ref_search_ivf(ref, ds.queries, 10, nprobe)[0],
                           ds.gt, 10)
        assert abs(got - want) <= 0.01, (nprobe, got, want)


@pytest.mark.parametrize("source", ["build_ivf", "ivf_from_arrays"])
def test_lengths_count_ids_before_padding(ds, ref_ivfs, source):
    if source == "build_ivf":
        idx = build_ivf(ds.base[:600], PQConfig(**PQ), "l2", nlist=NLIST,
                        device="cpu")
    else:
        idx = _port(ref_ivfs(True, "l2"))
    assert idx.lengths.dtype == torch.int32
    np.testing.assert_array_equal(idx.lengths.numpy(),
                                  (idx.lists >= 0).sum(1).numpy())


def test_ivf_from_arrays_refuses_padding_that_is_not_trailing(ref_ivfs):
    ref = ref_ivfs(True, "l2")
    lists = np.array(ref.lists, copy=True)
    row = int(np.argmax((lists >= 0).sum(1) >= 2))
    lists[row, 0] = -1                       # a hole before the list's ids
    with pytest.raises(ValueError, match="trailing"):
        ivf_from_arrays(
            coarse_centroids=ref.coarse_centroids, lists=lists,
            list_codes=ref.list_codes, centroids=ref.codebook.centroids,
            residual=ref.residual, metric=ref.metric, device="cpu")
