"""The port's distributed search (``repro_torch.core.distributed``, the
plan's distributed kind and ``repro_torch.launch``) against the reference
on the CPU, over gloo process groups.

* ``shard_corpus`` equals ``repro.core.distributed.shard_corpus`` bit for
  bit (P = 1, 4, 7; P = 7 pads 1,500 rows; hot_count = 0 still replicates
  one row), and a rank's ``shard=i`` slice is row i of the stack.
* World size 1 (one gloo rank, a 1x1 mesh, made once for this module on a
  FileStore and destroyed at its end): ``distributed_search_kernel``
  returns the reference kernel's ids exactly on its 1x1 CPU mesh, and
  distances within rtol 1e-5 (plus 1e-6 of the batch's largest distance,
  the float32 rounding of a dot product, as in ``test_torch_core``), in
  both modes at E = 1 and 4, and for the accurate traversal and the
  angular metric.
* A (2, 2) mesh of 4 gloo processes (subprocesses on a FileStore, each
  holding only its own data shard), on the reference distributed test's
  1,200 x 64 config: both modes at E = 1 and 4 return the world-size-1 ids
  exactly, and as sorted sets the reference single-device search's
  (``tests/test_distributed_search.py``'s bar).
* The facade: ``Searcher.open(sc, mesh=)`` plans ``distributed``, refuses
  filters, caller masks and a missing mesh with the reference's errors, has
  no round session and no shadow oracle, labels obs counters
  ``kind="distributed"``, leaves the batch unbilled; the deprecated
  ``distributed_search`` warns and returns what the facade returns.
* ``launch.mesh.make_mesh`` and ``launch.serve`` at a tiny size.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from _torch_port import gloo_world_of_one, port_sharded
from repro.configs.base import (
    DatasetConfig, GraphConfig, PQConfig, ProximaConfig, SearchConfig,
)
from repro.core.distributed import (
    distributed_search_kernel as ref_kernel, shard_corpus as ref_shard,
)
from repro_torch.configs.base import SearchConfig as PortSearchConfig
from repro_torch.core.distributed import (
    ShardedCorpus, distributed_search, distributed_search_kernel,
)
from repro_torch.launch.mesh import chips, make_mesh
from repro_torch.plan import Searcher, SearchRequest
from repro_torch.plan.searcher import reset_legacy_warnings

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
MODES = [("nsp", 1), ("nsp", 4), ("fetch", 1), ("fetch", 4)]


def _port_cfg(cfg, **kw):
    return PortSearchConfig(**dict(dataclasses.asdict(cfg), **kw))


def _close(got, want):
    want = np.asarray(want)
    atol = 1e-6 * float(np.abs(want[np.isfinite(want)]).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    with gloo_world_of_one(tmp_path_factory.mktemp("gloo")) as m:
        yield m


@pytest.fixture(scope="module")
def ref_mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))


@pytest.mark.parametrize("p,hot", [(1, None), (4, None), (7, None), (7, 0)])
def test_shard_corpus_equals_reference(tiny_index, p, hot):
    idx = tiny_index
    hot = idx.hot_count if hot is None else hot
    args = (idx.graph.adjacency, idx.codes, idx.dataset.base,
            idx.codebook.centroids, int(idx.graph.entry_point), hot, p)
    from repro_torch.core.distributed import shard_corpus

    ref, got = ref_shard(*args), shard_corpus(*args, device="cpu")
    for f in ("adjacency", "codes", "base", "centroids", "hot_adjacency",
              "hot_codes", "hot_base"):
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.hot_adjacency.shape[0] == max(hot, 1)
    assert (got.entry_point, got.hot_count, got.num_vertices,
            got.num_shards) == (int(ref.entry_point), int(ref.hot_count),
                                ref.num_vertices, ref.num_shards)
    last = shard_corpus(*args, shard=p - 1, device="cpu")
    assert last.shard == p - 1 and last.adjacency.shape[0] == 1
    for f in ("adjacency", "codes", "base"):
        assert np.array_equal(getattr(last, f)[0].numpy(),
                              np.asarray(getattr(ref, f))[p - 1]), f


@pytest.mark.parametrize("mode,beam", MODES)
def test_world_size_one_equals_reference(tiny_index, mesh, ref_mesh, mode,
                                         beam):
    idx = tiny_index
    cfg = dataclasses.replace(idx.config.search, beam_width=beam)
    q = idx.dataset.queries
    rsc = ref_shard(idx.graph.adjacency, idx.codes, idx.dataset.base,
                    idx.codebook.centroids, int(idx.graph.entry_point),
                    idx.hot_count, 1)
    want_ids, want_d = ref_kernel(rsc, q, cfg, "l2", mode, mesh=ref_mesh)
    ids, d = distributed_search_kernel(port_sharded(idx), q, _port_cfg(cfg),
                                       "l2", mode, mesh=mesh)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    _close(d.numpy(), want_d)


@pytest.mark.parametrize("case", ["accurate", "angular"])
def test_world_size_one_accurate_and_angular(tiny_index, mesh, ref_mesh,
                                             case):
    """``use_pq=False`` (exact distances in the traversal, nsp-style in both
    modes) and the angular metric (queries normalized inside, a unit base
    passed in) equal the reference's."""
    idx = tiny_index
    cfg, base, metric = idx.config.search, idx.dataset.base, "l2"
    if case == "accurate":
        cfg = dataclasses.replace(cfg, use_pq=False)
    else:
        metric = "angular"
        base = base / np.linalg.norm(base, axis=1, keepdims=True)
    q = idx.dataset.queries
    rsc = ref_shard(idx.graph.adjacency, idx.codes, base,
                    idx.codebook.centroids, int(idx.graph.entry_point),
                    idx.hot_count, 1)
    mode = "fetch" if case == "accurate" else "nsp"
    want_ids, want_d = ref_kernel(rsc, q, cfg, metric, mode, mesh=ref_mesh)
    ids, d = distributed_search_kernel(
        port_sharded(idx, base=base), q, _port_cfg(cfg), metric, mode,
        mesh=mesh)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    _close(d.numpy(), want_d)


# ---- a (2, 2) mesh of 4 gloo processes ------------------------------------

_RANK = r"""
import datetime, json, sys
import numpy as np
import torch.distributed as dist
from repro_torch.configs.base import SearchConfig
from repro_torch.core.distributed import (
    distributed_search_kernel, shard_corpus)
from repro_torch.launch.mesh import make_mesh

rank, where = int(sys.argv[1]), sys.argv[2]
dist.init_process_group(
    "gloo", store=dist.FileStore(where + "/store", 4), rank=rank,
    world_size=4, timeout=datetime.timedelta(seconds=120))
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
a = np.load(where + "/index.npz")
sc = shard_corpus(a["adjacency"], a["codes"], a["base"], a["centroids"],
                  int(a["entry"]), int(a["hot"]), 2,
                  shard=mesh.get_local_rank("data"), device="cpu")
cfg = json.loads(open(where + "/cfg.json").read())
out = {}
for mode, beam in json.loads(sys.argv[3]):
    c = SearchConfig(**dict(cfg, beam_width=beam))
    ids, _ = distributed_search_kernel(sc, a["queries"], c, "l2", mode,
                                       mesh=mesh)
    out[f"{mode}_{beam}"] = ids.numpy()
np.savez(where + f"/out{rank}.npz", **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory, mesh):
    """The reference distributed test's index; the port's (2, 2) results of
    each rank, its world-size-1 results and the reference's single-device
    search, per (mode, E)."""
    from repro.core import build_index, graph_search

    cfg = ProximaConfig(
        dataset=DatasetConfig(name="sift-like", num_base=1200,
                              num_queries=16, dim=64, num_clusters=12,
                              seed=0),
        pq=PQConfig(num_subvectors=16, num_centroids=64, kmeans_iters=5),
        graph=GraphConfig(max_degree=16, build_list_size=32),
        search=SearchConfig(k=10, list_size=48, t_init=16, t_step=8,
                            repetition_rate=2, beta=1.06),
        hot_node_fraction=0.03,
    )
    idx = build_index(cfg, reorder_samples=16)
    where = tmp_path_factory.mktemp("mesh_2x2")
    np.savez(where / "index.npz", adjacency=idx.graph.adjacency,
             codes=idx.codes, base=idx._search_base(),
             centroids=idx.codebook.centroids,
             entry=int(idx.graph.entry_point), hot=idx.hot_count,
             queries=idx.dataset.queries)
    (where / "cfg.json").write_text(json.dumps(dataclasses.asdict(
        cfg.search)))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(where), json.dumps(MODES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = [dict(np.load(where / f"out{r}.npz")) for r in range(4)]
    sc = port_sharded(idx, base=idx._search_base())
    world1, single = {}, {}
    for mode, beam in MODES:
        c = dataclasses.replace(cfg.search, beam_width=beam)
        world1[f"{mode}_{beam}"] = distributed_search_kernel(
            sc, idx.dataset.queries, _port_cfg(c), "l2", mode,
            mesh=mesh)[0].numpy()
        single[beam] = np.asarray(graph_search(
            idx.corpus(), idx.dataset.queries, c, idx.dataset.metric).ids)
    return ranks, world1, single


@pytest.mark.parametrize("mode,beam", MODES)
def test_mesh_2x2_of_four_processes(mesh_2x2, mode, beam):
    ranks, world1, single = mesh_2x2
    key = f"{mode}_{beam}"
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[key], world1[key],
                                      err_msg=f"rank {r}")
    np.testing.assert_array_equal(np.sort(world1[key], 1),
                                  np.sort(single[beam], 1))


# ---- the facade ------------------------------------------------------------

def test_searcher_opens_the_distributed_kind(tiny_index, mesh):
    idx = tiny_index
    sc, q = port_sharded(idx), idx.dataset.queries[:8]
    cfg = _port_cfg(idx.config.search)
    s = Searcher.open(sc, cfg=cfg, mesh=mesh, mode="fetch")
    assert s.capabilities.kind == "distributed"
    assert s.capabilities.mesh_devices == chips(mesh) == 1
    assert s.plan_cfg.mode == "fetch"
    res = s.search(SearchRequest(queries=q))
    assert res.plan.kind == "distributed" and res.plan.strategy == "none"
    ids, d = distributed_search_kernel(sc, q, cfg, "l2", "fetch", mesh=mesh)
    np.testing.assert_array_equal(res.ids, ids.numpy())
    np.testing.assert_array_equal(res.dists, d.numpy())
    assert res.stats.kind == "distributed" and res.stats.queries == 8


def test_distributed_refusals(tiny_index, mesh):
    from repro_torch.filter.spec import FilterSpec

    sc = port_sharded(tiny_index)
    q = tiny_index.dataset.queries[:2]
    s = Searcher.open(sc, cfg=_port_cfg(tiny_index.config.search), mesh=mesh)
    with pytest.raises(NotImplementedError, match="no filtered traversal"):
        s.plan(SearchRequest(queries=q, filter=FilterSpec.eq("category", 1)))
    with pytest.raises(NotImplementedError, match="flat or tiled targets"):
        s.plan(SearchRequest(queries=q, node_mask=np.ones(1500, bool)))
    with pytest.raises(ValueError, match="need mesh="):
        Searcher.open(sc)
    with pytest.raises(ValueError, match="shard"):
        distributed_search_kernel(port_sharded(tiny_index, shard=0)._replace(
            shard=1), q, _port_cfg(tiny_index.config.search), mesh=mesh)


def test_distributed_plan_has_no_session_and_no_oracle(tiny_index, mesh):
    s = Searcher.open(port_sharded(tiny_index),
                      cfg=_port_cfg(tiny_index.config.search), mesh=mesh)
    q = tiny_index.dataset.queries[:3]
    plan = s.plan(SearchRequest(queries=q))
    assert s.round_session(plan) is None
    assert s.shadow_ground_truth(plan, q) is None


def test_distributed_obs_labels_and_billing(tiny_index, mesh):
    """Spans and counters carry kind="distributed"; the shadow sampler
    skips the batch and the NAND bridge counts it unbilled, as in the
    reference (no counters to bill)."""
    from repro_torch.obs import Observability
    from repro_torch.obs.nand_bridge import record_plan_execution

    obs = Observability.on(quality=True, quality_sample_rate=1.0)
    s = Searcher.open(port_sharded(tiny_index),
                      cfg=_port_cfg(tiny_index.config.search), mesh=mesh,
                      obs=obs)
    res = s.search(SearchRequest(queries=tiny_index.dataset.queries[:4]))
    m = obs.metrics
    labels = dict(kind="distributed", strategy="none", tenant=None)
    assert m.counter_value("kernel_executions", **labels) == 1
    assert m.histogram("kernel_execute_ms", **labels).count == 1
    assert m.counter_value("plans_compiled", kind="distributed",
                           strategy="none", tenant=None) == 1
    assert record_plan_execution(m, res) is None
    assert m.counter_value("nand_unbilled_batches", **labels) == 1


def test_distributed_search_warns_and_equals_facade(tiny_index, mesh):
    sc, q = port_sharded(tiny_index), tiny_index.dataset.queries[:6]
    cfg = _port_cfg(tiny_index.config.search, beam_width=4)
    reset_legacy_warnings()
    with pytest.warns(DeprecationWarning, match="distributed_search"):
        ids, d = distributed_search(sc, q, cfg, mode="nsp", mesh=mesh)
    res = Searcher.open(sc, cfg=cfg, mesh=mesh).search(
        SearchRequest(queries=q))
    np.testing.assert_array_equal(ids.numpy(), res.ids)
    np.testing.assert_array_equal(d.numpy(), res.dists)
    assert isinstance(sc, ShardedCorpus)


# ---- launch/ ---------------------------------------------------------------

def test_make_mesh_on_the_cpu(mesh):
    assert mesh.mesh_dim_names == ("data", "model")
    assert chips(mesh) == 1 and mesh.device_type == "cpu"
    assert mesh.get_local_rank("data") == mesh.get_local_rank("model") == 0


def test_launch_serve_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--num-base", "600", "--queries", "32"])
    out = capsys.readouterr().out
    assert "served 32 queries" in out
    rec = float(out.split("recall@10 ")[1].split()[0])
    assert rec >= 0.9, out
