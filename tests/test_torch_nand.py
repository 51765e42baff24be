"""The port's NAND cost model (``repro_torch.nand``) against the reference's
(``repro.nand``), on the CPU.

The device, engine and simulator modules are copies, so on the same traces
every ``simulate*`` entry and ``filter_comparison`` give equal ``to_dict()``
output, double-buffer on and off, at several queue counts.  The one change
is at the counter reads: ``trace_from_plan_execution`` over the port's
flat, masked, scan and tiled executions of ``tiny_index`` (carried across
with ``port_index``) equals the reference's over its jnp-path executions
of the same requests, to rtol 1e-6, and the tiled per-channel traces feed
``simulate_sharded`` to the reference's figures."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import port_index
from repro.filter import FilterSpec as RefSpec
from repro.filter import random_attributes as ref_random_attributes
from repro.nand import simulator as ref_sim
from repro.nand.device import NandConfig as RefNand
from repro.nand.engine import EngineConfig as RefEngineCfg
from repro.plan import Searcher as RefSearcher
from repro.plan import SearchRequest as RefRequest
from repro_torch import nand
from repro_torch.filter import FilterSpec, random_attributes
from repro_torch.plan import Searcher, SearchRequest

SCHEMA = {"category": 8, "price": 1000}
# (field, lo, hi): ~25% pass (masked), ~1.5% (scan) on tiny_index's store
PLANS = {"flat": None, "masked": ("price", 0, 249), "scan": ("price", 0, 14)}
# the reference's test_nand trace, a hot-heavy one, a filtered one and a
# beam-parallel one without PQ
TRACES = [
    dict(hops=40, pq=200, acc=60, hot_hops=20, free_pq=100, rounds=40,
         dim=128, r_degree=64, index_bits=22, pq_bits=256),
    dict(hops=35.9, pq=1900.2, acc=112.5, hot_hops=3.77, free_pq=185.0,
         rounds=35.9, dim=128, r_degree=64, index_bits=19, pq_bits=256),
    dict(hops=52.0, pq=900.0, acc=80.0, hot_hops=4.0, free_pq=30.0,
         rounds=52.0, attr_bits=32, filter_mode="pushdown",
         filter_selectivity=0.25),
    dict(hops=60.0, pq=2400.0, acc=90.0, rounds=15.0, beam_width=4.0,
         dim=96, r_degree=32, metric="angular", use_pq=False),
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's tiny tensors: the suite runs
    in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(trace_kw):
    return nand.WorkloadTrace(**trace_kw), ref_sim.WorkloadTrace(**trace_kw)


def _configs(double_buffer):
    return (nand.NandConfig(double_buffer=double_buffer),
            RefNand(double_buffer=double_buffer))


@pytest.mark.parametrize("n_queues", [None, 32, 512])
@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("t", range(len(TRACES)))
def test_simulate_equals_reference(t, double_buffer, n_queues):
    got, want = _pair(TRACES[t])
    cfg, ref_cfg = _configs(double_buffer)
    assert nand.simulate(got, cfg, n_queues=n_queues).to_dict() == \
        ref_sim.simulate(want, ref_cfg, n_queues=n_queues).to_dict()
    assert nand.simulate(got, cfg, n_queues=n_queues).metrics() == \
        ref_sim.simulate(want, ref_cfg, n_queues=n_queues).metrics()


UPDATES = [dict(insert_rate=1e4, delete_rate=2e3, corpus_size=1_000_000),
           dict(insert_rate=0.0, consolidate_fraction=0.1, index_bits=20),
           dict(insert_rate=5e5, corpus_size=100_000, dim=96)]


@pytest.mark.parametrize("u", range(len(UPDATES)))
def test_simulate_updates_and_mixed_equal_reference(u):
    got_u = nand.UpdateTrace(**UPDATES[u])
    want_u = ref_sim.UpdateTrace(**UPDATES[u])
    assert nand.simulate_updates(got_u).to_dict() == \
        ref_sim.simulate_updates(want_u).to_dict()
    for double_buffer in (False, True):
        cfg, ref_cfg = _configs(double_buffer)
        got, want = _pair(TRACES[u])
        assert nand.simulate_mixed(got, got_u, cfg, n_queues=64).to_dict() \
            == ref_sim.simulate_mixed(want, want_u, ref_cfg,
                                      n_queues=64).to_dict()


@pytest.mark.parametrize("build", [
    dict(segment_sizes=(1500,)),
    dict(segment_sizes=(500, 500, 500), stitched_rows=412),
    dict(segment_sizes=(250_000,) * 4, stitched_rows=502_593, index_bits=19),
])
def test_simulate_build_equals_reference(build):
    assert nand.simulate_build(nand.BuildTrace(**build)).to_dict() == \
        ref_sim.simulate_build(ref_sim.BuildTrace(**build)).to_dict()


@pytest.mark.parametrize("n_queues", [None, 64])
@pytest.mark.parametrize("t", range(len(TRACES)))
def test_filter_comparison_equals_reference(t, n_queues):
    got, want = _pair(dict(TRACES[t], attr_bits=32))
    a = nand.filter_comparison(got, n_queues=n_queues)
    b = ref_sim.filter_comparison(want, n_queues=n_queues)
    assert a.keys() == b.keys()
    for key in a:
        if key in ("pushdown", "host"):
            assert a[key].to_dict() == b[key].to_dict()
        else:
            assert a[key] == b[key]


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("p", [1, 3, 4])
def test_simulate_sharded_equals_reference(p, double_buffer):
    got = [_pair(TRACES[i % len(TRACES)])[0] for i in range(p)]
    want = [_pair(TRACES[i % len(TRACES)])[1] for i in range(p)]
    cfg, ref_cfg = _configs(double_buffer)
    assert nand.simulate_sharded(got, cfg, n_queues=128).to_dict() == \
        ref_sim.simulate_sharded(want, ref_cfg, n_queues=128).to_dict()
    assert nand.EngineConfig() == nand.EngineConfig(
        **dataclasses.asdict(RefEngineCfg()))


def test_logical_insert_bytes_equals_reference():
    args = (128, 256, 64, 19)
    assert nand.logical_insert_bytes(*args) == \
        ref_sim.logical_insert_bytes(*args)


# --------------------------------------------------------------------------
# plan-derived billing on tiny_index
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_port(tiny_index):
    return port_index(tiny_index)


@pytest.fixture(scope="module")
def executions(tiny_index, tiny_port):
    """{name: (port plan result, reference plan result)} for the flat,
    masked, scan and tiled (2 cluster tiles) plans over the same queries."""
    store = random_attributes(tiny_index.dataset.num_base, SCHEMA, seed=5)
    ref_store = ref_random_attributes(tiny_index.dataset.num_base, SCHEMA,
                                      seed=5)
    q = tiny_index.dataset.queries
    out = {}
    for name, rng in PLANS.items():
        s = Searcher.open(tiny_port, attributes=store)
        rs = RefSearcher.open(tiny_index, attributes=ref_store)
        f = None if rng is None else FilterSpec.range(*rng)
        rf = None if rng is None else RefSpec.range(*rng)
        out[name] = (s.search(SearchRequest(queries=q, filter=f)),
                     rs.search(RefRequest(queries=q, filter=rf)))
    kw = dict(num_tiles=2, shard_policy="cluster")
    out["tiled"] = (
        Searcher.open(tiny_port, **kw).search(SearchRequest(queries=q)),
        RefSearcher.open(tiny_index, **kw).search(RefRequest(queries=q)))
    return out


def _assert_traces_close(got, want):
    a, b = dataclasses.asdict(got), dataclasses.asdict(want)
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], float):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-6,
                                       err_msg=key)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("use_hot", [True, False])
@pytest.mark.parametrize("name", ["flat", "masked", "scan", "tiled"])
def test_trace_from_plan_execution_equals_reference(
        tiny_index, tiny_port, executions, name, use_hot):
    got, want = executions[name]
    assert got.plan.strategy == want.plan.strategy
    assert got.plan.strategy == {"masked": "masked", "scan": "scan"}.get(
        name, "none")
    t_got = nand.trace_from_plan_execution(got, index=tiny_port,
                                           use_hot=use_hot)
    t_want = ref_sim.trace_from_plan_execution(want, index=tiny_index,
                                               use_hot=use_hot)
    _assert_traces_close(t_got, t_want)
    for double_buffer in (False, True):
        cfg, ref_cfg = _configs(double_buffer)
        a = nand.simulate(t_got, cfg).to_dict()
        b = ref_sim.simulate(t_want, ref_cfg).to_dict()
        for key in ("qps", "latency_us", "power_w", "core_utilization",
                    "round_latency_us", "overlap_saved_us"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-6,
                                       err_msg=key)


def test_tiled_channel_traces_equal_reference(tiny_index, tiny_port,
                                              executions):
    got, want = executions["tiled"]
    a = nand.traces_from_plan_execution(got, index=tiny_port)
    b = ref_sim.traces_from_plan_execution(want, index=tiny_index)
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        _assert_traces_close(x, y)
    np.testing.assert_allclose(
        nand.simulate_sharded(a).qps, ref_sim.simulate_sharded(b).qps,
        rtol=1e-6)
    with pytest.raises(ValueError, match="per-tile"):
        nand.traces_from_plan_execution(executions["flat"][0],
                                        index=tiny_port)


def test_host_counters_read_once(executions):
    """The counters of a tiled result come to the host as int64 arrays
    with their (P, Q) axes, equal to the tensors they came from."""
    got = executions["tiled"][0].raw.per_tile
    c = nand.host_counters(got)
    assert set(c) == set(nand.simulator.COUNTERS)
    for f, x in c.items():
        assert x.dtype == np.int64 and x.shape == tuple(getattr(got, f).shape)
        np.testing.assert_array_equal(x, getattr(got, f).numpy())
