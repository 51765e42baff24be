"""Port of ``repro.nand``: the paper's 3D NAND cost model — the device
(``device.py``) and search-engine (``engine.py``) timing/energy models and
the trace-driven simulator fed with the traversal's counters
(``simulator.py``).  Pure Python and numpy; the simulator reads the port's
counter tensors to the host in one copy at its boundary."""
from repro_torch.nand.device import NandConfig
from repro_torch.nand.engine import EngineConfig
from repro_torch.nand.simulator import (
    BuildSimResult, BuildTrace, MixedSimResult, ShardedSimResult, SimResult,
    UpdateSimResult, UpdateTrace, WorkloadTrace, filter_comparison,
    host_counters, logical_insert_bytes, simulate, simulate_build,
    simulate_mixed, simulate_sharded, simulate_updates,
    trace_from_plan_execution, trace_from_search_result,
    traces_from_plan_execution, traces_from_sharded_result,
)

__all__ = [
    "BuildSimResult", "BuildTrace", "EngineConfig", "MixedSimResult",
    "NandConfig", "ShardedSimResult", "SimResult", "UpdateSimResult",
    "UpdateTrace", "WorkloadTrace", "filter_comparison", "host_counters",
    "logical_insert_bytes", "simulate", "simulate_build", "simulate_mixed",
    "simulate_sharded", "simulate_updates", "trace_from_plan_execution",
    "trace_from_search_result", "traces_from_plan_execution",
    "traces_from_sharded_result",
]
