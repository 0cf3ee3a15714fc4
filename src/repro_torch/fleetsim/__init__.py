"""FleetSim in PyTorch: the NetClone testbed as tensors, a batch of
fabrics advanced tick by tick (port of ``repro.fleetsim``).

    from repro_torch.fleetsim import FleetConfig, make_params, simulate
    m = simulate(cfg, make_params(cfg, POLICY_IDS["netclone"], rate, 0))

``simulate`` runs on the CUDA device unless the caller passes
``device="cpu"``; there the default ``EngineOptions`` (``backend='auto'``)
is the fused backend, each chunk of ticks replayed from a CUDA graph, and
on the CPU the staged tick loop.  The response filter goes through the
hand-written CUDA kernels when ``FleetConfig.filter_backend`` is
``"pallas"`` or ``"tickfuse"``.  The LÆDGE coordinator and the hedge timer
(``FleetConfig.coordinator`` / ``hedge_timer``, turned on by the policy
set) and ServeSim's continuous-batching server (``server_model="batch"``,
:mod:`repro_torch.fleetsim.llmserve`) run on both backends; FleetScope
telemetry (``FleetConfig.telemetry``, :mod:`repro_torch.fleetsim.
telemetry`) on the staged one.  :mod:`repro_torch.fleetsim.validate`
holds FleetSim to the DES, from a sweep or a scenario file, the batch
server to the serving tier's replicas (``serve_equivalence``), and a grid
sharded over devices (:mod:`repro_torch.fleetsim.shard`) to its unsharded
run (``shard_equivalence``).
"""

from repro_torch.fleetsim.chaos import LinkFailure
from repro_torch.fleetsim.config import POLICY_IDS, POLICY_NAMES, \
    FleetConfig, ServiceSpec
from repro_torch.fleetsim.engine import RunParams, make_params, \
    params_from_numpy, simulate, simulate_batch_telemetry, \
    simulate_telemetry, stack_params
from repro_torch.fleetsim.metrics import FleetResult, summarize
from repro_torch.fleetsim.options import EngineOptions
from repro_torch.fleetsim.shard import ShardedMetrics, ShardSpec, \
    simulate_batch_sharded
from repro_torch.fleetsim.state import CoordState, FabricSwitch, \
    FleetState, HedgeWheel, Metrics, init_fleet_state, state_from_numpy, \
    to_numpy
from repro_torch.fleetsim.sweep import SweepResult, rack_skew, sweep_grid
from repro_torch.fleetsim.telemetry import TelemetrySpec
from repro_torch.fleetsim.validate import CrossCheck, \
    cross_check_scenario, cross_validate, cross_validate_spec, \
    shard_equivalence

__all__ = [
    "POLICY_IDS", "POLICY_NAMES", "CoordState", "CrossCheck",
    "EngineOptions", "FabricSwitch", "FleetConfig", "FleetResult",
    "FleetState", "HedgeWheel", "LinkFailure", "Metrics", "RunParams",
    "ServiceSpec", "ShardSpec", "ShardedMetrics", "SweepResult", "TelemetrySpec",
    "cross_check_scenario", "cross_validate", "cross_validate_spec",
    "init_fleet_state", "make_params", "params_from_numpy", "rack_skew",
    "shard_equivalence", "simulate", "simulate_batch_sharded",
    "simulate_batch_telemetry",
    "simulate_telemetry", "stack_params", "state_from_numpy",
    "summarize", "sweep_grid", "to_numpy",
]
