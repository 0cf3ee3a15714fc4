"""FleetSim in PyTorch: the NetClone testbed as tensors, a batch of
fabrics advanced tick by tick (port of ``repro.fleetsim``).

    from repro_torch.fleetsim import FleetConfig, make_params, simulate
    m = simulate(cfg, make_params(cfg, POLICY_IDS["netclone"], rate, 0))

``simulate`` runs on the CUDA device unless the caller passes
``device="cpu"``; there the default ``EngineOptions`` (``backend='auto'``)
is the fused backend, each chunk of ticks replayed from a CUDA graph, and
on the CPU the staged tick loop.  The response filter goes through the
hand-written CUDA kernels when ``FleetConfig.filter_backend`` is
``"pallas"`` or ``"tickfuse"``.
"""

from repro_torch.fleetsim.chaos import LinkFailure
from repro_torch.fleetsim.config import POLICY_IDS, POLICY_NAMES, \
    FleetConfig, ServiceSpec
from repro_torch.fleetsim.engine import RunParams, make_params, \
    params_from_numpy, simulate, stack_params
from repro_torch.fleetsim.metrics import FleetResult, summarize
from repro_torch.fleetsim.options import EngineOptions
from repro_torch.fleetsim.state import FleetState, Metrics, \
    state_from_numpy, to_numpy
from repro_torch.fleetsim.sweep import SweepResult, rack_skew, sweep_grid

__all__ = [
    "POLICY_IDS", "POLICY_NAMES", "EngineOptions", "FleetConfig",
    "FleetResult",
    "FleetState", "LinkFailure", "Metrics", "RunParams", "ServiceSpec",
    "SweepResult", "make_params", "params_from_numpy", "rack_skew",
    "simulate", "stack_params", "state_from_numpy", "summarize",
    "sweep_grid", "to_numpy",
]
