"""Fault tolerance, port of ``repro.ft``: failure detection, elastic
remesh, straggler policy, fleet supervisor (numpy-only decision code, the
reference's, copied)."""

from repro_torch.ft.manager import (
    ElasticPlan,
    FailureDetector,
    StragglerPolicy,
    plan_remesh,
)
from repro_torch.ft.supervisor import FleetSupervisor, SupervisorHooks, \
    SupervisorLog

__all__ = ["FailureDetector", "ElasticPlan", "plan_remesh", "StragglerPolicy",
           "FleetSupervisor", "SupervisorHooks", "SupervisorLog"]
