"""The paper's own configuration: the NetClone testbed cluster (§5.1); the
port's copy of ``repro.configs.netclone_cluster``.

These defaults reproduce the SIGCOMM'23 evaluation setup: 6 worker servers +
2 clients behind one Tofino ToR, 15 worker threads each, Exp(25 µs) service
with p=0.01 jitter ×15, two 2¹⁷-slot filter tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.simulator import NetworkCosts


@dataclass(frozen=True)
class ClusterConfig:
    n_servers: int = 6
    n_workers: int = 15
    n_clients: int = 2
    n_filter_tables: int = 2
    n_filter_slots: int = 2 ** 17
    costs: NetworkCosts = field(default_factory=NetworkCosts)
    # serving-tier integration defaults
    dispatch_tick_us: float = 50.0
    replica_queue_depth: int = 64


def config(**overrides) -> ClusterConfig:
    return ClusterConfig(**overrides)


def smoke_config(**overrides) -> ClusterConfig:
    kw = dict(n_servers=4, n_workers=4, n_filter_slots=256)
    kw.update(overrides)
    return ClusterConfig(**kw)
