"""Fault tolerance for the training fleet: failure detection, elastic
remesh, checkpoint-restart, and straggler mitigation.

The cluster side is *simulated* (no real hardware can fail here), but every
decision path is real code exercised by tests:

* ``FailureDetector`` — heartbeat bookkeeping with a timeout; in production
  the heartbeats come from the per-host agent, here the simulator injects
  them.
* ``ElasticPlan`` — given the healthy host set, pick the largest usable mesh
  (keeping the model axis intact, shrinking the data axis), rebuild
  shardings, and restore the latest checkpoint onto the new mesh —
  checkpoint/restore is mesh-shape-agnostic by construction
  (``repro_torch.checkpoint``), so rescaling N→M is a restore, not a custom
  resharding pass.
* ``StragglerPolicy`` — the two-sided policy: for *serving*, stragglers are
  masked by NetClone request cloning (the paper's technique, first-class
  here); for *training*, a straggling step is handled by the synchronous
  fleet's only safe options — wait, or declare the host failed and remesh.
  The policy tracks per-host step latencies (EWMA + deviation) and
  recommends `wait`/`clone`/`evict`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


class FailureDetector:
    """Heartbeat-timeout failure detection over a host set."""

    def __init__(self, n_hosts: int, timeout_s: float = 10.0):
        self.n_hosts = n_hosts
        self.timeout_s = timeout_s
        self._last = {h: time.monotonic() for h in range(n_hosts)}
        self._failed: set[int] = set()

    def heartbeat(self, host: int, t: float | None = None) -> None:
        self._last[host] = time.monotonic() if t is None else t
        self._failed.discard(host)

    def sweep(self, now: float | None = None) -> set[int]:
        now = time.monotonic() if now is None else now
        for h in range(self.n_hosts):
            if h not in self._failed and now - self._last[h] > self.timeout_s:
                self._failed.add(h)
        return set(self._failed)

    @property
    def healthy(self) -> list[int]:
        return [h for h in range(self.n_hosts) if h not in self._failed]


@dataclass
class ElasticPlan:
    """A concrete remesh decision."""

    data_parallel: int
    model_parallel: int
    hosts: list[int]
    dropped_hosts: list[int]

    @property
    def n_devices_factor(self) -> float:
        return self.data_parallel * self.model_parallel


def plan_remesh(healthy_hosts: list[int], devices_per_host: int,
                model_parallel: int, prev_hosts: list[int]) -> ElasticPlan:
    """Largest power-of-two data axis over healthy hosts, model axis fixed.

    The model axis must stay intact (weights are sharded over it); the data
    axis shrinks to the largest size the healthy device count supports.
    """
    n_dev = len(healthy_hosts) * devices_per_host
    if n_dev < model_parallel:
        raise RuntimeError("not enough healthy devices for the model axis")
    dp = 1
    while dp * 2 * model_parallel <= n_dev:
        dp *= 2
    used = (dp * model_parallel + devices_per_host - 1) // devices_per_host
    hosts = healthy_hosts[:used]
    return ElasticPlan(
        data_parallel=dp,
        model_parallel=model_parallel,
        hosts=hosts,
        dropped_hosts=[h for h in prev_hosts if h not in hosts],
    )


@dataclass
class StragglerPolicy:
    """EWMA-based straggler detection with mode-dependent action."""

    n_hosts: int
    alpha: float = 0.2
    threshold: float = 3.0      # × fleet-median EWMA
    evict_after: int = 5        # consecutive straggling steps
    ewma: np.ndarray = field(default=None)
    strikes: np.ndarray = field(default=None)

    def __post_init__(self):
        if self.ewma is None:
            self.ewma = np.zeros(self.n_hosts)
        if self.strikes is None:
            self.strikes = np.zeros(self.n_hosts, dtype=np.int64)

    def observe(self, host_latencies: np.ndarray) -> dict[int, str]:
        """Feed one step's per-host latencies; returns {host: action} where
        action ∈ {"clone", "evict"} ("wait" hosts are omitted)."""
        first = self.ewma.sum() == 0
        self.ewma = (host_latencies if first
                     else (1 - self.alpha) * self.ewma
                     + self.alpha * host_latencies)
        med = float(np.median(self.ewma))
        out: dict[int, str] = {}
        for h in range(self.n_hosts):
            if med > 0 and self.ewma[h] > self.threshold * med:
                self.strikes[h] += 1
                out[h] = "evict" if self.strikes[h] >= self.evict_after \
                    else "clone"
            else:
                self.strikes[h] = 0
        return out
