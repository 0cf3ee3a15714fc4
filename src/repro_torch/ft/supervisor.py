"""Fleet supervisor: the control loop a 1000-node deployment runs.

Ties the fault-tolerance substrate together: heartbeats feed the
``FailureDetector``; a detected failure triggers ``plan_remesh`` (model axis
intact, data axis shrinks to the largest power of two the healthy fleet
supports), a checkpoint restore onto the new mesh, and a resume from the
last saved step; per-step host latencies feed the ``StragglerPolicy`` whose
`clone` action masks serving stragglers (NetClone tier) and whose `evict`
action feeds back into the failure set.

Hardware events are injected (this container has one host); every decision
path — detect → plan → restore → resume, strike → evict → remesh — is real
code exercised by ``tests/test_torch_checkpoint_ft.py`` and the
``examples``-level drill below:

    sup = FleetSupervisor(n_hosts=16, devices_per_host=8, model_parallel=16,
                          save_every=50, hooks=hooks)
    sup.run(n_steps=200, events={70: [("fail", 3)], 120: [("slow", 5, 4.0)]})

``hooks`` abstracts the cluster backend:
    build_mesh(plan)      -> opaque mesh handle
    train_step(mesh, step)-> per-host latencies (np.ndarray over fleet hosts)
    save(step)            -> persist checkpoint
    restore()             -> (step, state) from the latest checkpoint
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from repro_torch.ft.manager import (
    ElasticPlan,
    FailureDetector,
    StragglerPolicy,
    plan_remesh,
)


@dataclass
class SupervisorHooks:
    build_mesh: Callable[[ElasticPlan], Any]
    train_step: Callable[[Any, int], np.ndarray]
    save: Callable[[int], None]
    restore: Callable[[], int]          # returns the step to resume from


@dataclass
class SupervisorLog:
    remeshes: list = field(default_factory=list)     # (step, plan)
    evictions: list = field(default_factory=list)    # (step, host)
    clone_masks: list = field(default_factory=list)  # (step, host)
    restores: list = field(default_factory=list)     # (step_resumed,)
    steps_run: int = 0
    wasted_steps: int = 0                            # re-run after restore


class FleetSupervisor:
    def __init__(self, n_hosts: int, devices_per_host: int,
                 model_parallel: int, hooks: SupervisorHooks,
                 save_every: int = 50, heartbeat_timeout_s: float = 10.0):
        self.n_hosts = n_hosts
        self.devices_per_host = devices_per_host
        self.model_parallel = model_parallel
        self.hooks = hooks
        self.save_every = save_every
        self.detector = FailureDetector(n_hosts, timeout_s=heartbeat_timeout_s)
        self.straggler = StragglerPolicy(n_hosts)
        self.log = SupervisorLog()
        self._active_hosts = list(range(n_hosts))
        self._mesh = hooks.build_mesh(plan_remesh(
            self._active_hosts, devices_per_host, model_parallel,
            self._active_hosts))
        self._last_saved = 0

    # -- event injection (the simulated hardware layer) -----------------------
    def inject_failure(self, host: int) -> None:
        """Host stops heartbeating; the next sweep notices."""
        self.detector._last[host] = -1e18

    def inject_slowdown(self, host: int, factor: float) -> None:
        self._slow = getattr(self, "_slow", {})
        self._slow[host] = factor

    # -- the control loop ------------------------------------------------------
    def _remesh(self, step: int) -> None:
        healthy = [h for h in self.detector.healthy
                   if h in self._active_hosts]
        plan = plan_remesh(healthy, self.devices_per_host,
                           self.model_parallel, self._active_hosts)
        self._active_hosts = plan.hosts
        self._mesh = self.hooks.build_mesh(plan)
        resumed = self.hooks.restore()
        self.log.remeshes.append((step, plan))
        self.log.restores.append(resumed)
        self.log.wasted_steps += max(step - resumed, 0)

    def run(self, n_steps: int, events: dict[int, list] | None = None) -> SupervisorLog:
        events = events or {}
        step = 0
        while step < n_steps:
            for ev in events.get(step, []):
                if ev[0] == "fail":
                    self.inject_failure(ev[1])
                elif ev[0] == "slow":
                    self.inject_slowdown(ev[1], ev[2])
            # heartbeats from live hosts; sweep for the dead
            for h in self._active_hosts:
                if h in self.detector._failed or \
                        self.detector._last.get(h, 0) < 0:
                    continue
                self.detector.heartbeat(h)
            failed = self.detector.sweep()
            if failed & set(self._active_hosts):
                self._remesh(step)
                step = self.log.restores[-1]
                continue
            # run the step; observe per-host latencies
            lat = self.hooks.train_step(self._mesh, step)
            lat = np.asarray(lat, dtype=float)
            for h, f in getattr(self, "_slow", {}).items():
                if h < len(lat):
                    lat[h] *= f
            acts = self.straggler.observe(lat)
            for h, act in acts.items():
                if act == "evict" and h in self._active_hosts:
                    self.log.evictions.append((step, h))
                    self.inject_failure(h)   # treat as failed → remesh next
                elif act == "clone":
                    self.log.clone_masks.append((step, h))
            self.log.steps_run += 1
            step += 1
            if step % self.save_every == 0:
                self.hooks.save(step)
                self._last_saved = step
        return self.log
