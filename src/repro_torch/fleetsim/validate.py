"""Cross-validation of FleetSim against the discrete-event simulator; the
port's copy of ``repro.fleetsim.validate``.

The two engines model the same calibrated testbed with different time bases
(event-driven vs ``dt``-quantized), so they agree on *distributions and
trends*, not per-request samples.  The documented tolerances below bound the
known modelling gaps:

* latency quantization to ``dt_us`` (default 1 µs) plus the histogram's
  ≈6% geometric bin resolution;
* one-tick (≈1 µs) state-feedback staleness vs the DES's explicit link hops;
* the clone recirculation pass (0.4 µs) folded away;
* queue-length piggybacking sampled once per tick instead of per event.

``P50_RTOL``/``P99_RTOL`` are intentionally loose on the tail (p99 of a
50 k-request run is itself a noisy order statistic); the *ordering* checks
(NetClone beats baseline at low load, clone rate declines with load) are the
paper's actual claims and are enforced exactly.

:func:`cross_validate` runs FleetSim through the port's
:func:`~repro_torch.fleetsim.sweep.sweep_grid`, so on a card its grid runs
on the fused backend (each chunk of ticks replayed from a CUDA graph), and
the DES (:mod:`repro_torch.core.simulator`) on the host.

Not ported yet: :func:`cross_validate_spec` and :func:`cross_check_scenario`
take the Scenario layer's ``Scenario`` / ``SweepSpec`` (ROADMAP.md A8),
:func:`shard_equivalence` the sharded runner (A9), and the reference's
re-export of the ServeSim tier's ``serve_equivalence`` is left out until
the batch-server stage lands (A12); the first three raise
``NotImplementedError``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from repro_torch.core.simulator import Simulator
from repro_torch.core.workloads import ServiceProcess, load_to_rate
from repro_torch.fleetsim.config import FleetConfig, ServiceSpec
from repro_torch.fleetsim.metrics import FleetResult
from repro_torch.fleetsim.sweep import sweep_grid
from repro_torch.scenarios import registry

#: relative tolerance on median latency between the engines
P50_RTOL = 0.30
#: relative tolerance on p99 latency between the engines
P99_RTOL = 0.50
#: absolute tolerance on clone fraction (n_cloned / n_requests)
CLONE_FRAC_ATOL = 0.15
#: absolute tolerance on the filtered fraction of cloned requests
FILTER_FRAC_ATOL = 0.20
#: relative tolerance on delivered throughput (stationary points only)
THR_RTOL = 0.15
#: a point is *saturated* when delivered throughput collapses below this
#: fraction of offered — there is no steady state, so latency depends on run
#: length in both engines and only the collapse itself is comparable
SATURATION_THR = 0.90
#: …and *near-critical* when the effective server utilization (offered load ×
#: served copies per request) reaches this: the queue is a null-recurrent
#: random walk whose latency grows with run length in both engines
UTIL_CRITICAL = 0.95

#: coordinator CPU per packet (µs) for the CPU-criticality estimate; the
#: DES's NetworkCosts.coord_cpu and FleetConfig.coord_cpu_us default to it
COORD_CPU_US = 1.5
#: CPU packets per fully-cloned coordinator request: request processing +
#: clone TX + two response passes
COORD_PACKETS_PER_CLONE = 4.0


@dataclass
class CrossCheck:
    policy: str
    load: float
    des_p50: float
    fleet_p50: float
    des_p99: float
    fleet_p99: float
    des_clone_frac: float
    fleet_clone_frac: float
    des_filter_frac: float
    fleet_filter_frac: float
    des_goodput: float    # delivered / offered throughput
    fleet_goodput: float
    fleet_overflow_frac: float  # queue-overflow drops / arrivals
    effective_util: float  # offered load × served copies per request
    coord_cpu_demand: float = 0.0  # full-cloning coordinator CPU demand

    def _rel(self, a, b):
        return abs(a - b) / max(abs(a), abs(b), 1e-9)

    @property
    def saturated(self) -> bool:
        return (self.des_goodput < SATURATION_THR
                or self.effective_util >= UTIL_CRITICAL
                or self.coord_cpu_demand >= UTIL_CRITICAL)

    @property
    def p50_ok(self) -> bool:
        return self.saturated or \
            self._rel(self.des_p50, self.fleet_p50) <= P50_RTOL

    @property
    def p99_ok(self) -> bool:
        return self.saturated or \
            self._rel(self.des_p99, self.fleet_p99) <= P99_RTOL

    @property
    def clone_ok(self) -> bool:
        return self.saturated or \
            abs(self.des_clone_frac - self.fleet_clone_frac) \
            <= CLONE_FRAC_ATOL

    @property
    def filter_ok(self) -> bool:
        return self.saturated or \
            abs(self.des_filter_frac - self.fleet_filter_frac) \
            <= FILTER_FRAC_ATOL

    @property
    def thr_ok(self) -> bool:
        if self.des_goodput < SATURATION_THR:
            # a genuine collapse: goodput past saturation is a run-length
            # artifact in both engines, so require the *signature* of
            # collapse (goodput loss or sustained overflow shedding)
            return (self.fleet_goodput < SATURATION_THR
                    or self.fleet_overflow_frac > 0.02)
        return self._rel(self.des_goodput, self.fleet_goodput) <= THR_RTOL

    @property
    def ok(self) -> bool:
        return (self.p50_ok and self.p99_ok and self.clone_ok
                and self.filter_ok and self.thr_ok)

    def describe(self) -> str:
        sat = " [saturated: latency/clone skipped]" if self.saturated else ""
        return (f"{self.policy}@{self.load:.2f}: "
                f"p50 {self.des_p50:.0f}/{self.fleet_p50:.0f}µs"
                f"[{'ok' if self.p50_ok else 'FAIL'}] "
                f"p99 {self.des_p99:.0f}/{self.fleet_p99:.0f}µs"
                f"[{'ok' if self.p99_ok else 'FAIL'}] "
                f"clone {self.des_clone_frac:.2f}/{self.fleet_clone_frac:.2f}"
                f"[{'ok' if self.clone_ok else 'FAIL'}] "
                f"filt {self.des_filter_frac:.2f}/{self.fleet_filter_frac:.2f}"
                f"[{'ok' if self.filter_ok else 'FAIL'}] "
                f"thr {self.des_goodput:.2f}/{self.fleet_goodput:.2f}"
                f"[{'ok' if self.thr_ok else 'FAIL'}]{sat}")


def _filter_frac(n_filtered: int, n_cloned: int) -> float:
    return n_filtered / n_cloned if n_cloned else 0.0


def _check_from(policy: str, load: float, des, fr: FleetResult) -> CrossCheck:
    """Assemble one CrossCheck from a DES result + a FleetResult."""
    try:
        is_coord = registry.needs_coordinator(policy)
    except KeyError:
        is_coord = False
    coord_demand = (COORD_PACKETS_PER_CLONE * COORD_CPU_US
                    * des.offered_rate_mrps) if is_coord else 0.0
    return CrossCheck(
        coord_cpu_demand=coord_demand,
        policy=policy, load=load,
        des_p50=des.p50_us, fleet_p50=fr.p50_us,
        des_p99=des.p99_us, fleet_p99=fr.p99_us,
        des_clone_frac=des.n_cloned / des.n_requests,
        fleet_clone_frac=fr.clone_fraction,
        des_filter_frac=_filter_frac(des.n_filtered, des.n_cloned),
        fleet_filter_frac=_filter_frac(fr.n_filtered, fr.n_cloned),
        des_goodput=des.throughput_mrps / des.offered_rate_mrps,
        fleet_goodput=fr.throughput_mrps / fr.offered_rate_mrps,
        # the coordinator ring's overflow (the reference's
        # n_coord_overflow) joins here with the coordinator stage (A7)
        fleet_overflow_frac=fr.n_overflow / max(fr.n_arrivals, 1),
        effective_util=load * (1.0 + (des.n_cloned - des.n_clone_drops)
                               / des.n_requests),
    )


def cross_check_scenario(scenario, n_requests: int | None = None,
                         n_ticks: int | None = None) -> CrossCheck:
    """Cross-validate one Scenario: needs the Scenario layer."""
    raise NotImplementedError(
        "cross_check_scenario needs Scenario, which is not ported to "
        "PyTorch yet (ROADMAP.md A8)")


def cross_validate_spec(spec, n_requests: int = 20_000,
                        n_ticks: int | None = None) -> list[CrossCheck]:
    """Cross-validate a SweepSpec: needs the Scenario layer."""
    raise NotImplementedError(
        "cross_validate_spec needs SweepSpec, which is not ported to "
        "PyTorch yet (ROADMAP.md A8)")


def shard_equivalence(spec, shard=None, **cfg_overrides):
    """Sharded == unsharded on a SweepSpec: needs the sharded runner."""
    raise NotImplementedError(
        "shard_equivalence needs the sharded runner, which is not ported to "
        "PyTorch yet (ROADMAP.md A9)")


def cross_validate(
    service: ServiceProcess,
    policies: list[str],
    loads: list[float],
    n_servers: int = 4,
    n_workers: int = 8,
    n_requests: int = 20_000,
    seed: int = 0,
    cfg: FleetConfig | None = None,
    *,
    device=None,
    report: dict | None = None,
) -> list[CrossCheck]:
    """Run both engines on overlapping (policy, load) points.

    The DES runs ``n_requests`` per point; FleetSim runs long enough to admit
    at least as many (duration scaled off the *lowest* load so every point is
    covered), as one :func:`sweep_grid` batch on ``device`` (CUDA by
    default, where it runs on the fused backend).  Returns one :class:`CrossCheck` per point —
    callers assert ``all(c.ok for c in checks)`` plus whatever ordering
    claims they need.  ``report``, when given, receives the FleetSim sweep
    (``"fleet"``, its :class:`~repro_torch.fleetsim.sweep.SweepResult`) and
    the DES's host seconds (``"des_s"``).
    """
    min_rate = load_to_rate(min(loads), service, n_servers, n_workers)
    if cfg is None:
        n_ticks = int(n_requests / min_rate / 1.0) + 1
        cfg = FleetConfig(n_servers=n_servers, n_workers=n_workers,
                          n_ticks=n_ticks,
                          service=ServiceSpec.from_process(service))
    if cfg.n_racks != 1:
        # the DES models one ToR; the fabric's n_racks == 1 path is the
        # single-ToR engine, so validating it validates the shared per-rack
        # machinery of the fabric too
        raise ValueError("cross_validate requires n_racks == 1 "
                         "(the DES is single-ToR)")
    fleet = sweep_grid(ServiceSpec.from_process(service), policies, loads,
                       [seed], cfg=cfg, device=device)

    t0 = time.perf_counter()
    checks = []
    for li, load in enumerate(loads):
        for policy in policies:
            des = Simulator(policy, service, n_servers=n_servers,
                            n_workers=n_workers,
                            seed=seed + 1000 * li).run(
                offered_load=load, n_requests=n_requests)
            fr: FleetResult = fleet.select(policy=policy, load=load)[0]
            checks.append(_check_from(policy, load, des, fr))
    if report is not None:
        report.update(fleet=fleet, des_s=time.perf_counter() - t0)
    return checks
