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

:func:`cross_validate` and :func:`cross_validate_spec` run FleetSim
through the port's :func:`~repro_torch.fleetsim.sweep.sweep_grid`, so on a
card the grid runs on the fused backend (each chunk of ticks replayed from
a CUDA graph), and the DES (:mod:`repro_torch.core.simulator`) on the
host; :func:`cross_check_scenario` runs one
:class:`~repro_torch.scenarios.Scenario` through both.  :func:`main` is the
nightly CLI, ``python -m repro_torch.fleetsim.validate``.

A third tier, :func:`serve_equivalence` (re-exported from
:mod:`repro_torch.fleetsim.llmserve.oracle`), holds the ServeSim
batch-server stage (``FleetConfig.server_model="batch"``) to the
slot-exact :class:`repro_torch.serve.engine.DecodeReplica` ticked as the
discrete-event oracle, one decode step per tick.  Its ``SERVE_*``
tolerances are documented in the oracle module next to the three
modelling gaps they bound.  Run it from the CLI with ``--serve-ticks N``.

:func:`shard_equivalence` holds a **sharded** sweep
(:mod:`repro_torch.fleetsim.shard`) to the unsharded run of the same
grid: counters and histograms exact, derived float statistics within
:data:`SHARD_STAT_RTOL`, and the merged ``grid_hist`` equal to the sum of
the unsharded per-cell histograms.  ``--shard N`` runs it from the CLI.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, fields

import numpy as np

from repro_torch.core.simulator import Simulator
from repro_torch.core.workloads import ServiceProcess, load_to_rate
from repro_torch.fleetsim.config import FleetConfig, ServiceSpec
from repro_torch.fleetsim.llmserve.oracle import (  # noqa: F401  (re-export:
    # the ServeSim tier lives with the batch stage it validates; tolerances
    # and modelling gaps are documented there)
    SERVE_CLONE_FRAC_ATOL,
    SERVE_GOODPUT_RTOL,
    SERVE_P50_RTOL,
    SERVE_P99_RTOL,
    ServeCheck,
    serve_equivalence,
)
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

#: coordinator CPU per packet (µs) for the CPU-criticality estimate.  Both
#: engines are pinned to this value on every validator path: a Scenario
#: carries neither a NetworkCosts nor a coord_cpu_us knob, so its DES and
#: FleetSim runs use their identical defaults (NetworkCosts.coord_cpu ==
#: FleetConfig.coord_cpu_us == 1.5).
COORD_CPU_US = 1.5
#: CPU packets per fully-cloned coordinator request: request processing +
#: clone TX + two response passes
COORD_PACKETS_PER_CLONE = 4.0

# Coordinator-policy (LÆDGE) modelling notes feeding the tolerances above:
# the coordinator CPU (≈1.5 µs per packet, 4 packets per cloned request)
# saturates far below server capacity.  Once the *full-cloning* CPU demand
# (rate × 4 × coord_cpu) crosses UTIL_CRITICAL the coordinator enters a
# clone-throttling regime with no clean steady state: the DES oscillates
# between cloning and not, while FleetSim's credit model degrades smoothly
# to single-copy dispatch — so such points are classified *saturated* and,
# like every saturated point, checked only for agreement on the collapse
# itself.  FleetSim-side collapse shows up as goodput loss, server-queue
# overflow, or coordinator-ring overflow (all three accepted as the
# collapse signature).


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
        fleet_overflow_frac=(fr.n_overflow + fr.n_coord_overflow)
        / max(fr.n_arrivals, 1),
        effective_util=load * (1.0 + (des.n_cloned - des.n_clone_drops)
                               / des.n_requests),
    )


def cross_check_scenario(scenario, n_requests: int | None = None,
                         n_ticks: int | None = None, *,
                         device=None) -> CrossCheck:
    """Cross-validate one :class:`repro_torch.scenarios.Scenario` — the
    same frozen object drives both engines (comparison-by-construction),
    so this covers trace-replay scenarios too.  FleetSim runs on
    ``device`` (CUDA by default)."""
    fr = scenario.run_fleetsim(device=device,
                               **({"n_ticks": n_ticks} if n_ticks else {}))
    des = scenario.run_des(n_requests=n_requests, n_ticks=n_ticks)
    nt = n_ticks or scenario.n_ticks
    return _check_from(scenario.policy, scenario.effective_load(nt), des, fr)


def cross_validate_spec(spec, n_requests: int = 20_000,
                        n_ticks: int | None = None, *, device=None,
                        report: dict | None = None) -> list[CrossCheck]:
    """Cross-validate a declarative :class:`repro_torch.scenarios.
    SweepSpec`.

    The whole Poisson grid runs as one batch on ``device`` (CUDA by
    default, where it runs on the fused backend); each cell's DES replay
    uses the *same scenario seed*, so the comparison is knob-for-knob.
    ``n_ticks`` defaults to admitting ``n_requests`` at the sweep's lowest
    load.  ``report``, when given, receives the FleetSim sweep
    (``"fleet"``), its ticks (``"n_ticks"``) and the DES's host seconds
    (``"des_s"``).
    """
    base = spec.base
    if base.racks != 1:
        raise ValueError("cross-validation requires racks == 1 "
                         "(the DES is single-ToR)")
    if base.arrival.kind != "poisson":
        raise ValueError("cross_validate_spec sweeps Poisson load grids; "
                         "cross-check trace scenarios one at a time with "
                         "cross_check_scenario")
    if getattr(spec, "hedge_delays", ()):
        # the DES hedge policy runs its own fixed delay, so a per-run
        # delay axis has no DES counterpart to compare against
        raise ValueError("cross_validate_spec cannot sweep hedge_delays "
                         "(no DES-side delay axis); drop it from the spec "
                         "— shard_equivalence accepts it")
    if n_ticks is None:
        min_rate = min(load_to_rate(ld, base.service, base.servers,
                                    base.workers)
                       for ld in spec.resolved_loads())
        n_ticks = int(n_requests / min_rate) + 1
    fleet = spec.run_fleetsim(device=device, n_ticks=n_ticks)
    t0 = time.perf_counter()
    checks = []
    for sc in spec.scenarios():
        des = sc.run_des(n_requests=n_requests, n_ticks=n_ticks)
        fr = [r for r in fleet.results
              if r.policy == sc.policy and r.seed == sc.seed
              and abs(r.offered_load - sc.load) < 1e-9][0]
        checks.append(_check_from(sc.policy, sc.load, des, fr))
    if report is not None:
        report.update(fleet=fleet, n_ticks=n_ticks,
                      des_s=time.perf_counter() - t0)
    return checks


# --------------------------------------------------- sharded == unsharded --
#: relative tolerance on *derived float statistics* between a sharded and
#: an unsharded run of the same grid.  Counters and histograms are compared
#: exactly — each grid cell runs the identical per-configuration program,
#: sharding only changes which device runs it.
SHARD_STAT_RTOL = 1e-6


@dataclass
class ShardCheck:
    """One grid cell of a sharded-vs-unsharded comparison."""

    policy: str
    load: float
    seed: int
    hedge_delay_us: float
    counters_ok: bool     # every int field (and int tuple) exact
    stat_rel: float       # worst relative error over float statistics
    mismatched: tuple[str, ...] = ()   # field names that differed

    @property
    def stats_ok(self) -> bool:
        return self.stat_rel <= SHARD_STAT_RTOL

    @property
    def ok(self) -> bool:
        return self.counters_ok and self.stats_ok

    def describe(self) -> str:
        bad = f" mismatched={list(self.mismatched)}" if self.mismatched \
            else ""
        return (f"{self.policy}@{self.load:.2f}#s{self.seed}"
                f"(d={self.hedge_delay_us:g}): counters "
                f"{'exact' if self.counters_ok else 'DIFFER'}, "
                f"stat_rel={self.stat_rel:.2e}"
                f"[{'ok' if self.stats_ok else 'FAIL'}]{bad}")


def _float_rel(a: float, b: float) -> float:
    if math.isnan(a) and math.isnan(b):
        return 0.0
    return abs(a - b) / max(abs(a), abs(b), 1e-12)


def _compare_results(a: FleetResult, b: FleetResult) -> ShardCheck:
    counters_ok, worst, bad = True, 0.0, []
    for f in fields(FleetResult):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, (str, int)):
            exact = va == vb
        elif isinstance(va, float):
            rel = _float_rel(va, vb)
            worst = max(worst, rel)
            if rel > SHARD_STAT_RTOL:
                bad.append(f.name)
            continue
        else:  # tuples (per-rack breakouts)
            if len(va) != len(vb):
                exact = False
            elif va and isinstance(va[0], float):
                rel = max((_float_rel(x, y) for x, y in zip(va, vb)),
                          default=0.0)
                worst = max(worst, rel)
                if rel > SHARD_STAT_RTOL:
                    bad.append(f.name)
                continue
            else:
                exact = tuple(va) == tuple(vb)
        if not exact:
            counters_ok = False
            bad.append(f.name)
    return ShardCheck(policy=a.policy, load=a.offered_load, seed=a.seed,
                      hedge_delay_us=a.hedge_delay_us,
                      counters_ok=counters_ok, stat_rel=worst,
                      mismatched=tuple(bad))


def shard_equivalence(spec, shard=None, *, device=None,
                      **cfg_overrides) -> tuple[list[ShardCheck], bool]:
    """Run a :class:`repro_torch.scenarios.SweepSpec` twice on ``device``
    (CUDA by default) — unsharded and sharded (``shard``: device count /
    ``ShardSpec``; ``None`` takes the spec's own ``shard`` or every visible
    device) — and compare.

    Returns ``(per-cell checks, grid_hist_equal)``.  The aggregate check
    covers the merge: the sharded ``grid_hist`` (each slab's masked sum,
    added across slabs) must equal the host-side sum of the unsharded
    per-cell histograms exactly (integer counts)."""
    from dataclasses import replace as dc_replace

    from repro_torch.fleetsim.shard import ShardSpec, as_shard

    shard = as_shard(shard) if shard is not None \
        else (spec.shard or ShardSpec())
    plain = dc_replace(spec, shard=None)
    base = plain.run_fleetsim(device=device, **cfg_overrides)
    sharded = dc_replace(spec, shard=shard).run_fleetsim(device=device,
                                                         **cfg_overrides)
    if len(base.results) != len(sharded.results):
        raise AssertionError(
            f"grid size changed under sharding: {len(base.results)} vs "
            f"{len(sharded.results)} (padding must be stripped)")
    checks = [_compare_results(x, y)
              for x, y in zip(base.results, sharded.results)]
    hist_ok = bool(np.array_equal(np.asarray(base.grid_hist),
                                  np.asarray(sharded.grid_hist)))
    return checks, hist_ok


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
    default, where it runs on the fused backend).  Returns one
    :class:`CrossCheck` per point — callers assert ``all(c.ok for c in
    checks)`` plus whatever ordering claims they need.  ``report``, when given, receives the FleetSim sweep
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


def main(argv: list[str] | None = None) -> int:
    """Full DES cross-validation — too slow for per-PR CI, run nightly.

        PYTHONPATH=src python -m repro_torch.fleetsim.validate \
            [--requests N] [--device cuda|cpu]

    Scenario-file driven: ``--grid`` names a SweepSpec file whose
    ``policies="registered"`` default expands to *every* policy registered
    for both engines (custom registrations included), and ``--trace`` names
    a TraceArrival scenario replayed through both engines.  FleetSim runs
    on ``--device`` (CUDA by default), the DES on the host;
    ``--serve-ticks N`` adds the ServeSim tier (:func:`serve_equivalence`
    over ``N`` ticks, its replicas on ``--device`` too).  Exits non-zero if
    any point breaks the documented tolerances.  ``--shard N`` also checks
    the ``--grid`` sweep sharded over ``N`` devices (CPU slabs with
    ``--device cpu``) against its unsharded run; ``--shard 0`` takes every
    device, and under ``python -m torch.distributed.run`` every rank (one
    slab a rank, NCCL or, with ``--device cpu``, gloo; rank 0 prints).
    """
    import argparse
    import contextlib
    import io

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--requests", type=int, default=20_000,
                    help="DES requests per (policy, load) point")
    ap.add_argument("--grid", default="validate_grid",
                    help="SweepSpec JSON (path or bundled library name); "
                         "'none' skips the grid check")
    ap.add_argument("--trace", default="trace_burst",
                    help="TraceArrival scenario JSON (path or bundled "
                         "name); 'none' skips the trace check")
    ap.add_argument("--trace-ticks", type=int, default=None,
                    help="override the trace scenario's n_ticks")
    ap.add_argument("--shard", type=int, default=None,
                    help="also check sharded == unsharded on the --grid "
                         "sweep over this many devices (0: every device, "
                         "or every rank under torchrun; with --device "
                         "cpu, this many CPU slabs)")
    ap.add_argument("--shard-ticks", type=int, default=6_000,
                    help="n_ticks for the shard-equivalence sweep (exact "
                         "comparison, so short runs suffice)")
    ap.add_argument("--serve-ticks", type=int, default=0,
                    help="also run the ServeSim tier: batch-server stage "
                         "vs DecodeReplica oracle over this many ticks "
                         "(0 skips; each tick is a real decode step, so "
                         "~1500 is a thorough run)")
    ap.add_argument("--fuzz", type=int, default=0,
                    help="also run the ChaosFuzz tier: this many generated "
                         "scenarios through the fuzz contract "
                         "(repro_torch.scenarios.fuzz; 0 skips)")
    ap.add_argument("--fuzz-seed", default="0",
                    help="fuzz rng seed (integer, or 'from-date' for "
                         "today's UTC date as YYYYMMDD)")
    ap.add_argument("--fuzz-out", default="results/fuzz",
                    help="directory for shrunk fuzz counterexample JSON")
    ap.add_argument("--out", default=None,
                    help="write the cross-validation report (one row per "
                         "checked point) to this JSON artifact")
    ap.add_argument("--device", default="cuda",
                    help="where FleetSim runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    from repro_torch.launch.ranks import init_ranks, launched

    rank = 0
    if launched():
        import torch.distributed as dist

        init_ranks(args.device)
        rank = dist.get_rank()
    quiet = (contextlib.redirect_stdout(io.StringIO()) if rank
             else contextlib.nullcontext())
    with quiet:
        return _main(args, write=rank == 0)


def _main(args, write: bool) -> int:
    from repro_torch.scenarios.spec import Scenario, SweepSpec

    checks = []
    shard_checks, shard_hist_ok = [], True
    serve_checks = []
    fuzz_report = None
    if args.grid != "none":
        spec = SweepSpec.from_file(args.grid)
        print(f"== grid {args.grid}: {spec.resolved_policies()} x "
              f"{spec.resolved_loads()} ==")
        checks = cross_validate_spec(spec, n_requests=args.requests,
                                     device=args.device)
        if args.shard is not None:
            print(f"== shard equivalence: grid x {args.shard} device(s), "
                  f"{args.shard_ticks} ticks ==")
            shard_checks, shard_hist_ok = shard_equivalence(
                spec, shard=args.shard, device=args.device,
                n_ticks=args.shard_ticks)
    if args.trace != "none":
        sc = Scenario.from_file(args.trace)
        print(f"== trace {args.trace}: {sc.policy}, "
              f"{args.trace_ticks or sc.n_ticks} ticks ==")
        checks.append(cross_check_scenario(sc, n_ticks=args.trace_ticks,
                                           device=args.device))
    if args.serve_ticks:
        print(f"== serve equivalence: batch stage vs DecodeReplica, "
              f"{args.serve_ticks} ticks ==")
        serve_checks = serve_equivalence(horizon=args.serve_ticks,
                                         device=args.device)
    if args.fuzz:
        from repro_torch.scenarios.fuzz import _resolve_seed, fuzz_contract

        fuzz_seed = _resolve_seed(args.fuzz_seed)
        print(f"== fuzz tier: {args.fuzz} generated scenarios, "
              f"seed {fuzz_seed} ==")
        fuzz_report = fuzz_contract(fuzz_seed, args.fuzz,
                                    out_dir=args.fuzz_out,
                                    device=args.device)
        print(fuzz_report.describe())
    n_ok = 0
    for c in checks:
        n_ok += c.ok
        print(("[PASS] " if c.ok else "[FAIL] ") + c.describe())
    print(f"{n_ok}/{len(checks)} points within tolerance")
    n_shard_ok = 0
    if shard_checks:
        for c in shard_checks:
            n_shard_ok += c.ok
            print(("[PASS] " if c.ok else "[FAIL] ") + c.describe())
        print(("[PASS] " if shard_hist_ok else "[FAIL] ")
              + "grid_hist psum merge == host-side sum")
        print(f"{n_shard_ok}/{len(shard_checks)} sharded cells identical")
    n_serve_ok = 0
    if serve_checks:
        for c in serve_checks:
            n_serve_ok += c.ok
            print(("[PASS] " if c.ok else "[FAIL] ") + c.describe())
        print(f"{n_serve_ok}/{len(serve_checks)} serve points within "
              f"tolerance")
    if args.out and write:
        import dataclasses
        import json
        from pathlib import Path

        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({
            "grid": args.grid, "trace": args.trace,
            "requests": args.requests, "device": args.device,
            "n_ok": n_ok, "n_checks": len(checks),
            "checks": [{**dataclasses.asdict(c), "pass": bool(c.ok),
                        "saturated": bool(c.saturated),
                        "detail": c.describe()} for c in checks],
            "shard_devices": args.shard,
            "shard_grid_hist_ok": bool(shard_hist_ok),
            "shard_checks": [{**dataclasses.asdict(c), "pass": bool(c.ok),
                              "detail": c.describe()}
                             for c in shard_checks],
            "serve_ticks": args.serve_ticks,
            "serve_checks": [{**dataclasses.asdict(c), "pass": bool(c.ok),
                              "saturated": bool(c.saturated),
                              "detail": c.describe()}
                             for c in serve_checks],
            "fuzz": None if fuzz_report is None else {
                "seed": fuzz_report.seed, "n_cases": fuzz_report.n_cases,
                "n_des_checked": fuzz_report.n_des_checked,
                "pass": bool(fuzz_report.ok),
                "failures": [{"case": f.case_index, "fails": f.fails,
                              "counterexample": str(f.counterexample)}
                             for f in fuzz_report.failures],
            },
        }, indent=1))
        print(f"wrote {out}")
    fuzz_ok = fuzz_report is None or fuzz_report.ok
    serve_ok = n_serve_ok == len(serve_checks)
    shard_ok = shard_hist_ok and n_shard_ok == len(shard_checks)
    return 0 if (n_ok == len(checks) and shard_ok and serve_ok
                 and fuzz_ok) else 1


if __name__ == "__main__":
    raise SystemExit(main())
