"""User-facing sweep API: policies × loads × seeds (× delays) in one
batched run.

Port of ``repro.fleetsim.sweep`` for one device: :func:`sweep_grid` builds
the flat configuration grid and runs it through :func:`~repro_torch.
fleetsim.engine.simulate` as one batch (the config axis ``G`` is the grid).
Stragglers, switch-failure and link-failure windows are per-run inputs, so
heterogeneous scenarios ride in the same batch; ``hedge_delays`` adds the
hedge-timer delay as a fourth, per-run grid axis.

``engine`` (an :class:`~repro_torch.fleetsim.options.EngineOptions`)
selects the backend, and the result records the concrete one: on CUDA the
default is the fused backend, whose ticks replay from a CUDA graph.  A
config with ``telemetry`` runs staged and decodes each row's trace and
series (``SweepResult.telemetry``).  ``shard`` lays the grid out over
devices (:mod:`repro_torch.fleetsim.shard`), one contiguous slab of
configurations a device; ``shard=None`` keeps the single-device run.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fleetsim.chaos import check_link_failure
from repro_torch.fleetsim.config import POLICY_IDS, FleetConfig, ServiceSpec
from repro_torch.fleetsim import shard as shard_mod
from repro_torch.fleetsim.engine import (
    RunParams,
    check_fabric_arrays,
    check_hedge_delay,
    resolve_options,
    run_state,
)
from repro_torch.fleetsim.fused import GraphStats
from repro_torch.fleetsim.metrics import FleetResult, summarize
from repro_torch.fleetsim.options import EngineOptions
from repro_torch.fleetsim.shard import ShardSpec
from repro_torch.fleetsim.telemetry import RunTelemetry, decode_run
from repro_torch.fleetsim.telemetry.device import SeriesState, TraceBuffer
from repro_torch.scenarios import registry
from repro_torch.scenarios.service import load_to_rate


@dataclass
class SweepResult:
    results: list[FleetResult]
    # the batched run, device synchronised, without the fused backend's
    # graph set-up (compile_s)
    wall_clock_s: float
    n_configs: int
    simulated_requests: int
    device: str                  # e.g. "cuda:0" or "cpu"
    # execution layout: the devices the grid ran on (slabs for a CPU run)
    # and the rows padded onto the last slab
    n_devices: int = 1
    shard: ShardSpec | None = None
    n_pad: int = 0
    # the concrete engine backend the sweep ran ('staged' | 'fused')
    backend: str = "staged"
    # set-up apart from the run: the fused backend's graph warm-up,
    # capture and instantiation on CUDA (GraphStats.setup_s), plus a
    # sharded sweep's placement of its slabs; 0 otherwise
    compile_s: float = 0.0
    graph: GraphStats | None = field(default=None, repr=False)
    # grid-aggregate latency histogram (n_racks, hist_bins); a sharded
    # sweep merges each slab's masked sum (shard.ShardedMetrics)
    grid_hist: np.ndarray | None = field(default=None, repr=False)
    # per-row decoded FleetScope telemetry (same order as results) when the
    # sweep ran with cfg.telemetry; None otherwise
    telemetry: list[RunTelemetry] | None = field(default=None, repr=False)

    @property
    def simulated_mrps(self) -> float:
        """Simulated request throughput of the sweep itself (aggregate
        requests advanced per wall-clock second, in millions)."""
        return self.simulated_requests / max(self.wall_clock_s, 1e-9) / 1e6

    def select(self, policy: str | None = None,
               load: float | None = None,
               hedge_delay_us: float | None = None) -> list[FleetResult]:
        out = self.results
        if policy is not None:
            out = [r for r in out if r.policy == policy]
        if load is not None:
            out = [r for r in out if abs(r.offered_load - load) < 1e-9]
        if hedge_delay_us is not None:
            out = [r for r in out
                   if abs(r.hedge_delay_us - hedge_delay_us) < 1e-9]
        return out


def rack_skew(cfg: FleetConfig, hot_rack_weight: float = 1.0,
              straggler_rack_mult: float = 1.0,
              ) -> tuple[np.ndarray, np.ndarray]:
    """``(rack_weights, slowdown)`` for the canonical skew scenario: rack 0
    receives ``hot_rack_weight``× the per-rack arrival share of the others,
    and every server of the *last* rack runs ``straggler_rack_mult``×
    slower."""
    weights = np.ones(cfg.n_racks, np.float32)
    weights[0] = hot_rack_weight
    slowdown = np.ones((cfg.n_racks, cfg.n_servers), np.float32)
    slowdown[-1, :] = straggler_rack_mult
    return weights, slowdown.reshape(-1)


def grid_params(cfg: FleetConfig, grid, rates, slowdown, rack_weights,
                fail_window_ticks=None, link_failure=None) -> RunParams:
    """Batched :class:`RunParams` (CPU tensors) for ``(policy, load, seed,
    hedge delay)`` grid rows (a delay of ``None``: the config's own)."""
    g = len(grid)
    f0, f1 = fail_window_ticks if fail_window_ticks is not None \
        else (cfg.n_ticks + 1, cfg.n_ticks + 1)
    l0, l1, link_mask = check_link_failure(cfg, link_failure)

    def full(v):
        return torch.full((g,), v, dtype=torch.int32)

    def rows(a):
        return torch.from_numpy(np.broadcast_to(a, (g,) + a.shape).copy())

    return RunParams(
        policy_id=torch.tensor([POLICY_IDS[p] for p, *_ in grid],
                               dtype=torch.int32),
        rate_per_us=torch.tensor([rates[ld] for _, ld, *_ in grid],
                                 dtype=torch.float32),
        seed=torch.tensor([s for _, _, s, _ in grid], dtype=torch.int32),
        slowdown=rows(slowdown),
        rack_weights=rows(rack_weights),
        fail_from_tick=full(f0),
        fail_until_tick=full(f1),
        arrival_counts=torch.zeros((g, 0), dtype=torch.int32),
        hedge_delay_ticks=torch.tensor(
            [check_hedge_delay(cfg, hd) for *_, hd in grid],
            dtype=torch.int32),
        link_from_tick=full(l0),
        link_until_tick=full(l1),
        link_mask=rows(np.asarray(link_mask, bool)))


def plan_grid(service: ServiceSpec, policies: list[str], loads: list[float],
              seeds: list[int], cfg: FleetConfig | None = None,
              slowdown=None, rack_weights=None, fail_window_ticks=None,
              link_failure=None, resize_arrival_lanes: bool = True,
              hedge_delays: list[float] | None = None, **cfg_kw):
    """The batched run :func:`sweep_grid` makes: ``(cfg, grid, rates,
    params)`` with ``grid`` the ``(policy, load, seed, hedge delay)`` rows
    in batch order, ``rates`` the offered rate per load and ``params`` the
    batched :class:`RunParams` (CPU tensors)."""
    if not isinstance(service, ServiceSpec):
        raise TypeError(f"service must be a ServiceSpec, got "
                        f"{type(service).__name__}")
    if cfg is None:
        cfg = FleetConfig(service=service, **cfg_kw)
    else:
        if cfg_kw:
            raise ValueError("pass either cfg or cfg overrides, not both")
        if cfg.service != service:
            raise ValueError("cfg.service disagrees with the service argument")
    if cfg.arrival != "poisson":
        raise ValueError("sweep_grid sweeps Poisson load grids")
    if not policies or not loads or not seeds:
        raise ValueError("sweep_grid needs at least one policy, load, and "
                         "seed (got "
                         f"{len(policies)}×{len(loads)}×{len(seeds)})")
    for p in policies:
        if p not in POLICY_IDS:
            raise ValueError(f"unknown policy {p!r}; have {list(POLICY_IDS)}")
    # turn on the optional pipeline stages the policy set needs (a set
    # needing neither leaves cfg untouched)
    cfg = cfg.with_policy_stages(policies)
    if hedge_delays:
        if not any(registry.needs_hedge_timer(p) for p in policies):
            raise ValueError(
                "hedge_delays sweeps the hedge_timer stage's delay, but no "
                f"policy in {policies} uses that stage")
        cfg = cfg.with_hedge_horizon(max(hedge_delays))
    delays = list(hedge_delays) if hedge_delays else [None]
    rates = {ld: load_to_rate(ld, service, cfg.n_servers_total,
                              cfg.n_workers) for ld in loads}
    if resize_arrival_lanes:
        cfg = cfg.with_arrival_headroom(max(rates.values()))
    slowdown, rack_weights = check_fabric_arrays(cfg, slowdown, rack_weights)
    # the delay axis only multiplies policies that read the delay
    grid = [(p, ld, s, hd) for p in policies for ld in loads for s in seeds
            for hd in (delays if registry.needs_hedge_timer(p) else [None])]
    params = grid_params(cfg, grid, rates, slowdown, rack_weights,
                         fail_window_ticks, link_failure)
    return cfg, grid, rates, params


def sweep_grid(
    service: ServiceSpec,
    policies: list[str],
    loads: list[float],
    seeds: list[int],
    cfg: FleetConfig | None = None,
    slowdown: np.ndarray | None = None,
    rack_weights: np.ndarray | None = None,
    fail_window_ticks: tuple[int, int] | None = None,
    link_failure=None,
    resize_arrival_lanes: bool = True,
    hedge_delays: list[float] | None = None,
    shard=None,
    engine=None,
    device=None,
    **cfg_kw,
) -> SweepResult:
    """Run every (policy, load, seed[, hedge delay]) combination as one
    batched run on ``device`` (CUDA by default; ``"cpu"`` for the plain
    path).

    ``slowdown`` (``(n_racks·n_servers,)`` or ``(n_racks, n_servers)``)
    injects stragglers, ``rack_weights`` (``(n_racks,)``) skews arrivals
    toward hot racks (see :func:`rack_skew`), ``fail_window_ticks`` darkens
    the fabric over ``[t0, t1)`` and wipes its soft state at recovery, and
    ``link_failure`` kills the named links over its window — for every run.
    ``resize_arrival_lanes=False`` keeps ``cfg.max_arrivals`` as given
    instead of sizing the Poisson headroom for the hottest load.
    ``hedge_delays`` adds a per-run hedge-delay axis
    (``RunParams.hedge_delay_ticks``): at least one policy in the set must
    use the ``hedge_timer`` stage, the timer wheel is deepened to the
    largest delay automatically, and every hedge-policy row records its
    ``hedge_delay_us``; a policy without the hook keeps its single row
    (reported with ``hedge_delay_us=0``).  ``engine``
    (:class:`~repro_torch.fleetsim.options.EngineOptions`) selects the
    backend (default ``'auto'``: fused on CUDA, staged on the CPU); the
    result's ``backend`` records the one that ran.  With ``cfg.telemetry``
    the sweep runs staged and ``telemetry`` holds each row's decoded trace
    and series.  ``shard`` (``None`` | device count |
    :class:`~repro_torch.fleetsim.shard.ShardSpec`, or
    ``EngineOptions.shard``, not both) runs the grid as contiguous slabs
    over the spec's devices (CPU slabs for a CPU run), each on the
    selected backend; telemetry sweeps cannot shard.
    """
    opts = engine if engine is not None else EngineOptions()
    shard_spec = shard_mod.as_shard(shard)
    if shard_spec is not None and opts.shard is not None:
        raise ValueError("pass the shard layout once: either shard= or "
                         "engine=EngineOptions(shard=...), not both")
    shard_spec = shard_spec if shard_spec is not None else opts.shard
    cfg, grid, rates, params = plan_grid(
        service, policies, loads, seeds, cfg, slowdown, rack_weights,
        fail_window_ticks, link_failure, resize_arrival_lanes, hedge_delays,
        **cfg_kw)
    if cfg.telemetry and shard_spec is not None:
        raise ValueError(
            "telemetry sweeps cannot shard (per-device trace rings have no "
            "merged chronological order); drop shard= or cfg.telemetry")
    if cfg.telemetry:
        opts = replace(opts, telemetry=True)
    stats = GraphStats()
    n_devices, n_pad, grid_hist = 1, 0, None
    t0 = time.perf_counter()
    if shard_spec is None:
        state, backend, _ = run_state(cfg, params, device, opts, stats)
        met = state.metrics
    else:
        backend, k = resolve_options(cfg, replace(opts, shard=None),
                                     resolve_device(device))
        sharded = shard_mod.run_sharded(cfg, params, shard_spec,
                                        backend=backend, ticks_per_chunk=k,
                                        device=device, stats=stats)
        met, grid_hist = sharded.metrics, sharded.grid_hist.cpu().numpy()
        n_devices = len(shard_spec.mesh(device))
        n_pad = (-len(grid)) % n_devices
    metrics = type(met)(*(x.cpu().numpy() for x in met))
    setup_s = stats.setup_s
    wall = time.perf_counter() - t0 - setup_s
    telemetry = None
    if cfg.telemetry:
        trace = TraceBuffer(*(x.cpu().numpy() for x in state.trace))
        series = SeriesState(*(x.cpu().numpy() for x in state.series))
        telemetry = [
            decode_run(cfg, TraceBuffer(*(a[i] for a in trace)),
                       SeriesState(*(a[i] for a in series)))
            for i in range(len(grid))]
    # policies that never arm the wheel report delay 0, not the config
    # default a hedge co-policy happened to turn on
    results = [summarize(cfg, type(metrics)(*(a[i] for a in metrics)),
                         policy=p, load=ld, rate_per_us=rates[ld], seed=s,
                         hedge_delay_us=hd if registry.needs_hedge_timer(p)
                         else 0.0)
               for i, (p, ld, s, hd) in enumerate(grid)]
    return SweepResult(
        results=results,
        wall_clock_s=wall,
        n_configs=len(grid),
        simulated_requests=sum(r.n_arrivals for r in results),
        device=str(resolve_device(device)),
        n_devices=n_devices,
        shard=shard_spec,
        n_pad=n_pad,
        backend=backend,
        compile_s=setup_s,
        graph=stats if stats.ticks else None,
        grid_hist=(np.asarray(metrics.hist).sum(axis=0) if grid_hist is None
                   else grid_hist),
        telemetry=telemetry,
    )
