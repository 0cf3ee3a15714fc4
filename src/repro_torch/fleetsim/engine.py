"""FleetSim engine, port of ``repro.fleetsim.engine``: a Python loop over
ticks advances a batch of ``G`` fabrics at once.

The reference scans :func:`~repro.fleetsim.stages.build_step` with
``lax.scan`` and sweeps it with ``vmap``; the port writes the config axis
out (every state tensor leads with ``G``).  Its staged backend loops over
the ticks on the host, one batched tick at a time (:func:`advance`); the
fused backend (:mod:`repro_torch.fleetsim.fused`) replays chunks of the
same ticks from a CUDA graph.  ``EngineOptions`` picks one
(:func:`resolve_options`).  Every random number comes from the port's
bit-exact threefry stream (:mod:`repro_torch.random`), so a run draws what
the reference's run draws.

:func:`simulate` runs on the CUDA device by default; without one it raises
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core.switch import group_pairs_array
from repro_torch.device import resolve_device
from repro_torch.fleetsim.config import FleetConfig
from repro_torch.fleetsim.stages import build_step, draw_ticks
from repro_torch.fleetsim.state import FleetState, Metrics, init_fleet_state
from repro_torch.scenarios import registry

# ticks whose uniforms are drawn together (draw_ticks)
DRAW_CHUNK = 64


class RunParams(NamedTuple):
    """Per-run inputs — the axes a sweep maps over.  Scalar fields for one
    run, or a leading ``G`` axis on every field for a batch."""

    policy_id: torch.Tensor      # () int32
    rate_per_us: torch.Tensor    # () float32 — offered arrival rate
    seed: torch.Tensor           # () int32
    slowdown: torch.Tensor       # (n_racks · S,) float32 — stragglers
    rack_weights: torch.Tensor   # (n_racks,) float32 — arrival skew
    fail_from_tick: torch.Tensor   # () int32 — fabric dark from this tick …
    fail_until_tick: torch.Tensor  # () int32 — … until this tick (wiped)
    arrival_counts: torch.Tensor   # (n_ticks,) int32 for "trace", else (0,)
    # () int32 — hedge-timer delay in ticks, a per-run sweep axis
    # (sweep_grid's hedge_delays); carried but unread without the stage
    hedge_delay_ticks: torch.Tensor
    link_from_tick: torch.Tensor   # () int32 — link-failure window …
    link_until_tick: torch.Tensor  # () int32
    link_mask: torch.Tensor        # (n_racks · S,) bool — dead links


def check_fabric_arrays(cfg: FleetConfig, slowdown=None, rack_weights=None,
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Default + shape-check the per-fabric run inputs: ``slowdown``
    flattens ``(n_racks, n_servers)`` to ``(n_racks·n_servers,)``,
    ``rack_weights`` must carry one weight per rack."""
    if slowdown is None:
        slowdown = np.ones(cfg.n_servers_total, np.float32)
    slowdown = np.asarray(slowdown, np.float32).reshape(-1)
    if slowdown.shape != (cfg.n_servers_total,):
        raise ValueError(f"slowdown must have n_racks*n_servers="
                         f"{cfg.n_servers_total} entries, got "
                         f"{slowdown.shape}")
    if rack_weights is None:
        rack_weights = np.ones(cfg.n_racks, np.float32)
    rack_weights = np.asarray(rack_weights, np.float32)
    if rack_weights.shape != (cfg.n_racks,):
        raise ValueError(f"rack_weights must have n_racks={cfg.n_racks} "
                         f"entries, got {rack_weights.shape}")
    return slowdown, rack_weights


def check_arrival_counts(cfg: FleetConfig, arrival_counts) -> np.ndarray:
    """Default + shape-check the per-tick trace counts: ``(n_ticks,)`` for
    trace runs, empty for Poisson (whose counts the engine draws)."""
    if cfg.arrival == "trace":
        if arrival_counts is None:
            raise ValueError('cfg.arrival == "trace" needs arrival_counts')
        arrival_counts = np.asarray(arrival_counts, np.int32).reshape(-1)
        if arrival_counts.shape != (cfg.n_ticks,):
            raise ValueError(f"arrival_counts must have n_ticks="
                             f"{cfg.n_ticks} entries, got "
                             f"{arrival_counts.shape}")
        return arrival_counts
    if arrival_counts is not None:
        raise ValueError("arrival_counts passed but cfg.arrival is "
                         f"{cfg.arrival!r}")
    return np.zeros((0,), np.int32)


def check_policy_stages(cfg: FleetConfig, policy_id: int) -> None:
    """A policy that needs an optional stage cannot run on a config that
    turned it off — fail at params construction, not with silent
    zero-traffic results.  An id no policy holds raises too."""
    name = registry.policy_name_map().get(int(policy_id))
    if name is None:
        raise ValueError(f"unknown policy id {policy_id}; have "
                         f"{registry.policy_id_map()}")
    if registry.needs_coordinator(name) and not cfg.coordinator:
        raise ValueError(
            f"policy {name!r} needs the coordinator stage; build the "
            "config with coordinator=True (Scenario / sweep_grid do this "
            "automatically via FleetConfig.with_policy_stages)")
    if registry.needs_hedge_timer(name) and not cfg.hedge_timer:
        raise ValueError(
            f"policy {name!r} needs the hedge_timer stage; build the "
            "config with hedge_timer=True (Scenario / sweep_grid do this "
            "automatically via FleetConfig.with_policy_stages)")


def check_hedge_delay(cfg: FleetConfig,
                      hedge_delay_us: float | None) -> int:
    """Resolve a per-run hedge delay to ticks and bound it by the static
    wheel depth (shared by :func:`make_params` and ``sweep.sweep_grid``).
    ``None`` means the config's own ``hedge_delay_us``."""
    if hedge_delay_us is None:
        return cfg.hedge_delay_ticks
    if hedge_delay_us <= 0:
        raise ValueError("hedge_delay_us must be positive")
    ticks = max(1, round(hedge_delay_us / cfg.dt_us))
    if cfg.hedge_timer and ticks >= cfg.wheel_slots:
        raise ValueError(
            f"hedge_delay_us={hedge_delay_us} is {ticks} ticks but the "
            f"timer wheel has only {cfg.wheel_slots} slots; deepen it "
            "first (FleetConfig.with_hedge_horizon — sweep_grid does this "
            "automatically for its hedge_delays axis)")
    return ticks


def make_params(cfg: FleetConfig, policy_id: int, rate_per_us: float,
                seed: int, slowdown=None, rack_weights=None,
                fail_window: tuple[int, int] | None = None,
                arrival_counts=None, hedge_delay_us: float | None = None,
                link_failure=None) -> RunParams:
    """One run's :class:`RunParams` (CPU tensors; :func:`simulate` moves
    them to its device)."""
    from repro_torch.fleetsim.chaos import check_link_failure

    slowdown, rack_weights = check_fabric_arrays(cfg, slowdown, rack_weights)
    arrival_counts = check_arrival_counts(cfg, arrival_counts)
    check_policy_stages(cfg, policy_id)
    delay_ticks = check_hedge_delay(cfg, hedge_delay_us)
    f0, f1 = fail_window if fail_window is not None \
        else (cfg.n_ticks + 1, cfg.n_ticks + 1)
    l0, l1, link_mask = check_link_failure(cfg, link_failure)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32)

    return RunParams(policy_id=i32(policy_id),
                     rate_per_us=torch.tensor(rate_per_us,
                                              dtype=torch.float32),
                     seed=i32(seed),
                     slowdown=torch.from_numpy(slowdown),
                     rack_weights=torch.from_numpy(rack_weights),
                     fail_from_tick=i32(f0),
                     fail_until_tick=i32(f1),
                     arrival_counts=torch.from_numpy(arrival_counts),
                     hedge_delay_ticks=i32(delay_ticks),
                     link_from_tick=i32(l0),
                     link_until_tick=i32(l1),
                     link_mask=torch.from_numpy(np.asarray(link_mask, bool)))


def stack_params(runs) -> RunParams:
    """One batched :class:`RunParams` from single runs' params (each field
    stacked along a new leading config axis)."""
    return RunParams(*(torch.stack(fields) for fields in zip(*runs)))


def params_from_numpy(tree) -> RunParams:
    """Port tensors (CPU) from a reference ``RunParams`` whose leaves are
    numpy arrays or scalars (e.g. from ``jax.device_get``); the fields keep
    their shapes and the reference's dtypes."""
    return RunParams(*(torch.from_numpy(np.array(x)) for x in tree))


def batched_params(params: RunParams, device) -> tuple[RunParams, bool]:
    """``params`` on ``device`` with a leading config axis, and whether the
    caller passed one."""
    ndim = params.policy_id.dim()
    if ndim > 1:
        raise ValueError(
            f"params.policy_id must be scalar (one run) or 1-D (a batched "
            f"sweep grid); got ndim={ndim}")
    out = RunParams(*(torch.as_tensor(x).to(device) for x in params))
    if ndim == 0:
        out = RunParams(*(x[None] for x in out))
    return out, ndim == 1


def init_run(cfg: FleetConfig, params: RunParams):
    """Set-up of a batched run (``params`` on its device): the initial
    state, the tick function and the ``(G, n_ticks)`` arrival counts."""
    dev = params.policy_id.device
    gp = group_pairs_array(cfg.n_servers, device=dev).long()
    keys = jr.split(jr.PRNGKey(params.seed), 2)
    k_pois, k0 = keys[:, 0], keys[:, 1]
    if cfg.arrival == "trace":
        # replayed per-tick arrival counts
        n_raw = params.arrival_counts.to(torch.int32)
    else:
        # per-tick Poisson arrival counts, drawn once before the loop
        n_raw = jr.poisson(k_pois, params.rate_per_us * cfg.dt_us,
                           cfg.n_ticks)
    return init_fleet_state(cfg, k0), build_step(cfg, params, gp), n_raw


def advance(cfg: FleetConfig, state: FleetState, step, n_raw, start: int,
            stop: int) -> FleetState:
    """Run ticks ``start … stop-1`` of a run set up by :func:`init_run`."""
    for first in range(start, stop, DRAW_CHUNK):
        draws = draw_ticks(cfg, state.key, min(DRAW_CHUNK, stop - first))
        for tick, d in enumerate(draws, first):
            state = step(state, (tick, n_raw[:, tick], d))
    return state


def _simulate_core(cfg: FleetConfig, params: RunParams) -> FleetState:
    """Run a batched ``params`` (on its device) for ``cfg.n_ticks`` ticks on
    the staged loop; returns the final state."""
    state, step, n_raw = init_run(cfg, params)
    return advance(cfg, state, step, n_raw, 0, cfg.n_ticks)


def _check_telemetry(cfg: FleetConfig) -> None:
    if not cfg.telemetry:
        raise ValueError(
            "telemetry entry points need cfg.telemetry=True (the trace "
            "ring and series stages are optional; rebuild the config, or "
            "use TelemetrySpec.apply)")


def resolve_options(cfg: FleetConfig, options, device) -> tuple[str, int]:
    """The concrete ``(backend, K)`` of a run on ``device`` under
    ``options`` (an :class:`~repro_torch.fleetsim.options.EngineOptions`
    or ``None``); ``K`` is 0 on the staged backend."""
    from repro_torch.fleetsim.options import EngineOptions

    opts = EngineOptions() if options is None else options
    if not isinstance(opts, EngineOptions):
        raise TypeError(f"options must be an EngineOptions, got "
                        f"{type(opts).__name__}")
    backend = opts.resolve_backend(cfg, device)
    if opts.telemetry:
        _check_telemetry(cfg)
    if backend == "staged":
        return backend, 0
    from repro_torch.fleetsim.fused import resolve_chunk

    return backend, resolve_chunk(cfg, opts.ticks_per_chunk)


def run_state(cfg: FleetConfig, params: RunParams, device=None,
              options=None, stats=None) -> tuple[FleetState, str, bool]:
    """Run ``params`` on ``device`` under ``options``: the final batched
    state, the concrete backend and whether ``params`` carried a batch
    axis.  ``stats`` (a :class:`~repro_torch.fleetsim.fused.GraphStats`)
    receives a fused run's graph costs."""
    dev = resolve_device(device)
    backend, k = resolve_options(cfg, options, dev)
    p, batched = batched_params(params, dev)
    for pid in torch.unique(p.policy_id).tolist():
        check_policy_stages(cfg, pid)
    if backend == "fused":
        from repro_torch.fleetsim.fused import fused_core

        return fused_core(cfg, p, k, stats), backend, batched
    return _simulate_core(cfg, p), backend, batched


def _one(tree, batched: bool):
    """A state part as the caller's params were: the batch axis dropped
    for a single run."""
    return tree if batched else type(tree)(*(x[0] for x in tree))


def run(cfg: FleetConfig, params: RunParams, device=None, options=None,
        stats=None) -> tuple[Metrics, str]:
    """:func:`simulate`'s metrics, with the concrete backend beside them;
    ``stats`` receives a fused run's graph costs."""
    state, backend, batched = run_state(cfg, params, device, options, stats)
    return _one(state.metrics, batched), backend


def simulate(cfg: FleetConfig, params: RunParams, *, device=None,
             options=None):
    """THE FleetSim entry point: run ``params`` on ``cfg``.

    ``params`` with scalar fields runs one fabric; a leading sweep axis runs
    the whole batch at once.  ``device`` defaults to CUDA; pass
    ``device="cpu"`` for the plain PyTorch path on the CPU.  ``options``
    is an :class:`~repro_torch.fleetsim.options.EngineOptions`: the default
    (``backend='auto'``) runs the fused backend on CUDA (each chunk of
    ticks replayed from a CUDA graph) and the staged loop on the CPU.
    Returns the run's :class:`Metrics` (with the batch axis when ``params``
    had one), on the run's device; with ``EngineOptions(telemetry=True)``
    (and ``cfg.telemetry``) the triple ``(metrics, trace, series)`` —
    decode it with :func:`repro_torch.fleetsim.telemetry.decode_run`.
    Telemetry only observes: the metrics are the telemetry-off run's.
    With ``EngineOptions(shard=...)`` a batched ``params`` is laid out over
    a device mesh (:func:`repro_torch.fleetsim.shard.run_sharded`) and the
    result is a :class:`~repro_torch.fleetsim.shard.ShardedMetrics`."""
    if getattr(options, "shard", None) is not None:
        if torch.as_tensor(params.policy_id).dim() != 1:
            raise ValueError(
                "EngineOptions.shard lays a sweep grid over a device mesh; "
                "params must carry a leading sweep axis (got scalar "
                "RunParams)")
        from repro_torch.fleetsim.shard import run_sharded

        backend, k = resolve_options(cfg, options, resolve_device(device))
        return run_sharded(cfg, params, options.shard, backend=backend,
                           ticks_per_chunk=k, device=device)
    state, _, batched = run_state(cfg, params, device, options)
    if options is not None and options.telemetry:
        return tuple(_one(x, batched)
                     for x in (state.metrics, state.trace, state.series))
    return _one(state.metrics, batched)


def _warn_deprecated(old: str, new: str) -> None:
    import warnings

    warnings.warn(f"repro_torch.fleetsim.{old} is deprecated; use {new}",
                  DeprecationWarning, stacklevel=3)


def simulate_telemetry(cfg: FleetConfig, params: RunParams, *,
                       device=None):
    """Deprecated, as in the reference: use ``simulate(..., options=
    EngineOptions(telemetry=True))``; returns the same ``(metrics, trace,
    series)``."""
    from repro_torch.fleetsim.options import EngineOptions

    _warn_deprecated("simulate_telemetry(cfg, params)",
                     "simulate(cfg, params, options="
                     "EngineOptions(telemetry=True))")
    return simulate(cfg, params, device=device, options=EngineOptions(
        backend="staged", telemetry=True))


def simulate_batch_telemetry(cfg: FleetConfig, params: RunParams, *,
                             device=None):
    """Deprecated, as in the reference: use ``simulate(..., options=
    EngineOptions(telemetry=True))`` with batched params."""
    from repro_torch.fleetsim.options import EngineOptions

    _warn_deprecated("simulate_batch_telemetry(cfg, params)",
                     "simulate(cfg, params, options="
                     "EngineOptions(telemetry=True)) — the leading sweep "
                     "axis selects the batched run")
    if params.policy_id.dim() != 1:
        raise ValueError("simulate_batch_telemetry needs batched params "
                         "(a leading sweep axis)")
    return simulate(cfg, params, device=device, options=EngineOptions(
        backend="staged", telemetry=True))
