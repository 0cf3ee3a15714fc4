"""Declarative scenarios: one frozen description, both engines; the port's
copy of ``repro.scenarios.spec``.

A :class:`Scenario` freezes everything that defines an experiment — policy,
load, seed, fabric shape, skew/failure injection, service and arrival
processes — and both engines consume it directly: :meth:`Scenario.run_des`
replays it through the discrete-event simulator, :meth:`Scenario.
run_fleetsim` through the array engine.  Cross-validation becomes
comparison-by-construction: the two runs *cannot* encode the testbed
differently, because there is only one encoding.

:class:`SweepSpec` is the declarative grid (policies × loads × seeds over a
base scenario).  ``policies="registered"`` expands to every policy the
registry can run through both engines at execution time — so registering a
custom policy automatically enters it into every such sweep.

Both round-trip to JSON (``from_file``/``to_file``); bundled files live in
``repro_torch/scenarios/library`` (byte-for-byte copies of the
reference's) and are resolvable by bare name.  The golden library scenario
reproduces ``tests/golden/fleetsim_single_tor.json`` bit-identically.

Every FleetSim run takes ``device=`` (CUDA by default, ``"cpu"`` for the
plain path; on a card the default engine is the fused backend, which
carries ``server_model="batch"`` scenarios too; a ``telemetry`` spec runs
staged).  :meth:`Scenario.run_traced` runs with FleetScope on and decodes
the trace.  A :class:`SweepSpec` with ``shard`` runs its grid sharded
over devices (:mod:`repro_torch.fleetsim.shard`).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np

from repro_torch.core.workloads import load_to_rate, rate_to_load
from repro_torch.device import resolve_device
from repro_torch.fleetsim import engine
from repro_torch.fleetsim.chaos import LinkFailure
from repro_torch.fleetsim.config import FleetConfig
from repro_torch.fleetsim.engine import make_params
from repro_torch.fleetsim.fused import GraphStats
from repro_torch.fleetsim.metrics import FleetResult, summarize
from repro_torch.fleetsim.options import EngineOptions
from repro_torch.fleetsim.shard import ShardSpec
from repro_torch.fleetsim.sweep import SweepResult, rack_skew, sweep_grid
from repro_torch.fleetsim.telemetry import RunTelemetry, TelemetrySpec, \
    decode_run
from repro_torch.scenarios import registry
from repro_torch.scenarios.arrival import (
    ArrivalProcess,
    PoissonArrival,
    arrival_from_json,
)
from repro_torch.scenarios.service import ServiceSpec

LIBRARY_DIR = Path(__file__).parent / "library"


@dataclass(frozen=True)
class Scenario:
    """One experiment, declaratively.

    ``load`` is the offered fraction of cluster capacity (Poisson arrivals);
    trace arrivals carry their own schedule and ``load`` is ignored.
    ``queue_cap``/``max_arrivals`` default to the engine's sizing
    (arrival-headroom for Poisson, the trace's max tick count for traces) —
    set them only to pin exact array shapes, as the golden scenario does.
    ``slowdown`` (per-server multipliers, ``racks × servers`` entries)
    overrides the canonical ``straggler_rack_mult`` injection.
    """

    name: str = "scenario"
    policy: str = "netclone"
    load: float = 0.5
    seed: int = 0
    racks: int = 1
    servers: int = 6
    workers: int = 15
    n_ticks: int = 50_000
    service: ServiceSpec = ServiceSpec.exponential(25.0)
    arrival: ArrivalProcess = PoissonArrival()
    hot_rack_weight: float = 1.0
    straggler_rack_mult: float = 1.0
    slowdown: tuple[float, ...] | None = None
    fail_window_ticks: tuple[int, int] | None = None
    # ChaosFuzz failure campaign (repro_torch.fleetsim.chaos): dead links for the
    # named servers/racks over a tick window, in BOTH engines
    link_failure: LinkFailure | None = None
    queue_cap: int | None = None
    max_arrivals: int | None = None
    # ServeSim: "batch" swaps the FCFS worker pool for continuous-batching
    # decode slots; batch_slots/batch_coupling mirror the FleetConfig knobs
    # (0 slots → one per worker)
    server_model: str = "fcfs"
    batch_slots: int = 0
    batch_coupling: float = 0.0
    # tick length override (µs).  LLM scenarios pin it to the model's
    # per-token decode cost so one tick is one generated token; None keeps
    # the engine default (or the trace's own dt for trace arrivals, which
    # define their schedule's time base and reject an override here).
    dt_us: float | None = None
    # FleetScope observability: None runs the exact telemetry-off tick; an
    # enabled spec turns the trace/series stages on
    telemetry: TelemetrySpec | None = None
    # engine execution options (repro_torch.fleetsim.options): None runs
    # the default ('auto' backend — fused on a card, staged on the CPU);
    # pinned options ride the JSON so a file reproduces its execution path
    engine: EngineOptions | None = None

    def __post_init__(self):
        # injection windows are validated at spec load: a window hanging
        # past the horizon would otherwise silently truncate (the engines
        # only ever compare tick against the window edges)
        if self.fail_window_ticks is not None:
            f0, f1 = self.fail_window_ticks
            if not 0 <= f0 < f1 <= self.n_ticks:
                raise ValueError(
                    f"fail_window_ticks [{f0}, {f1}) must satisfy 0 <= "
                    f"start < end <= n_ticks={self.n_ticks}; shrink the "
                    "window or raise n_ticks")
        if self.link_failure is not None:
            l0, l1 = self.link_failure.window
            if l1 > self.n_ticks:
                raise ValueError(
                    f"link_failure window [{l0}, {l1}) exceeds "
                    f"n_ticks={self.n_ticks}; shrink start_tick/duration "
                    "or raise n_ticks")
            # fail fast on out-of-range rack/server ids too (one line, at
            # load time — not a gather error from inside a trace)
            self.link_failure.mask(self.racks, self.servers)

    # ------------------------------------------------------------ derived --
    @property
    def n_servers_total(self) -> int:
        return self.racks * self.servers

    def rate_per_us(self, n_ticks: int | None = None) -> float:
        """Offered arrival rate: load-derived for Poisson, the replayed
        sequence's own mean for traces."""
        rate = load_to_rate(self.load, self.service,
                            self.n_servers_total, self.workers)
        return self.arrival.mean_rate_per_us(rate, n_ticks or self.n_ticks)

    def effective_load(self, n_ticks: int | None = None) -> float:
        """Offered load; recomputed from the trace mean for trace runs."""
        if self.arrival.kind == "poisson":
            return self.load
        return rate_to_load(self.rate_per_us(n_ticks), self.service,
                            self.n_servers_total, self.workers)

    # ----------------------------------------------------------- fleetsim --
    def fleet_config(self, **overrides) -> FleetConfig:
        """The static FleetSim configuration this scenario pins down."""
        kw = dict(n_racks=self.racks, n_servers=self.servers,
                  n_workers=self.workers, n_ticks=self.n_ticks,
                  service=self.service, arrival=self.arrival.kind)
        if self.arrival.kind == "trace":
            if self.dt_us is not None:
                raise ValueError("dt_us cannot be overridden for trace "
                                 "arrivals; the trace defines its own time "
                                 "base (TraceArrival.dt_us)")
            kw["dt_us"] = self.arrival.dt_us
        elif self.dt_us is not None:
            kw["dt_us"] = self.dt_us
        if self.server_model != "fcfs":
            kw["server_model"] = self.server_model
            kw["batch_slots"] = self.batch_slots
            kw["batch_coupling"] = self.batch_coupling
        elif self.batch_slots or self.batch_coupling:
            raise ValueError("batch_slots / batch_coupling only apply to "
                             "server_model='batch'")
        if self.queue_cap is not None:
            kw["queue_cap"] = self.queue_cap
        if self.max_arrivals is not None:
            kw["max_arrivals"] = self.max_arrivals
        kw.update(overrides)
        cfg = FleetConfig(**kw)
        # turn on the optional pipeline stages this policy needs
        # (coordinator / hedge_timer registry hooks); stage-less policies
        # keep the exact config they always had
        cfg = cfg.with_policy_stages([self.policy])
        if self.max_arrivals is None and "max_arrivals" not in overrides:
            if self.arrival.kind == "trace":
                lanes = max(4, self.arrival.max_count(cfg.n_ticks))
                cfg = replace(cfg, max_arrivals=lanes)
            else:
                cfg = cfg.with_arrival_headroom(self.rate_per_us(cfg.n_ticks))
        if self.telemetry is not None:
            cfg = self.telemetry.apply(cfg)
        return cfg

    def run_params(self, cfg: FleetConfig):
        """Per-run inputs for :func:`repro_torch.fleetsim.engine.simulate`."""
        d = registry.get(self.policy)
        if d.policy_id is None:
            raise ValueError(f"policy {self.policy!r} has no array-engine "
                             "id; it can only run through the DES")
        weights, slowdown = rack_skew(cfg, self.hot_rack_weight,
                                      self.straggler_rack_mult)
        if self.slowdown is not None:
            slowdown = np.asarray(self.slowdown, np.float32).reshape(-1)
        return make_params(
            cfg, d.policy_id, self.rate_per_us(cfg.n_ticks), self.seed,
            slowdown=slowdown, rack_weights=weights,
            fail_window=self.fail_window_ticks,
            arrival_counts=self.arrival.tick_counts(cfg.n_ticks),
            link_failure=self.link_failure)

    def fleet_metrics(self, *, device=None, stats=None, **cfg_overrides):
        """Run the array engine on ``device`` (CUDA by default); returns
        ``(cfg, Metrics)`` (tensors on the run's device) after the run's
        last op finished.  ``stats`` (a :class:`~repro_torch.fleetsim.
        fused.GraphStats`) receives a fused run's graph costs."""
        cfg = self.fleet_config(**cfg_overrides)
        m, _ = engine.run(cfg, self.run_params(cfg), device, self.engine,
                          stats)
        _synchronize(m)
        return cfg, m

    def run_fleetsim(self, *, device=None, **cfg_overrides) -> FleetResult:
        cfg, m = self.fleet_metrics(device=device, **cfg_overrides)
        return summarize(cfg, m, policy=self.policy,
                         load=self.effective_load(cfg.n_ticks),
                         rate_per_us=self.rate_per_us(cfg.n_ticks),
                         seed=self.seed)

    def run_traced(self, *, device=None, **cfg_overrides
                   ) -> tuple[FleetResult, RunTelemetry]:
        """Run the array engine on ``device`` with FleetScope on and decode
        the trace.

        A scenario without a ``telemetry`` spec gets the default one turned
        on for this run; the result's counters are bit-identical either way
        (telemetry observes, it never feeds back).  The run is staged, as
        in the reference.  Export the bundle with :func:`repro_torch.
        fleetsim.telemetry.write_run`."""
        sc = self if self.telemetry is not None and self.telemetry.enabled \
            else replace(self, telemetry=TelemetrySpec())
        cfg = sc.fleet_config(**cfg_overrides)
        opts = replace(self.engine or EngineOptions(),
                       telemetry=True, shard=None)
        m, trace, series = engine.simulate(cfg, sc.run_params(cfg),
                                           device=device, options=opts)
        result = summarize(cfg, m, policy=self.policy,
                           load=self.effective_load(cfg.n_ticks),
                           rate_per_us=self.rate_per_us(cfg.n_ticks),
                           seed=self.seed)
        return result, decode_run(cfg, trace, series)

    # ---------------------------------------------------------------- DES --
    def run_des(self, n_requests: int | None = None,
                n_ticks: int | None = None, **run_kw):
        """Replay through the discrete-event simulator (single ToR, on the
        host)."""
        from repro_torch.core.simulator import Simulator

        if self.racks != 1:
            raise ValueError("the DES models a single ToR; scenario has "
                             f"racks={self.racks}")
        if self.server_model != "fcfs":
            raise ValueError(
                "the DES models FCFS worker pools; batch-server scenarios "
                "cross-validate against the DecodeReplica oracle instead "
                "(serve_equivalence)")
        if (self.hot_rack_weight != 1.0 or self.straggler_rack_mult != 1.0
                or self.slowdown is not None):
            raise ValueError("the DES does not model slowdown / rack-skew "
                             "injection")
        svc = self.service.to_process()
        sim = Simulator(self.policy, svc, n_servers=self.servers,
                        n_workers=self.workers, seed=self.seed)
        nt = n_ticks or self.n_ticks
        dt = self.arrival.dt_us if self.arrival.kind == "trace" else 1.0
        if self.fail_window_ticks is not None:
            f0, f1 = self.fail_window_ticks
            sim.schedule_switch_failure(f0 * dt, f1 * dt)
        if self.link_failure is not None:
            l0, l1 = self.link_failure.window
            dead = np.nonzero(self.link_failure.mask(1, self.servers))[0]
            sim.schedule_link_failure(l0 * dt, l1 * dt, dead)
        if self.arrival.kind == "trace":
            return sim.run(arrival=self.arrival, n_ticks=nt, **run_kw)
        if n_requests is None:
            n_requests = int(np.clip(self.rate_per_us() * nt, 1_000, 50_000))
        # non-trace processes answer through their own des_times (for the
        # stock PoissonArrival this is draw-identical to arrival=None)
        return sim.run(offered_load=self.load, n_requests=n_requests,
                       arrival=self.arrival, n_ticks=nt, **run_kw)

    # --------------------------------------------------------------- JSON --
    def to_json(self) -> dict:
        d = {
            "name": self.name, "policy": self.policy, "load": self.load,
            "seed": self.seed, "racks": self.racks, "servers": self.servers,
            "workers": self.workers, "n_ticks": self.n_ticks,
            "service": self.service.to_json(),
            "arrival": self.arrival.to_json(),
            "hot_rack_weight": self.hot_rack_weight,
            "straggler_rack_mult": self.straggler_rack_mult,
        }
        if self.slowdown is not None:
            d["slowdown"] = list(self.slowdown)
        if self.fail_window_ticks is not None:
            d["fail_window_ticks"] = list(self.fail_window_ticks)
        if self.link_failure is not None:
            d["link_failure"] = self.link_failure.to_json()
        if self.queue_cap is not None:
            d["queue_cap"] = self.queue_cap
        if self.max_arrivals is not None:
            d["max_arrivals"] = self.max_arrivals
        if self.server_model != "fcfs":
            d["server_model"] = self.server_model
            if self.batch_slots:
                d["batch_slots"] = self.batch_slots
            if self.batch_coupling:
                d["batch_coupling"] = self.batch_coupling
        if self.dt_us is not None:
            d["dt_us"] = self.dt_us
        if self.telemetry is not None:
            d["telemetry"] = self.telemetry.to_json()
        if self.engine is not None:
            d["engine"] = self.engine.to_json()
        return d

    _JSON_KEYS = ("name", "policy", "load", "seed", "racks", "servers",
                  "workers", "n_ticks", "hot_rack_weight",
                  "straggler_rack_mult", "queue_cap", "max_arrivals",
                  "server_model", "batch_slots", "batch_coupling", "dt_us",
                  "service", "arrival", "slowdown", "fail_window_ticks",
                  "link_failure", "telemetry", "engine")

    @classmethod
    def from_json(cls, d: dict) -> "Scenario":
        unknown = sorted(set(d) - set(cls._JSON_KEYS))
        if unknown:
            # files are the API: a misspelled knob must not silently run a
            # different experiment than the one written down
            raise ValueError(f"unknown scenario keys {unknown}; "
                             f"valid: {sorted(cls._JSON_KEYS)}")
        kw = {k: d[k] for k in cls._JSON_KEYS
              if k in d and k not in ("service", "arrival", "slowdown",
                                      "fail_window_ticks", "link_failure",
                                      "telemetry", "engine")}
        if "service" in d:
            kw["service"] = ServiceSpec.from_json(d["service"])
        kw["arrival"] = arrival_from_json(d.get("arrival"))
        if d.get("slowdown") is not None:
            kw["slowdown"] = tuple(float(v) for v in d["slowdown"])
        if d.get("fail_window_ticks") is not None:
            kw["fail_window_ticks"] = tuple(d["fail_window_ticks"])
        if d.get("link_failure") is not None:
            kw["link_failure"] = LinkFailure.from_json(d["link_failure"])
        if d.get("telemetry") is not None:
            kw["telemetry"] = TelemetrySpec.from_json(d["telemetry"])
        if d.get("engine") is not None:
            kw["engine"] = EngineOptions.from_json(d["engine"])
        return cls(**kw)

    def to_file(self, path) -> Path:
        path = Path(path)
        path.write_text(json.dumps(self.to_json(), indent=1) + "\n")
        return path

    @classmethod
    def from_file(cls, path) -> "Scenario":
        return cls.from_json(json.loads(resolve(path).read_text()))


@dataclass(frozen=True)
class SweepSpec:
    """A declarative policy × load × seed (× hedge-delay) grid over a base
    scenario.

    ``policies="registered"`` (the default) expands *at run time* to every
    policy registered for both engines, so custom registrations enter every
    sweep without touching the spec.  Empty ``loads`` means the base
    scenario's single load.  ``hedge_delays`` adds the hedge-timer delay as
    a per-run grid axis (needs a ``hedge_timer`` policy in the set), and
    ``shard`` lays the whole grid out over a device mesh
    (:class:`repro_torch.fleetsim.shard.ShardSpec`) — both Poisson-grid
    features, rejected for trace replays.
    """

    base: Scenario
    policies: tuple[str, ...] | str = "registered"
    loads: tuple[float, ...] = ()
    seeds: tuple[int, ...] = (0,)
    hedge_delays: tuple[float, ...] = ()
    shard: ShardSpec | None = None
    # engine execution options for the whole grid (backend, chunking);
    # None runs the default 'auto' backend.  The shard layout stays in
    # ``shard`` — an engine sub-object carrying one too is rejected.
    engine: EngineOptions | None = None

    def resolved_policies(self) -> list[str]:
        if self.policies == "registered":
            return registry.two_engine_names()
        return list(self.policies)

    def resolved_loads(self) -> list[float]:
        return list(self.loads) or [self.base.load]

    def scenarios(self) -> list[Scenario]:
        """The expanded grid, one frozen Scenario per cell."""
        return [
            replace(self.base, policy=p, load=ld, seed=s,
                    name=f"{self.base.name}[{p}@{ld:g}#s{s}]")
            for p in self.resolved_policies()
            for ld in self.resolved_loads()
            for s in self.seeds
        ]

    def run_fleetsim(self, *, device=None, **cfg_overrides) -> SweepResult:
        """Run the whole grid through the array engine on ``device`` (CUDA
        by default) — one batched run for Poisson grids, per-scenario runs
        for trace replays."""
        base = self.base
        if base.arrival.kind == "poisson":
            cfg = base.fleet_config(**cfg_overrides)
            weights, slowdown = rack_skew(cfg, base.hot_rack_weight,
                                          base.straggler_rack_mult)
            if base.slowdown is not None:
                slowdown = np.asarray(base.slowdown, np.float32).reshape(-1)
            # a pinned max_arrivals (explicit in the scenario or the
            # overrides) fixes the array shapes — don't re-derive headroom
            pinned = (base.max_arrivals is not None
                      or "max_arrivals" in cfg_overrides)
            return sweep_grid(base.service, self.resolved_policies(),
                              self.resolved_loads(), list(self.seeds),
                              cfg=cfg, slowdown=slowdown,
                              rack_weights=weights,
                              fail_window_ticks=base.fail_window_ticks,
                              link_failure=base.link_failure,
                              resize_arrival_lanes=not pinned,
                              hedge_delays=list(self.hedge_delays) or None,
                              shard=self.shard, engine=self.engine,
                              device=device)
        if self.shard is not None or self.hedge_delays:
            raise ValueError("shard / hedge_delays are Poisson-grid "
                             "features (one vmapped program); trace "
                             "replays run per-scenario")
        if len(self.resolved_loads()) > 1:
            # a trace IS the offered schedule: each load cell would run the
            # same configuration and waste device time on duplicate rows
            raise ValueError("trace-arrival sweeps ignore `load`; sweep "
                             "policies/seeds only (got loads="
                             f"{self.resolved_loads()})")
        return run_scenarios(self.scenarios(), device=device,
                             **cfg_overrides)

    # --------------------------------------------------------------- JSON --
    def to_json(self) -> dict:
        d = {"base": self.base.to_json(),
             "policies": (self.policies if isinstance(self.policies, str)
                          else list(self.policies)),
             "loads": list(self.loads), "seeds": list(self.seeds)}
        if self.hedge_delays:
            d["hedge_delays"] = list(self.hedge_delays)
        if self.shard is not None:
            d["shard"] = self.shard.to_json()
        if self.engine is not None:
            d["engine"] = self.engine.to_json()
        return d

    _JSON_KEYS = ("base", "policies", "loads", "seeds", "hedge_delays",
                  "shard", "engine")

    @classmethod
    def from_json(cls, d: dict) -> "SweepSpec":
        unknown = sorted(set(d) - set(cls._JSON_KEYS))
        if unknown:
            raise ValueError(f"unknown sweep keys {unknown}; "
                             f"valid: {sorted(cls._JSON_KEYS)}")
        pol = d.get("policies", "registered")
        shard = d.get("shard")
        eng = d.get("engine")
        return cls(base=Scenario.from_json(d["base"]),
                   policies=pol if isinstance(pol, str) else tuple(pol),
                   loads=tuple(d.get("loads", ())),
                   seeds=tuple(d.get("seeds", (0,))),
                   hedge_delays=tuple(d.get("hedge_delays", ())),
                   shard=None if shard is None else ShardSpec.from_json(shard),
                   engine=None if eng is None else EngineOptions.from_json(eng))

    def to_file(self, path) -> Path:
        path = Path(path)
        path.write_text(json.dumps(self.to_json(), indent=1) + "\n")
        return path

    @classmethod
    def from_file(cls, path) -> "SweepSpec":
        return cls.from_json(json.loads(resolve(path).read_text()))


def _synchronize(metrics) -> None:
    """Wait for the run that produced ``metrics`` (a no-op on the CPU)."""
    import torch

    if metrics.hist.device.type == "cuda":
        torch.cuda.synchronize(metrics.hist.device)


def run_scenarios(scenarios: list[Scenario], *, device=None,
                  **cfg_overrides) -> SweepResult:
    """Run heterogeneous scenarios through the array engine one by one on
    ``device`` (CUDA by default).

    The fused backend's graph set-up is timed apart from the runs
    (``compile_s``), matching ``sweep_grid``'s accounting, so MRPS numbers
    are comparable between Poisson grids and trace replays."""
    prepared = [(sc, sc.fleet_config(**cfg_overrides)) for sc in scenarios]
    results = []
    compile_s, wall = 0.0, 0.0
    backend = "staged"
    for sc, cfg in prepared:
        stats = GraphStats()
        t0 = time.perf_counter()
        m, backend = engine.run(cfg, sc.run_params(cfg), device, sc.engine,
                                stats)
        _synchronize(m)
        wall += time.perf_counter() - t0 - stats.setup_s
        compile_s += stats.setup_s
        results.append(summarize(
            cfg, m, policy=sc.policy,
            load=sc.effective_load(cfg.n_ticks),
            rate_per_us=sc.rate_per_us(cfg.n_ticks), seed=sc.seed))
    return SweepResult(results=results, wall_clock_s=wall,
                       n_configs=len(scenarios),
                       simulated_requests=sum(r.n_arrivals for r in results),
                       device=str(resolve_device(device)), backend=backend,
                       compile_s=compile_s)


# ------------------------------------------------------------------ library --
def scenario_library() -> dict[str, Path]:
    """Bundled scenario/sweep files, by bare name."""
    return {p.stem: p for p in sorted(LIBRARY_DIR.glob("*.json"))}


def resolve(path) -> Path:
    """A filesystem path, or the bare name of a bundled library file."""
    p = Path(path)
    if p.exists():
        return p
    lib = scenario_library()
    if str(path) in lib:
        return lib[str(path)]
    raise FileNotFoundError(
        f"{path!r} is neither a file nor a bundled scenario "
        f"(bundled: {sorted(lib)})")


def load_any(path) -> Scenario | SweepSpec:
    """Load a scenario or sweep file, whichever the JSON describes."""
    d = json.loads(resolve(path).read_text())
    if "base" in d or "policies" in d:
        return SweepSpec.from_json(d)
    return Scenario.from_json(d)
