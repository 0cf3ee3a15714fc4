"""FleetSim static configuration.

The port's copy of ``repro.fleetsim.config``: :class:`FleetConfig` has the
reference's fields, defaults, properties and validation.  Everything in it
fixes the shapes of the fleet state; per-run knobs that vary across a sweep
(policy, offered rate, seed, straggler factors, failure windows) are
tensors with a leading config axis in ``RunParams``, so one batched run
serves a whole policy × load × seed grid.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass, replace

from repro_torch.scenarios import registry
from repro_torch.scenarios.service import (  # noqa: F401  (re-exported API)
    SERVICE_BIMODAL,
    SERVICE_EXPONENTIAL,
    SERVICE_LLM,
    SERVICE_PARETO,
    ServiceSpec,
)



class _PolicyIdView(Mapping):
    """Live ``name → id`` view of the unified policy registry: registering
    a policy (``repro_torch.scenarios.registry.register``) makes it appear
    here immediately."""

    def __getitem__(self, name: str) -> int:
        return registry.policy_id_map()[name]

    def __iter__(self):
        return iter(registry.policy_id_map())

    def __len__(self):
        return len(registry.policy_id_map())

    def __repr__(self):
        return repr(registry.policy_id_map())


class _PolicyNameView(Mapping):
    """Live ``id → name`` reverse view of the registry."""

    def __getitem__(self, policy_id: int) -> str:
        return registry.policy_name_map()[policy_id]

    def __iter__(self):
        return iter(registry.policy_name_map())

    def __len__(self):
        return len(registry.policy_name_map())

    def __repr__(self):
        return repr(registry.policy_name_map())


POLICY_IDS = _PolicyIdView()
POLICY_NAMES = _PolicyNameView()

# builtin ids, derived from the registry at import
POLICY_BASELINE = POLICY_IDS["baseline"]
POLICY_CCLONE = POLICY_IDS["c-clone"]
POLICY_NETCLONE = POLICY_IDS["netclone"]
POLICY_RACKSCHED = POLICY_IDS["racksched"]
POLICY_NCRS = POLICY_IDS["netclone+racksched"]
POLICY_LAEDGE = POLICY_IDS["laedge"]
POLICY_HEDGE = POLICY_IDS["hedge"]


@dataclass(frozen=True)
class FleetConfig:
    """Shapes + calibrated latency constants of one simulated fabric.

    Latency constants default to the DES's :class:`NetworkCosts` /
    :class:`SwitchCosts` so the two engines are directly comparable.

    ``n_racks == 1`` is the original single-ToR testbed (the goldens in
    ``tests/golden/fleetsim_single_tor.json`` pin it).  ``n_racks > 1``
    models a 2-tier fabric: per-rack ToR switches under one spine that
    assigns fabric-global REQ_IDs, aggregates per-rack load, and hosts the
    filter table for inter-rack clone pairs (§3.7's multi-switch story).
    ``n_servers`` is then *per rack*.
    """

    n_racks: int = 1
    n_servers: int = 6
    n_workers: int = 15
    # client machines (receiver threads); 0 → scale with the fabric
    # (2 per rack, the DES's 2-clients-per-6-server-rack testbed ratio), so
    # multi-rack sweeps aren't silently receiver-bound
    n_clients: int = 0
    # FCFS slots per server.  Ring buffers make capacity nearly free (no
    # per-tick op scales with it), so the default is deep enough that beyond-
    # saturation runs build DES-like unbounded-queue latency instead of
    # shedding copies through overflow (which is still counted when hit).
    queue_cap: int = 512
    max_arrivals: int = 12       # arrival lanes per tick (Poisson is clipped)
    max_responses: int = 32      # response lanes per tick (clipping counted)
    dt_us: float = 1.0
    n_ticks: int = 50_000
    warmup_frac: float = 0.1
    service: ServiceSpec = ServiceSpec.exponential(25.0)
    # arrival-process kind: "poisson" draws per-tick counts device-side from
    # the run's rate + seed; "trace" replays the per-tick count sequence
    # passed in ``RunParams.arrival_counts``
    arrival: str = "poisson"
    # switch tables.  The prototype's 2×2^17 slots bound collisions for
    # millions of in-flight ids; a simulated rack keeps O(100) fingerprints
    # live, so far smaller tables preserve the collision behaviour while
    # keeping the per-tick scatter (and its operand copy) cheap.
    n_filter_tables: int = 2
    n_filter_slots: int = 2 ** 10
    # client-side first-response fingerprints: sized above the worst-case
    # in-flight population (n_servers × (workers + queue_cap)) so collisions
    # that evict a live entry (n_dedup_evicted) stay rare even past saturation
    n_dedup_slots: int = 2 ** 13
    # transport/processing constants (µs) — match simulator.NetworkCosts
    link_us: float = 0.5
    server_overhead_us: float = 1.0
    client_rx_us: float = 0.68
    client_tx_us: float = 0.15
    pipeline_pass_us: float = 0.4
    # one-way client↔spine / spine↔rack-switch hop (µs); only paid when the
    # fabric actually has a spine tier (n_racks > 1)
    spine_hop_us: float = 0.5
    # ---- optional pipeline stages ----------------------------------------
    # Static flags: with a flag off the stage runs no ops at all; with it
    # on, the stage's sub-state joins FleetState and the policies registered
    # with the matching hook (registry coordinator / hedge_timer) become
    # runnable.  Scenario and sweep_grid turn them on from the policy set.
    #
    # coordinator: LÆDGE-style CPU queue node hanging off the top switch —
    # a ring buffer of pending requests drained each tick by the policy's
    # registered dispatch rule, throttled by a coord_cpu_us-per-packet
    # credit (the paper's coordinator-CPU bottleneck).
    coordinator: bool = False
    coordinator_cap: int = 2 ** 11      # pending-request ring slots
    coordinator_drain: int = 0          # max pops per tick (0 → 2×arrivals)
    coord_cpu_us: float = 1.5           # CPU per packet — matches the DES
    # hedge_timer: fixed-depth timer wheel ((n_slots, wheel_width) entries)
    # firing delayed duplicates hedge_delay_us after arrival unless the
    # first response beat the timer.  Width 0 sizes to max_arrivals (every
    # arrival lane can arm); slots 0 sizes to the delay horizon + 1.
    hedge_timer: bool = False
    hedge_delay_us: float = 75.0        # ≈p95 service — matches HedgePolicy
    hedge_wheel_slots: int = 0
    hedge_wheel_width: int = 0
    # telemetry: device-resident request-event ring buffer + windowed
    # time-series, a pure observer that draws no PRNG traffic.
    telemetry: bool = False
    trace_cap: int = 2 ** 15            # ring-buffer records (flight recorder)
    window_ticks: int = 1_000           # time-series window length (ticks)
    # server_model: "fcfs" (the per-worker FCFS ring) or "batch"
    # (ServeSim's continuous-batching slots — admit-into-free-slot, all busy
    # slots progress every tick, complete on exhausted demand).
    server_model: str = "fcfs"
    # decode slots per server under server_model="batch" (0 → n_workers)
    batch_slots: int = 0
    # batching slowdown: a slot running with k busy neighbours progresses at
    # 1 / (1 + batch_coupling × (k-1)/(B-1)) per tick.  0 (default) models
    # memory-bound decode (batch size is nearly free — slots independent);
    # 1 halves per-slot progress at full occupancy (compute-bound
    # prefill-heavy regime).
    batch_coupling: float = 0.0
    # response-filter backend: "vectorized" (one scatter/tick, default),
    # "scan" (the exact lane-sequential filter as a plain lane loop),
    # "pallas" (the CUDA fingerprint-filter kernel, kernels.fingerprint_
    # filter; the name is the reference's), or "tickfuse" (the CUDA kernel
    # that fuses the StateT write with the filter, kernels.tickfuse)
    filter_backend: str = "vectorized"
    # log-spaced latency histogram (≈6% bin resolution over 1 µs … 2 s)
    hist_bins: int = 256
    hist_lo_us: float = 1.0
    hist_growth: float = 1.06

    def __post_init__(self):
        if self.n_racks < 1:
            raise ValueError("n_racks must be at least 1")
        if self.n_clients == 0:
            object.__setattr__(self, "n_clients", 2 * self.n_racks)
        if self.n_clients < 1:
            raise ValueError("n_clients must be >= 1 (or 0 to auto-scale)")
        if self.n_filter_slots & (self.n_filter_slots - 1):
            raise ValueError("n_filter_slots must be a power of two")
        if self.n_dedup_slots & (self.n_dedup_slots - 1):
            raise ValueError("n_dedup_slots must be a power of two")
        if self.filter_backend not in ("vectorized", "scan", "pallas",
                                       "tickfuse"):
            raise ValueError(f"unknown filter_backend {self.filter_backend!r}")
        if self.arrival not in ("poisson", "trace"):
            raise ValueError(f"unknown arrival kind {self.arrival!r}")
        if self.n_servers < 2:
            raise ValueError("fleetsim requires at least two servers per rack")
        # req ids ride in float32 payload lanes; keep them exactly
        # representable (REQ_ID ≤ n_ticks × max_arrivals < 2^24)
        if self.n_ticks * self.max_arrivals >= 2 ** 24:
            raise ValueError("n_ticks × max_arrivals must stay below 2^24 "
                             "(REQ_IDs are carried in float32 payloads)")
        if self.coordinator and self.coordinator_cap < 1:
            raise ValueError("coordinator_cap must be >= 1")
        if self.server_model not in ("fcfs", "batch"):
            raise ValueError(f"unknown server_model {self.server_model!r} "
                             "(expected 'fcfs' or 'batch')")
        if self.batch_slots < 0:
            raise ValueError("batch_slots must be >= 0 (0 → n_workers)")
        if self.batch_coupling < 0:
            raise ValueError("batch_coupling must be >= 0")
        if self.telemetry:
            if self.trace_cap < 1:
                raise ValueError("trace_cap must be >= 1")
            if not 1 <= self.window_ticks <= self.n_ticks:
                raise ValueError("window_ticks must be in [1, n_ticks] "
                                 f"(got {self.window_ticks} with n_ticks="
                                 f"{self.n_ticks})")
        if self.hedge_timer:
            if self.hedge_delay_us <= 0:
                raise ValueError("hedge_delay_us must be positive")
            if 0 < self.hedge_wheel_slots <= self.hedge_delay_ticks:
                raise ValueError(
                    f"hedge_wheel_slots must exceed the delay horizon "
                    f"({self.hedge_delay_ticks} ticks) so an armed entry "
                    "cannot alias a pending slot")

    @property
    def n_groups(self) -> int:
        """GrpT entries per rack switch (ordered pairs of local servers)."""
        return self.n_servers * (self.n_servers - 1)

    @property
    def n_servers_total(self) -> int:
        return self.n_racks * self.n_servers

    @property
    def spine_extra_us(self) -> float:
        """Round-trip latency added by the spine tier every request pays
        under a 2-tier fabric (two extra link hops + two pipeline passes);
        zero when the fabric is a single ToR."""
        if self.n_racks == 1:
            return 0.0
        return 2.0 * (self.spine_hop_us + self.pipeline_pass_us)

    @property
    def interrack_extra_us(self) -> float:
        """Additional one-way detour paid by the remote copy of an
        inter-rack clone pair (spine → remote rack switch and back up)."""
        if self.n_racks == 1:
            return 0.0
        return 2.0 * (self.spine_hop_us + self.pipeline_pass_us)

    @property
    def hedge_delay_ticks(self) -> int:
        """The hedge delay quantized to ticks (at least one — a same-tick
        hedge would race its own original)."""
        return max(1, round(self.hedge_delay_us / self.dt_us))

    @property
    def wheel_slots(self) -> int:
        """Resolved timer-wheel depth: explicit, or the delay horizon + 1
        (an entry armed at tick t fires exactly at t + delay, and the slot
        it lands in drained one full rotation earlier)."""
        return self.hedge_wheel_slots or self.hedge_delay_ticks + 1

    @property
    def wheel_width(self) -> int:
        """Resolved per-slot entry budget: explicit, or ``max_arrivals``
        (every arrival lane of one tick can arm without drops)."""
        return self.hedge_wheel_width or self.max_arrivals

    @property
    def n_slots(self) -> int:
        """Resolved decode slots per server under ``server_model="batch"``:
        explicit ``batch_slots``, or ``n_workers`` (each worker lane becomes
        one continuous-batching slot, keeping the state shapes shared)."""
        return self.batch_slots or self.n_workers

    @property
    def n_windows(self) -> int:
        """Time-series windows per run (the last window may be partial)."""
        return -(-self.n_ticks // self.window_ticks)

    @property
    def drain_per_tick(self) -> int:
        """Resolved coordinator drain bound: explicit, or twice the
        arrival lanes (the backlog can shrink even at full admission)."""
        return self.coordinator_drain or 2 * self.max_arrivals

    @property
    def duration_us(self) -> float:
        return self.n_ticks * self.dt_us

    @property
    def warmup_us(self) -> float:
        return self.warmup_frac * self.duration_us

    def with_arrival_headroom(self, max_rate_per_us: float) -> "FleetConfig":
        """Size the per-tick arrival lanes so Poisson clipping is negligible
        at the hottest point of a sweep (≈6σ above the mean count)."""
        lam = max_rate_per_us * self.dt_us
        lanes = int(math.ceil(lam + 6.0 * math.sqrt(max(lam, 1e-9)) + 2.0))
        return replace(self, max_arrivals=max(4, lanes))

    def with_hedge_horizon(self, max_delay_us: float) -> "FleetConfig":
        """Deepen the hedge timer wheel to cover per-run (traced) delays up
        to ``max_delay_us`` (``RunParams.hedge_delay_ticks`` is a sweep
        axis, but the wheel's depth is a static shape).  No-op when the
        stage is off or the resolved wheel already covers the horizon."""
        if not self.hedge_timer:
            return self
        if max_delay_us <= 0:
            raise ValueError("max_delay_us must be positive")
        horizon = max(1, round(max_delay_us / self.dt_us))
        if self.wheel_slots > horizon:
            return self
        return replace(self, hedge_wheel_slots=horizon + 1)

    def with_policy_stages(self, policies) -> "FleetConfig":
        """Turn on the pipeline stages the given policy names need
        (coordinator / hedge_timer registry hooks).  A config whose policy
        set needs neither is returned unchanged."""
        need_coord = any(registry.needs_coordinator(p) for p in policies)
        need_hedge = any(registry.needs_hedge_timer(p) for p in policies)
        cfg = self
        if need_coord and not cfg.coordinator:
            cfg = replace(cfg, coordinator=True)
        if need_hedge and not cfg.hedge_timer:
            cfg = replace(cfg, hedge_timer=True)
        return cfg
