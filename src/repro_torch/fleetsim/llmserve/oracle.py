"""serve_equivalence: the batch server stage vs DecodeReplica as oracle —
port of ``repro.fleetsim.llmserve.oracle``.

:class:`repro_torch.serve.engine.DecodeReplica` (the port's model stack,
slot-exact continuous batching, one decode step per tick) driven by
:class:`repro_torch.serve.server.NetCloneServer` is the discrete-event
oracle; the array batch-server stage (``FleetConfig.server_model=
"batch"``) runs the same cluster shape through :func:`repro_torch.
fleetsim.sweep.sweep_grid`.  The tick ↔ token mapping: ``dt_us = 1`` and
an ``llm`` ServiceSpec with ``decode = 1`` and deterministic generation
length, so a request's demand is its slot-occupancy in ticks —
``(prompt_len - 1) + gen_len``, exactly the ticks :class:`DecodeReplica`
holds a slot (admission feeds ``prompt[0]``, then one position per tick).

Documented tolerances (``SERVE_*``, the reference's).  The two sides agree
on *distributions*, not samples — arrival times and routing randomness are
drawn from independent PRNGs — and three modelling gaps remain by
construction:

* the oracle has **no network**: the comparison config zeroes FleetSim's
  link/client/pipeline/overhead constants, so what is compared is pure
  queueing + batching behaviour;
* FleetSim draws its per-execution ±10% noise (``_execute``) and
  tick-quantizes demand (ceil), while the oracle's slot-occupancy is
  exact — plus the ≈6% histogram bin resolution and a ±1-tick
  admission-boundary offset (FleetSim admits and completes inside one
  staged tick; the replica admits at tick start and counts that tick's
  decode step);
* both sides censor at the same horizon, but the in-flight tail differs
  by up to one batch of slots.

Latency percentiles carry all three, hence the looser rtols; clone
fraction and goodput are horizon-level counters and get tighter bounds.

The oracle's replicas decode the model's *smoke* config, as the
reference's do; its random weights (from seed 0) decide only the tokens,
never a completion tick (a request completes after ``gen_len`` tokens), so
each check's fields equal the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: relative tolerance on median latency (ticks) vs the replica oracle
SERVE_P50_RTOL = 0.25
#: relative tolerance on p99 latency (a noisy order statistic both sides)
SERVE_P99_RTOL = 0.40
#: absolute tolerance on clone fraction (n_cloned / n_requests)
SERVE_CLONE_FRAC_ATOL = 0.15
#: relative tolerance on completed fraction within the shared horizon
SERVE_GOODPUT_RTOL = 0.15
#: loads at/above this are saturated — no steady state, latency checks skip
SERVE_SATURATION_LOAD = 0.90


@dataclass
class ServeCheck:
    """One (policy, load) cell of a batch-server vs DecodeReplica check."""

    policy: str
    load: float
    oracle_p50: float
    fleet_p50: float
    oracle_p99: float
    fleet_p99: float
    oracle_clone_frac: float
    fleet_clone_frac: float
    oracle_goodput: float     # completed / offered within the horizon
    fleet_goodput: float
    slot_occupancy: float     # FleetSim mean busy-slot fraction

    def _rel(self, a, b):
        return abs(a - b) / max(abs(a), abs(b), 1e-9)

    @property
    def saturated(self) -> bool:
        return self.load >= SERVE_SATURATION_LOAD

    @property
    def p50_ok(self) -> bool:
        return self.saturated or \
            self._rel(self.oracle_p50, self.fleet_p50) <= SERVE_P50_RTOL

    @property
    def p99_ok(self) -> bool:
        return self.saturated or \
            self._rel(self.oracle_p99, self.fleet_p99) <= SERVE_P99_RTOL

    @property
    def clone_ok(self) -> bool:
        return abs(self.oracle_clone_frac - self.fleet_clone_frac) \
            <= SERVE_CLONE_FRAC_ATOL

    @property
    def goodput_ok(self) -> bool:
        return self.saturated or \
            self._rel(self.oracle_goodput, self.fleet_goodput) \
            <= SERVE_GOODPUT_RTOL

    @property
    def ok(self) -> bool:
        return (self.p50_ok and self.p99_ok and self.clone_ok
                and self.goodput_ok)

    def describe(self) -> str:
        sat = " [saturated: latency skipped]" if self.saturated else ""
        return (f"{self.policy}@{self.load:.2f}: "
                f"p50 {self.oracle_p50:.0f}/{self.fleet_p50:.0f}t"
                f"[{'ok' if self.p50_ok else 'FAIL'}] "
                f"p99 {self.oracle_p99:.0f}/{self.fleet_p99:.0f}t"
                f"[{'ok' if self.p99_ok else 'FAIL'}] "
                f"clone {self.oracle_clone_frac:.2f}/"
                f"{self.fleet_clone_frac:.2f}"
                f"[{'ok' if self.clone_ok else 'FAIL'}] "
                f"good {self.oracle_goodput:.2f}/{self.fleet_goodput:.2f}"
                f"[{'ok' if self.goodput_ok else 'FAIL'}] "
                f"occ {self.slot_occupancy:.2f}{sat}")


def serve_equivalence(
    model_name: str = "qwen2.5-3b",
    policies: tuple[str, ...] = ("baseline", "netclone"),
    loads: tuple[float, ...] = (0.3, 0.6),
    n_replicas: int = 3,
    n_slots: int = 2,
    prompt_len: int = 4,
    gen_len: int = 16,
    horizon: int = 1_500,
    seed: int = 0,
    *,
    device=None,
    stats: dict | None = None,
) -> list[ServeCheck]:
    """Run both sides over the (policy, load) grid on ``device`` (CUDA by
    default; ``"cpu"`` for the plain path); one :class:`ServeCheck` per
    cell — callers assert ``all(c.ok for c in checks)``.

    The oracle side ticks real ``DecodeReplica`` instances of the model's
    *smoke* config (tiny shapes, deterministic decode), so a cell costs up
    to ``horizon`` decode steps per replica; the FleetSim side is one
    batched sweep over the whole grid.  ``stats``, when given, receives
    ``decode_steps`` (model steps over every replica and cell),
    ``oracle_s`` and ``fleet_s`` (wall seconds of each side).
    """
    import time

    from repro_torch.configs import get_config
    from repro_torch.core.workloads import load_to_rate
    from repro_torch.device import resolve_device
    from repro_torch.fleetsim.config import FleetConfig
    from repro_torch.fleetsim.sweep import sweep_grid
    from repro_torch.models import family_of
    from repro_torch.scenarios.service import ServiceSpec
    from repro_torch.serve import DecodeReplica, NetCloneServer

    dev = resolve_device(device)
    # demand in ticks == DecodeReplica slot occupancy; no jitter, and zero
    # network/overhead constants, so pure queueing + batching is compared
    # (module docstring)
    spec = ServiceSpec.llm(prefill=float(prompt_len - 1), decode=1.0,
                           gen_short=float(gen_len), gen_long=float(gen_len),
                           p_long=0.0, jitter_p=0.0, jitter_mult=1.0)
    cfg = FleetConfig(
        n_servers=n_replicas, n_workers=n_slots, n_ticks=horizon,
        dt_us=1.0, warmup_frac=0.0, service=spec,
        server_model="batch",
        link_us=0.0, server_overhead_us=0.0, client_rx_us=0.0,
        client_tx_us=0.0, pipeline_pass_us=0.0)
    svc = spec.to_process()
    t0 = time.perf_counter()
    fleet = sweep_grid(spec, list(policies), list(loads), [seed], cfg=cfg,
                       device=dev)
    fleet_s = time.perf_counter() - t0

    mcfg = get_config(model_name, smoke=True)
    fam = family_of(mcfg)
    params = fam.init_params(mcfg, 0, device=dev)
    rng = np.random.default_rng(seed)

    checks = []
    steps = 0
    t0 = time.perf_counter()
    for load in loads:
        # the reference's draw order: per load, the arrivals, then the
        # prompts
        rate = load_to_rate(load, svc, n_replicas, n_slots)
        n_req = max(int(horizon * rate), 1)
        arrivals = np.sort(rng.integers(0, horizon, n_req))
        prompts = [rng.integers(0, mcfg.vocab_size,
                                prompt_len).astype(np.int32)
                   for _ in range(n_req)]
        for policy in policies:
            reps = [DecodeReplica(mcfg, params, sid=i, n_slots=n_slots,
                                  s_max=max(2 * (prompt_len + gen_len), 16),
                                  device=dev)
                    for i in range(n_replicas)]
            srv = NetCloneServer(reps, policy=policy, seed=seed + 1,
                                 device=dev)
            stats_ = srv.run(list(zip(arrivals, prompts)),
                             max_new_tokens=gen_len, max_ticks=horizon)
            steps += sum(r.n_decode_steps for r in reps)
            fr = fleet.select(policy=policy, load=load)[0]
            checks.append(ServeCheck(
                policy=policy, load=load,
                oracle_p50=stats_.p(50), fleet_p50=fr.p50_us,
                oracle_p99=stats_.p(99), fleet_p99=fr.p99_us,
                oracle_clone_frac=stats_.n_cloned / n_req,
                fleet_clone_frac=fr.clone_fraction,
                oracle_goodput=stats_.n_completed / n_req,
                fleet_goodput=fr.n_completed / max(fr.n_arrivals, 1),
                slot_occupancy=fr.mean_slot_occupancy))
    if stats is not None:
        stats.update(decode_steps=steps, fleet_s=fleet_s,
                     oracle_s=time.perf_counter() - t0)
    return checks
