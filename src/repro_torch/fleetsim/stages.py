"""The staged tick pipeline, port of ``repro.fleetsim.stages``.

One engine tick is the composition

    arrival → route (ToR + spine) → coordinator → hedge_timer
            → link-failure → server → link-response → response/filter
            → client

over the :class:`~repro_torch.fleetsim.state.FleetState` of ``G``
configurations at once (the reference's ``vmap`` axis, written out).  The
stages read and write the reference's layouts; what the port changes is
only how the work is expressed:

* a ``lax.switch`` over policy ids is "compute each present policy's
  branch, select per config" (:func:`repro_torch.fleetsim.policies.
  select_branches`);
* every ``.at[].set(mode="drop")`` goes through
  :func:`repro_torch.scatter.scatter_last` (last lane wins, out-of-range
  rows dropped) on every device;
* the large state tensors (queue rings, filter tables, StateT, the dedup
  table, the histograms, the coordinator ring, the timer wheel) are
  updated **in place**; callers that need the old state clone it first.

Two stages are optional, gated by static :class:`~repro_torch.fleetsim.
config.FleetConfig` flags, so a flag-off tick runs no op of them and the
always-on goldens stay bit-identical: ``stage_coordinator``
(``cfg.coordinator``, LÆDGE's coordinator node: a ring of parked arrivals
drained each tick by the policy's registered rule under a CPU-credit
throttle) and ``stage_hedge_timer`` (``cfg.hedge_timer``, a timer wheel
firing delayed duplicates unless the original's response already parked
its fingerprint).  Their lanes join the route stage's with
:meth:`Lanes.extend`, so the server stage's lane width grows only when a
flag is on.  Two more static flags change what a tick does:

* ``cfg.server_model == "batch"``: :func:`stage_server` hands the tick to
  ServeSim's continuous-batching stage (:func:`repro_torch.fleetsim.
  llmserve.stage.stage_server_batch`), which advances every busy decode
  slot and then shares the FCFS stage's queueing and response path
  (:func:`serve_lanes`);
* ``cfg.telemetry`` (FleetScope): each stage emits its trace records into
  the state's ring buffer, in stage order, and the tick ends with the
  windowed series update (:mod:`repro_torch.fleetsim.telemetry.device`).
  Telemetry only observes: the ``Metrics`` stay bit-identical.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core.header import CLO_CLONE, CLO_ORIG
from repro_torch.core.switch import SwitchState, filter_tick_vectorized
from repro_torch.fleetsim.chaos import (
    link_dead,
    stage_link_failure,
    stage_link_response,
)
from repro_torch.fleetsim.config import (
    SERVICE_BIMODAL,
    SERVICE_EXPONENTIAL,
    SERVICE_LLM,
    SERVICE_PARETO,
    FleetConfig,
)
from repro_torch.fleetsim.policies import (
    dedup_tick,
    id_mask,
    route_fabric,
    select_branches,
)
from repro_torch.fleetsim.state import (
    QF_BASE,
    QF_CLIENT,
    QF_CLO,
    QF_FRACK,
    QF_HOP,
    QF_IDX,
    QF_RID,
    QF_TARR,
    WF,
    WF_CLIENT,
    WF_CLO,
    WF_FRACK,
    WF_HOP,
    WF_IDX,
    WF_REM,
    WF_RID,
    WF_TARR,
    QF,
    WH,
    WHEEL_BASE,
    WHEEL_CLIENT,
    WHEEL_DST,
    WHEEL_FRACK,
    WHEEL_IDX,
    WHEEL_RID,
    WHEEL_TARR,
    FleetState,
    HedgeWheel,
    worker_lanes,
)
from repro_torch.fleetsim.telemetry.device import (
    emit,
    series_record_hist,
    series_tick,
)
from repro_torch.fleetsim.telemetry.events import (
    CLONE_SRC_COORD,
    CLONE_SRC_HEDGE,
    CLONE_SRC_INTERRACK,
    CLONE_SRC_LOCAL,
    EV_ARRIVAL,
    EV_CLIENT_COMPLETE,
    EV_CLIENT_REDUNDANT,
    EV_CLONE,
    EV_COORD_DISPATCH,
    EV_COORD_ENQ,
    EV_FILTER_DROP,
    EV_HEDGE_ARMED,
    EV_HEDGE_CANCELLED,
    EV_ROUTE,
    EV_SERVER_FINISH,
    EV_SERVER_START,
)
from repro_torch.kernels.ops import fingerprint_filter, tickfuse_masked
from repro_torch.kernels.ref import fingerprint_filter_ref, fingerprint_slot
from repro_torch.scatter import scatter_add_drop, scatter_last
from repro_torch.scenarios import registry

_F32 = torch.float32
_I32 = torch.int32


def _f32(x: float) -> float:
    """A Python float rounded to float32 (the value JAX computes with)."""
    return float(np.float32(x))


def _sum(mask: torch.Tensor) -> torch.Tensor:
    """Per-config count of a ``(G, ...)`` mask, int32."""
    return mask.reshape(mask.shape[0], -1).sum(dim=1, dtype=_I32)


# --------------------------------------------------------------- sampling ---
def _intrinsic(cfg: FleetConfig, u):
    """Per-request base demand (shared by both copies of a clone pair),
    from a pre-drawn uniform in [0, 1)."""
    p = cfg.service.params
    if cfg.service.kind == SERVICE_EXPONENTIAL:
        return torch.full_like(u, _f32(p[0]))
    if cfg.service.kind == SERVICE_BIMODAL:
        short, long, p_long = p
        return torch.where(u < p_long, _f32(long), _f32(short)).to(_F32)
    if cfg.service.kind == SERVICE_PARETO:
        xm, alpha, cap = p
        u = torch.clamp(u, max=_f32(1.0 - 1e-7))
        r = (xm / cap) ** alpha
        return jr.over(xm, jr.pow_f32(1.0 - u * (1.0 - r),
                                      _f32(1.0 / alpha)))
    if cfg.service.kind == SERVICE_LLM:
        # prefill + generated-length × per-token decode; the bimodal
        # generation length is intrinsic (shared by both clone copies)
        prefill, decode, gen_short, gen_long, p_long = p
        gen = torch.where(u < p_long, _f32(gen_long), _f32(gen_short))
        return (prefill + gen.to(_F32) * decode).to(_F32)
    raise ValueError(cfg.service.kind)


def _execute(cfg: FleetConfig, u, base):
    """One execution's runtime: per-copy randomness + the jitter spike.
    One uniform pair feeds both (inverse CDF): ``u`` is the reference's
    ``uniform(k_exec, base.shape + (2,))`` block, ``base`` ``(G, ...)``."""
    if cfg.service.kind == SERVICE_EXPONENTIAL:
        # dummy-RPC spin drawn at the server (§5.1.2)
        dur = -jr.log1p_f32(-u[..., 0] * (1.0 - 1e-7)) * base
    else:
        dur = base * (0.9 + 0.2 * u[..., 0])
    spike = u[..., 1] < cfg.service.jitter_p
    return torch.where(spike, dur * cfg.service.jitter_mult, dur)


def _rank_among_earlier(mask):
    """Count of earlier True entries along the last axis."""
    m = mask.to(torch.int64)
    return torch.cumsum(m, dim=-1) - m


def _full_t_us(arr, like: torch.Tensor) -> torch.Tensor:
    """The tick's start time, float32, in the shape of ``like`` (a Python
    number on the staged loop, a 0-d device tensor in a captured block)."""
    if isinstance(arr.t_us, torch.Tensor):
        return arr.t_us.expand(like.shape)
    return torch.full_like(like, arr.t_us)


def _present(params) -> tuple[int, ...]:
    """The policy ids present in a batch (one host read, at set-up)."""
    return tuple(sorted(set(params.policy_id.tolist())))


# ------------------------------------------------------------ random draws --
class TickDraws(NamedTuple):
    """One tick's random numbers (the reference draws them inside the
    tick from ``jax.random.split(state.key, 3)``)."""

    key: torch.Tensor        # (G, 2) the carried key after the tick
    u_arr: torch.Tensor      # (G, A, 6 or 7) per-lane attribute uniforms
    # (G, ST, R, 2) execution-time uniforms, R = min(worker rows, Q)
    u_exec: torch.Tensor
    # (G, CD, 2) the coordinator drain's uniforms, from fold_in(k_arr, 1);
    # empty, (G, 0, 2), unless cfg.coordinator
    u_stage: torch.Tensor | None = None


def draw_ticks(cfg: FleetConfig, key: torch.Tensor, n: int
               ) -> list[TickDraws]:
    """The draws of the next ``n`` ticks from the carried ``key``, exactly
    the reference's: each tick splits its key into (next key, k_arr,
    k_exec) and draws ``uniform(k_arr, (A, 6 or 7))`` and
    ``uniform(k_exec, (ST, R, 2))``.  The key chain is sequential, one split
    per tick (``R`` is ``min(W, Q)`` for the server stage's ``W`` worker
    rows: the decode slots under the batch server); the uniforms of all
    ``n`` ticks come from two threefry passes
    over the batched keys, which saves most of a pass per tick.  With the
    coordinator stage on, each tick also draws the reference's
    ``uniform(fold_in(k_arr, 1), (CD, 2))`` (a key of its own, so the
    always-on draws do not move)."""
    chain = []
    for _ in range(n):
        keys = jr.split(key, 3)
        key = keys[:, 0]
        chain.append(keys)
    keys = torch.stack(chain, dim=1)                 # (G, n, 3, 2)
    st = cfg.n_racks * cfg.n_servers
    u_arr = jr.uniform(keys[:, :, 1],
                       (cfg.max_arrivals, 7 if cfg.n_racks > 1 else 6))
    u_exec = jr.uniform(keys[:, :, 2],
                        (st, min(worker_lanes(cfg), cfg.queue_cap), 2))
    if cfg.coordinator:
        k_stage = jr.fold_in(keys[:, :, 1], 1)
        u_stage = jr.uniform(k_stage, (cfg.drain_per_tick, 2)).unbind(1)
    else:
        u_stage = u_arr.new_empty((u_arr.shape[0], n, 0, 2)).unbind(1)
    return [TickDraws(keys[:, i, 0], u_arr[:, i], u_exec[:, i], u_stage[i])
            for i in range(n)]


# ----------------------------------------------------------------- contexts --
class Arrivals(NamedTuple):
    """Per-tick arrival context: admitted lanes + flattened fabric views
    (all ``(G, A)`` unless noted; server ids are fabric-global int64).
    ``tick`` and ``t_us`` are Python numbers on the staged loop and 0-d
    device tensors inside a captured chunk (:mod:`repro_torch.fleetsim.
    fused`)."""

    tick: int | torch.Tensor
    t_us: float | torch.Tensor   # float32 value
    down: torch.Tensor       # (G,) bool — fabric dark this tick
    u_exec: torch.Tensor     # (G, ST, R, 2) the server stage's uniforms
    sstate: torch.Tensor     # (G, ST) view of StateT
    tables: torch.Tensor     # (G, (RK+1)·T, slots) view of the tables
    active: torch.Tensor     # admitted arrival lanes
    grp: torch.Tensor        # GrpT index
    fidx: torch.Tensor       # filter-table index within a group
    client: torch.Tensor     # client id
    base: torch.Tensor       # intrinsic service demand (µs)
    home: torch.Tensor       # home rack
    r1: torch.Tensor         # first uniform candidate
    r2: torch.Tensor         # second uniform candidate
    r2_local: torch.Tensor   # second candidate, rack-local
    pair: torch.Tensor | None = None     # (G, A, 2) GrpT pair (route stage)
    u_stage: torch.Tensor | None = None  # (G, CD, 2) coordinator uniforms


class Routed(NamedTuple):
    """Route-stage outputs the optional stages read, ``(G, A)``."""

    req_id: torch.Tensor     # int32 spine-assigned REQ_IDs
    cloned: torch.Tensor     # bool immediate-clone mask
    frack: torch.Tensor      # int64 filter switch (home rack or spine)


class Lanes(NamedTuple):
    """Delivery lanes headed for the server stage, ``(G, D)``;
    ``payload`` rows are ``QF``-format queue records.  The optional stages
    append their dispatches with :meth:`extend`."""

    dst: torch.Tensor        # int64 destination server
    act: torch.Tensor        # bool
    clo: torch.Tensor        # int32
    payload: torch.Tensor    # (G, D, QF) float32

    def extend(self, dst, act, clo, payload) -> "Lanes":
        return Lanes(
            dst=torch.cat([self.dst, dst.to(torch.int64)], dim=1),
            act=torch.cat([self.act, act], dim=1),
            clo=torch.cat([self.clo, clo.to(_I32)], dim=1),
            payload=torch.cat([self.payload, payload], dim=1))


class Responses(NamedTuple):
    """Compacted completion lanes leaving the server stage, ``(G, K)``."""

    active: torch.Tensor
    rid: torch.Tensor        # int32
    clo: torch.Tensor        # int32
    idx: torch.Tensor        # int64
    client: torch.Tensor     # int64
    tarr: torch.Tensor       # float32
    hop: torch.Tensor        # float32
    frack: torch.Tensor      # int64
    sid: torch.Tensor        # int64
    qlen: torch.Tensor       # int32


# ------------------------------------------------------------------- stages --
def tick_time(cfg: FleetConfig, tick):
    """A tick's start time in µs as float32: ``float32(tick) ·
    float32(dt_us)``, the reference's product.  ``tick`` is a Python int or
    a 0-d integer tensor; the two give the same bits (the int converts
    exactly below 2^24, and the product of two float32 values is exact in
    float64, so it rounds once either way)."""
    if isinstance(tick, torch.Tensor):
        return tick.to(_F32) * _f32(cfg.dt_us)
    return _f32(np.float32(tick) * np.float32(cfg.dt_us))


def stage_arrival(cfg: FleetConfig, params, state: FleetState, xs,
                  recover_ticks=None):
    """Admission + attributes: recovery wipe, Poisson/trace lane masking,
    and the per-lane attributes from the tick's one uniform block (the
    ``n_racks == 1`` column layout matches the single-ToR engine draw for
    draw).  ``xs`` is ``(tick, n_raw, draws)``: ``tick`` a Python int or a
    0-d device tensor, ``n_raw`` ``(G,)``, ``draws`` the tick's
    :class:`TickDraws`.  ``recover_ticks``, when given, is the set of ticks
    at which some config's failure window ends; at a Python-int tick
    outside it the wipe is skipped (it changes nothing there).  A tensor
    tick always applies the masked wipe."""
    RK, S, C = cfg.n_racks, cfg.n_servers, cfg.n_clients
    ST = RK * S
    T = cfg.n_filter_tables
    A = cfg.max_arrivals
    tick, n_raw, draws = xs
    g, dev = n_raw.shape[0], n_raw.device
    m = state.metrics
    t_us = tick_time(cfg, tick)
    down = (tick >= params.fail_from_tick) & (tick < params.fail_until_tick)
    # §3.6 recovery: all soft state lost, REQ_IDs restart from 1; the
    # clients' pending-request fingerprints of lost requests go with it
    switch = state.switch
    if (recover_ticks is None or isinstance(tick, torch.Tensor)
            or tick in recover_ticks):
        recover = params.fail_until_tick == tick
        switch = switch._replace(
            seq=torch.where(recover, 0, switch.seq).to(_I32))
        # zeroed by a 0/1 factor: the same ints as a masked fill, and on
        # the CPU far cheaper than a fill under a broadcast mask
        keep = (~recover).to(_I32)
        switch.server_state.mul_(keep[:, None, None])
        switch.filter_tables.mul_(keep[:, None, None, None])
        state.dedup.mul_(keep[:, None])
        if cfg.hedge_timer:
            # pending hedge timers are switch soft state too; the
            # coordinator node is not (a server-side CPU box, as in the DES)
            state.wheel.count.mul_(keep[:, None])
            state.wheel.data.mul_(keep.to(_F32)[:, None, None, None])
    sstate = switch.server_state.view(g, ST)
    tables = switch.filter_tables.view(g, (RK + 1) * T, cfg.n_filter_slots)

    # one uniform block covers every per-lane attribute draw (the home-
    # rack column only exists when there is more than one rack)
    u = draws.u_arr

    # -- arrivals (Poisson count precomputed outside the tick loop) ------
    n_arr = torch.clamp(n_raw, max=A)
    arr_active = torch.arange(A, device=dev) < n_arr[:, None]
    m = m._replace(n_truncated=m.n_truncated + (n_raw - n_arr),
                   n_dropped_down=m.n_dropped_down
                   + torch.where(down, n_arr, 0).to(_I32))
    arr_active = arr_active & ~down[:, None]
    m = m._replace(n_arrivals=m.n_arrivals + _sum(arr_active))

    def to_int(col, n):
        return torch.clamp((u[..., col] * n).to(torch.int64), max=n - 1)

    grp = to_int(0, cfg.n_groups)
    fidx = to_int(1, T)
    client = to_int(2, C)
    base = _intrinsic(cfg, u[..., 3])
    r1 = to_int(4, S)
    r2 = (r1 + 1 + to_int(5, S - 1)) % S
    if RK > 1:
        # inverse-CDF pick over the (possibly skewed) rack weights
        cw = torch.cumsum(params.rack_weights, dim=1)
        v = u[..., 6] * cw[:, -1:]
        home = (cw[:, None, :] <= v[:, :, None]).sum(dim=2)
        home = torch.clamp(home, max=RK - 1)
    else:
        home = torch.zeros((g, A), dtype=torch.int64, device=dev)
    off = home * S               # local → fabric-global server ids
    state = state._replace(switch=switch, key=draws.key, metrics=m)
    return state, Arrivals(
        tick=tick, t_us=t_us, down=down, u_exec=draws.u_exec, sstate=sstate,
        tables=tables, active=arr_active, grp=grp, fidx=fidx, client=client,
        base=base, home=home, r1=off + r1, r2=off + r2,
        r2_local=r2, u_stage=draws.u_stage)


def stage_route(cfg: FleetConfig, params, state: FleetState, arr: Arrivals,
                group_pairs: torch.Tensor, xhop: float, ids=None):
    """ToR routing + spine placement; emits the base delivery lanes
    (originals then clones).  Returns ``(state, arr, routed, lanes)``:
    ``arr`` gains the GrpT pairs, ``routed`` is what the optional stages
    read.  ``ids``: the policy ids present in the batch."""
    RK, S = cfg.n_racks, cfg.n_servers
    A = cfg.max_arrivals
    g, dev = arr.active.shape[0], arr.active.device
    m = state.metrics
    switch = state.switch
    arr_active = arr.active

    pair = group_pairs[arr.grp] + (arr.home * S)[:, :, None]
    dst1, dst2, cloned, clo1, clo2 = route_fabric(
        params.policy_id, arr.sstate, pair, arr.r1, arr.r2, arr.home,
        arr.r2_local, n_racks=RK, n_servers=S,
        dead=link_dead(params, arr.tick), ids=ids)
    xrack = cloned & ((dst1 // S) != (dst2 // S))
    # the filter switch of a pair: its home rack ToR, or the spine
    # (table group RK) when the copies span racks
    frack = torch.where(xrack, RK, arr.home)
    req_id = (switch.seq[:, None] + 1
              + torch.arange(A, dtype=_I32, device=dev)).to(_I32)
    switch = switch._replace(seq=(switch.seq + A).to(_I32))
    m = m._replace(
        n_cloned=m.n_cloned + _sum(arr_active & cloned),
        n_interrack_cloned=m.n_interrack_cloned + _sum(arr_active & xrack))

    # delivery lanes: clone copies sort after originals; the remote copy
    # of an inter-rack pair carries its spine detour as a per-copy hop term
    d_dst = torch.cat([dst1, dst2], dim=1)
    d_clo = torch.cat([clo1, clo2], dim=1)
    d_act = torch.cat([arr_active, arr_active & cloned], dim=1)
    d_hop = torch.cat([torch.zeros((g, A), dtype=_F32, device=dev),
                       torch.where(xrack, xhop, 0.0).to(_F32)], dim=1)

    def tile(x):
        return torch.cat([x, x], dim=1).to(_F32)

    payload = torch.stack([                          # (G, D, QF)
        tile(arr.base),
        _full_t_us(arr, d_hop),
        tile(req_id),
        d_clo.to(_F32),
        tile(arr.fidx),
        tile(arr.client),
        d_hop,
        tile(frack),
    ], dim=2)
    state = state._replace(switch=switch, metrics=m)
    if cfg.telemetry:
        # REQ_IDs are assigned here at the spine, so the arrival event is
        # emitted here too (same tick; emit order preserves stage order)
        tr = emit(state.trace, arr_active, tick=arr.tick, kind=EV_ARRIVAL,
                  rid=req_id, client=arr.client, arg=arr.home)
        tr = emit(tr, arr_active, tick=arr.tick, kind=EV_ROUTE,
                  rid=req_id, server=dst1, client=arr.client, arg=cloned)
        tr = emit(tr, arr_active & cloned, tick=arr.tick, kind=EV_CLONE,
                  rid=req_id, server=dst2, client=arr.client,
                  arg=torch.where(xrack, CLONE_SRC_INTERRACK,
                                  CLONE_SRC_LOCAL))
        state = state._replace(trace=tr)
    return (state, arr._replace(pair=pair),
            Routed(req_id=req_id, cloned=cloned, frack=frack),
            Lanes(dst=d_dst, act=d_act, clo=d_clo, payload=payload))


def _coordinator_picks(cfg: FleetConfig, params, arr: Arrivals, is_coord,
                       ids, queued):
    """The drain's dispatch rule as ``pick(j, idle, c) -> (s, f)`` for pop
    ``j``: ``idle`` ``(G, ST)`` the idle servers, ``c`` their inclusive
    running count (int64); ``s`` ``(G, 2)`` the two chosen servers (ST
    where the rule found none) and ``f`` ``(G, 2)`` int64 0/1: whether the
    pop may dispatch at all — a coordinator config with ``n_idle ≥ 1`` and
    an entry left for pop ``j`` (``j < queued``, the ring's count after
    this tick's parking) — and whether it may also clone (the rule's
    wish).  The credit test is the caller's.

    Each config takes its policy's registered ``coordinator`` hook; a
    config without one picks nothing.  When every present hook names a
    rank rule (``hook.ranks``, see ``policies.laedge_coordinator``), the
    rule is tabulated once a tick over every idle count ``0 … ST`` and
    the pop's picks are two table lookups and one ``searchsorted`` (the
    first entry of ``c`` reaching ``i+1`` is the ``i``-th idle server);
    otherwise each hook is called for each pop."""
    ST = cfg.n_servers_total
    g, dev = is_coord.shape[0], is_coord.device
    hooks = registry.coordinator_branches()
    coord_ids = [i for i in ids if i in registry.coordinator_ids()]
    u = arr.u_stage                                  # (G, CD, 2)
    cd = u.shape[1]
    # an entry is left for pop j: the pops before it all dispatched (the
    # drain stops at its first idle pop, whose inputs then never change)
    left = (torch.arange(cd, device=dev) < queued[:, None]) \
        & is_coord[:, None]                          # (G, CD)
    if all(getattr(hooks[i], "ranks", None) for i in coord_ids):
        # every idle count 0 … ST, for every pop of every config
        n_idle = torch.arange(ST + 1, device=dev).expand(g, cd, ST + 1)
        none = torch.full_like(n_idle, ST)
        i1, i2, want = select_branches(
            params.policy_id, {i: hooks[i].ranks for i in coord_ids},
            coord_ids, (n_idle, u[..., 0:1], u[..., 1:2]),
            default=(none, none, torch.zeros_like(none, dtype=torch.bool)))
        ok = (n_idle >= 1) & left[:, :, None]
        ranks = torch.stack([i1 + 1, i2 + 1], dim=3)   # (G, CD, ST+1, 2)
        flags = torch.stack([ok, ok & want], dim=3).to(torch.int64)

        def pick(j, idle, c):
            at = c[:, -1:, None].expand(g, 1, 2)
            return (torch.searchsorted(
                c, torch.gather(ranks[:, j], 1, at)[:, 0]),
                torch.gather(flags[:, j], 1, at)[:, 0])
        return pick

    def pick(j, idle, c):
        n_idle = c[:, -1]
        zero = torch.zeros_like(n_idle)
        s1, s2, want = select_branches(
            params.policy_id, hooks, coord_ids,
            (idle, n_idle, u[:, j, 0], u[:, j, 1]),
            default=(zero, zero, torch.zeros_like(is_coord)))
        ok = (n_idle >= 1) & left[:, j]
        return (torch.stack([s1, s2], dim=1),
                torch.stack([ok, ok & want], dim=1).to(torch.int64))
    return pick


def stage_coordinator(cfg: FleetConfig, params, state: FleetState,
                      arr: Arrivals, routed: Routed, lanes: Lanes, ids=None):
    """LÆDGE coordinator node (runs only when ``cfg.coordinator``).

    Arrival lanes of coordinator policies are parked in the ring instead
    of dispatched; the drain then pops FCFS entries onto servers chosen by
    the policy's registered rule, spending one CPU credit per transmitted
    copy.  Dispatches join the delivery lanes; the coordinator's
    ``outstanding`` view is decremented by the response stage.

    The reference's drain is a ``lax.scan`` of ``CD`` pops; here it is a
    loop of ``CD`` steps over the batch whose per-pop state is only the
    idle view and the credit.  The rest follows from which pops
    dispatched, after the loop, with the same values: a pop's ring head
    is the start head plus the pops before it, its CPU hop the credits
    spent before it, and the ring still holds an entry for pop ``j`` iff
    ``j`` is below the ring's count (a pop that cannot dispatch leaves
    every input of the next one unchanged, so the pops that dispatch are
    the first ones)."""
    if not cfg.coordinator:
        return state, lanes
    RK, W = cfg.n_racks, cfg.n_workers
    ST = cfg.n_servers_total
    CQ = cfg.coordinator_cap
    CD = cfg.drain_per_tick
    cpu = _f32(cfg.coord_cpu_us)
    g, dev = arr.active.shape[0], arr.active.device
    ids = _present(params) if ids is None else ids

    m = state.metrics
    coord = state.coord
    is_coord = id_mask(params.policy_id, registry.coordinator_ids())

    # coordinator lanes never dispatch directly
    lanes = lanes._replace(act=lanes.act & ~is_coord[:, None])

    # -- park this tick's arrivals in the ring -----------------------------
    enq = arr.active & is_coord[:, None]
    rank = _rank_among_earlier(enq)
    count0 = coord.count.to(torch.int64)[:, None]
    ok = enq & (count0 + rank < CQ)
    slot = (coord.head.to(torch.int64)[:, None] + count0 + rank) % CQ
    rows = torch.stack([                             # (G, A, QF)
        arr.base,
        _full_t_us(arr, arr.base),
        routed.req_id.to(_F32),
        torch.full_like(arr.base, float(CLO_ORIG)),
        arr.fidx.to(_F32),
        arr.client.to(_F32),
        torch.zeros_like(arr.base),
        torch.full_like(arr.base, float(RK)),  # pairs filter at the top tier
    ], dim=2)
    scatter_last(coord.data, slot, rows, ok)
    n_ok = _sum(ok)
    m = m._replace(n_coord_queued=m.n_coord_queued + n_ok,
                   n_coord_overflow=m.n_coord_overflow + _sum(enq & ~ok))
    if cfg.telemetry:
        state = state._replace(trace=emit(
            state.trace, ok, tick=arr.tick, kind=EV_COORD_ENQ,
            rid=routed.req_id, client=arr.client,
            arg=count0 + rank))  # arg: ring depth at enqueue

    # -- drain: FCFS pops onto idle servers, CPU-credit throttled ----------
    credit = torch.clamp(coord.credit + _f32(np.float32(cfg.dt_us)
                                             / np.float32(cfg.coord_cpu_us)),
                         max=float(CD))
    # a sentinel column ST takes the adds of pops that pick no server
    outstanding = torch.cat([coord.outstanding.to(torch.int64),
                             torch.zeros((g, 1), dtype=torch.int64,
                                         device=dev)], dim=1)
    queued = coord.count.to(torch.int64) + n_ok
    pick = _coordinator_picks(cfg, params, arr, is_coord, ids, queued)
    # credit thresholds of a dispatch and of a clone: a clone costs two
    # credits and is wished only with two in hand (a backed-up CPU
    # degrades to single-copy dispatch before it stalls — the negative
    # feedback the DES coordinator gets), so the pop dispatches iff one
    # credit is left and clones iff two are
    need = torch.arange(1.0, 3.0, device=dev)       # [1, 2]; no host copy
    picks, sends = [], []
    for j in range(CD):
        idle = outstanding[:, :ST] < W
        c = torch.cumsum(idle, dim=1)
        s, f = pick(j, idle, c)
        send = f * (credit[:, None] >= need)         # (G, 2): can, clone
        outstanding.scatter_add_(1, s, send)
        credit = credit - send.sum(dim=1)
        picks.append(s)
        sends.append(send)
    s = torch.stack(picks, dim=1) % ST               # (G, CD, 2)
    send = torch.stack(sends, dim=1)                 # (G, CD, 2) 0/1
    can, do_clone = send[..., 0], send[..., 1]
    spend = send.sum(dim=2).to(_F32)                 # credits a pop spent
    # CPU serialization inside the tick: the j-th transmitted copy waits
    # for the copies before it (credits spent: exact small integers)
    spent = torch.cumsum(spend, dim=1) - spend
    hop1 = torch.where(can > 0, (spent + 1.0) * cpu, 0.0)
    hop2 = torch.where(do_clone > 0, (spent + 2.0) * cpu, 0.0)
    n_pop = can.sum(dim=1)
    heads = (coord.head.to(torch.int64)[:, None]
             + torch.cumsum(can, dim=1) - can) % CQ
    row = torch.gather(coord.data, 1, heads[:, :, None].expand(g, CD, QF))

    def with_hop(hop):
        return torch.cat([row[..., :QF_HOP], hop[..., None],
                          row[..., QF_HOP + 1:]], dim=2)

    m = m._replace(n_cloned=m.n_cloned + _sum(do_clone > 0))
    if cfg.telemetry:
        rid_pop = row[..., QF_RID]
        cli_pop = row[..., QF_CLIENT]
        tr = emit(state.trace, can > 0, tick=arr.tick,
                  kind=EV_COORD_DISPATCH, rid=rid_pop, server=s[..., 0],
                  client=cli_pop, arg=do_clone)
        tr = emit(tr, do_clone > 0, tick=arr.tick, kind=EV_CLONE,
                  rid=rid_pop, server=s[..., 1], client=cli_pop,
                  arg=CLONE_SRC_COORD)
        state = state._replace(trace=tr)
    clo = torch.full((g, CD), CLO_ORIG, dtype=_I32, device=dev)
    lanes = lanes.extend(s[..., 0], can > 0, clo, with_hop(hop1))
    lanes = lanes.extend(s[..., 1], do_clone > 0, clo, with_hop(hop2))
    state = state._replace(
        metrics=m,
        coord=coord._replace(
            outstanding=outstanding[:, :ST].to(_I32),
            head=((coord.head.to(torch.int64) + n_pop) % CQ).to(_I32),
            count=(queued - n_pop).to(_I32), credit=credit))
    return state, lanes


def wheel_arm(wheel: HedgeWheel, tick, delay_ticks, arm_mask, entries):
    """Arm ``entries`` ``(G, L, WH)`` (one row per True in ``arm_mask``
    ``(G, L)``) to fire ``delay_ticks`` ``(G,)`` from ``tick``.  The wheel
    is updated in place.

    Returns ``(wheel, armed_mask, dropped_mask)``: lanes beyond the slot's
    free width are dropped *deterministically* — the latest lanes lose,
    and a lane is never dropped while the slot has room."""
    g, n_slots, width, _ = wheel.data.shape
    slot = (tick + delay_ticks.to(torch.int64)) % n_slots        # (G,)
    pos = (torch.gather(wheel.count, 1, slot[:, None]).to(torch.int64)
           + _rank_among_earlier(arm_mask))
    ok = arm_mask & (pos < width)
    scatter_last(wheel.data.view(g, n_slots * width, -1),
                 slot[:, None] * width + pos, entries, ok)
    wheel.count.scatter_add_(1, slot[:, None], _sum(ok)[:, None])
    return wheel, ok, arm_mask & ~ok


def wheel_fire(wheel: HedgeWheel, tick):
    """Pop every entry due at ``tick`` (the wheel is deeper than the delay
    horizon, so everything in the slot is due).  Returns ``(wheel,
    due_mask, entries)`` with the slot cleared in place; ``entries`` is a
    copy."""
    g, n_slots, width, _ = wheel.data.shape
    if isinstance(tick, torch.Tensor):
        slot = (tick % n_slots).reshape(1)
        entries = wheel.data.index_select(1, slot)[:, 0]
        count = wheel.count.index_select(1, slot)
        wheel.count.index_fill_(1, slot, 0)
    else:
        slot = tick % n_slots
        entries = wheel.data[:, slot].clone()
        count = wheel.count[:, slot:slot + 1].clone()
        wheel.count[:, slot] = 0
    due = torch.arange(width, device=count.device) < count
    return wheel, due, entries


def stage_hedge_timer(cfg: FleetConfig, params, state: FleetState,
                      arr: Arrivals, routed: Routed, lanes: Lanes, ids=None):
    """Delayed hedging (runs only when ``cfg.hedge_timer``).

    Fires this tick's due duplicates as CLO=2 delivery lanes — unless the
    original's response already parked its fingerprint at the lane's
    filter switch, which is the array form of the DES's cancel-on-first-
    response — then arms a wheel entry for every hedge-policy arrival.
    The filter tables are read here, before this tick's response filter
    updates them in place."""
    if not cfg.hedge_timer:
        return state, lanes
    T = cfg.n_filter_tables
    A = cfg.max_arrivals
    ids = _present(params) if ids is None else ids
    m = state.metrics
    is_hedge = id_mask(params.policy_id, registry.hedge_timer_ids())

    # -- fire due entries --------------------------------------------------
    wheel, due, entries = wheel_fire(state.wheel, arr.tick)
    g, hw = due.shape
    rid = entries[..., WHEEL_RID].to(_I32)
    tbl = ((entries[..., WHEEL_FRACK].to(torch.int64) * T
            + entries[..., WHEEL_IDX].to(torch.int64))
           * cfg.n_filter_slots + fingerprint_slot(rid, cfg.n_filter_slots))
    parked = torch.gather(arr.tables.reshape(g, -1), 1, tbl) == rid
    fire = due & ~parked & ~arr.down[:, None]  # a dark fabric loses it
    cancelled = due & ~fire
    zero = torch.zeros_like(entries[..., WHEEL_BASE])
    pay = torch.stack([                              # (G, HW, QF)
        entries[..., WHEEL_BASE],
        entries[..., WHEEL_TARR],       # latency runs from the ORIGINAL
        entries[..., WHEEL_RID],        # arrival, so the hedge pays the
        zero + float(CLO_CLONE),        # delay floor
        entries[..., WHEEL_IDX],
        entries[..., WHEEL_CLIENT],
        zero,
        entries[..., WHEEL_FRACK],
    ], dim=2)
    lanes = lanes.extend(entries[..., WHEEL_DST].to(torch.int64), fire,
                         torch.full((g, hw), CLO_CLONE, dtype=_I32,
                                    device=fire.device), pay)
    m = m._replace(n_cloned=m.n_cloned + _sum(fire),
                   n_hedges_cancelled=m.n_hedges_cancelled
                   + _sum(cancelled))
    if cfg.telemetry:
        cli_w = entries[..., WHEEL_CLIENT]
        dst_w = entries[..., WHEEL_DST]
        tr = emit(state.trace, fire, tick=arr.tick, kind=EV_CLONE,
                  rid=rid, server=dst_w, client=cli_w, arg=CLONE_SRC_HEDGE)
        tr = emit(tr, cancelled, tick=arr.tick, kind=EV_HEDGE_CANCELLED,
                  rid=rid, server=dst_w, client=cli_w)
        state = state._replace(trace=tr)

    # -- arm this tick's arrivals ------------------------------------------
    dst2 = select_branches(
        params.policy_id, registry.hedge_timer_branches(),
        [i for i in ids if i in registry.hedge_timer_ids()],
        (arr.pair, arr.r1, arr.r2), default=arr.r2)
    rows = torch.stack([                             # (G, A, WH)
        routed.req_id.to(_F32),
        dst2.to(_F32),
        arr.fidx.to(_F32),
        arr.client.to(_F32),
        arr.base,
        _full_t_us(arr, arr.base),
        routed.frack.to(_F32),
    ], dim=2)
    assert rows.shape[2] == WH and rows.shape[1] == A
    wheel, armed, dropped = wheel_arm(wheel, arr.tick,
                                      params.hedge_delay_ticks,
                                      arr.active & is_hedge[:, None], rows)
    m = m._replace(n_hedges_armed=m.n_hedges_armed + _sum(armed),
                   n_wheel_dropped=m.n_wheel_dropped + _sum(dropped))
    state = state._replace(metrics=m, wheel=wheel)
    if cfg.telemetry:
        state = state._replace(trace=emit(
            state.trace, armed, tick=arr.tick, kind=EV_HEDGE_ARMED,
            rid=routed.req_id, server=dst2, client=arr.client,
            arg=params.hedge_delay_ticks[:, None]))  # arg: delay (ticks)
    return state, lanes


def stage_server(cfg: FleetConfig, params, state: FleetState,
                 arr: Arrivals, lanes: Lanes, div: Divisors):
    """Workers advance, the server-side CLO=2 drop rule, FCFS ring enqueue,
    and dequeue of the oldest queued jobs onto the freed workers (their
    execution times from the tick's ``arr.u_exec`` uniforms).

    ``cfg.server_model == "batch"`` hands the tick to ServeSim's
    continuous-batching slot stage (:func:`repro_torch.fleetsim.llmserve.
    stage.stage_server_batch`); ``"fcfs"`` runs exactly the tick it always
    did."""
    if cfg.server_model == "batch":
        # deferred import: llmserve.stage reuses this module's helpers
        from repro_torch.fleetsim.llmserve.stage import stage_server_batch

        return stage_server_batch(cfg, params, state, arr, lanes,
                                  div.slots)
    g = lanes.dst.shape[0]
    ST, W = cfg.n_servers_total, cfg.n_workers
    # -- workers advance, completions (busy ⇔ REM > 0) ---------------
    meta = state.workers.meta.view(g, ST, W, WF)
    was_busy = meta[..., WF_REM] > 0
    rem = torch.where(was_busy, meta[..., WF_REM] - _f32(cfg.dt_us), 0.0)
    return serve_lanes(cfg, params, state, arr, lanes, meta, was_busy, rem)


def serve_lanes(cfg: FleetConfig, params, state: FleetState, arr: Arrivals,
                lanes: Lanes, meta, was_busy, rem):
    """The server stage after the worker rows advanced: ``meta`` ``(G, ST,
    W, WF)`` the rows before the tick, ``was_busy`` and ``rem`` ``(G, ST,
    W)`` their busy mask and remaining demand after it.  A row is done when
    its demand ran out; then the CLO=2 drop rule, the FCFS ring enqueue,
    the dequeue of the ring heads onto the free rows, the compaction of
    the completions into the response lanes and, with ``cfg.telemetry``,
    their finish and start events.  The FCFS stage and the batch server
    (:func:`repro_torch.fleetsim.llmserve.stage.stage_server_batch`,
    whose rows are decode slots) share it, as the reference's two stages
    share their code line for line."""
    RK, S, Q = cfg.n_racks, cfg.n_servers, cfg.queue_cap
    ST, W = RK * S, meta.shape[2]
    g, dev = lanes.dst.shape[0], lanes.dst.device
    srv_ids = torch.arange(ST, device=dev)
    m = state.metrics
    d_dst, d_act, d_clo = lanes.dst, lanes.act, lanes.clo

    def at_dst(x):               # (G, ST) per-server value of each lane
        return torch.gather(x, 1, d_dst)

    def own(rank):               # (G, ST, D) → each lane's own row
        return torch.gather(rank, 1, d_dst[:, None, :])[:, 0]

    done = was_busy & (rem <= 0)                     # (G, ST, W)
    busy_after = was_busy & ~done
    n_free = (~busy_after).sum(dim=2)                # (G, ST)
    rq = state.queues
    q_head = rq.head.view(g, ST).to(torch.int64)
    n_queued = rq.count.view(g, ST).to(torch.int64)

    # -- CLO=2 drop rule --------------------------------------------
    # A clone is dropped iff the server's wait queue is non-empty when it
    # arrives; two passes resolve the (rare) dependence of one clone's
    # fate on an earlier clone's (see the reference)
    q_left = torch.clamp(n_queued - n_free, min=0)   # still waiting
    free_left = torch.clamp(n_free - n_queued, min=0)  # still free
    onehot = d_dst[:, None, :] == srv_ids[None, :, None]   # (G, ST, D)
    is_clone = d_clo == CLO_CLONE
    n_earlier = _rank_among_earlier(onehot & (d_act & ~is_clone)[:, None])
    occupied = (at_dst(q_left) > 0) | (own(n_earlier) > at_dst(free_left))
    drop0 = is_clone & d_act & occupied
    keep0 = d_act & ~drop0
    n_earlier1 = _rank_among_earlier(onehot & keep0[:, None])
    occupied1 = (at_dst(q_left) > 0) | (own(n_earlier1)
                                        > at_dst(free_left))
    clone_drop = is_clone & d_act & occupied1
    d_keep = d_act & ~clone_drop
    m = m._replace(n_clone_drops=m.n_clone_drops + _sum(clone_drop))

    # -- enqueue into the FCFS rings ---------------------------------
    # the r-th kept lane for a server lands r slots past its tail
    lane_m = onehot & d_keep[:, None]                # (G, ST, D)
    rank_own = own(_rank_among_earlier(lane_m))
    ovf = d_keep & (at_dst(n_queued) + rank_own >= Q)
    m = m._replace(n_overflow=m.n_overflow + _sum(ovf))
    enq_ok = d_keep & ~ovf
    slot = (at_dst(q_head) + at_dst(n_queued) + rank_own) % Q
    flat_q = rq.data.view(g, ST * Q, rq.data.shape[-1])
    scatter_last(flat_q, d_dst * Q + slot, lanes.payload, enq_ok)
    count1 = n_queued + (onehot & enq_ok[:, None]).sum(dim=2)

    # -- dequeue: ring head onto free workers ------------------------
    R = min(W, Q)
    n_start = torch.minimum(count1, n_free)          # (G, ST)
    r = torch.arange(R, device=dev)
    startm = r < n_start[:, :, None]                 # (G, ST, R)
    deq_slot = (q_head[:, :, None] + r) % Q          # (G, ST, R)
    rows = (srv_ids[None, :, None] * Q + deq_slot).reshape(g, ST * R)
    job = torch.gather(flat_q, 1, rows[:, :, None].expand(
        g, ST * R, flat_q.shape[-1])).view(g, ST, R, -1)
    # r-th free worker of each server, via rank matching (no sort)
    wfree = ~busy_after
    wrank = _rank_among_earlier(wfree)               # (G, ST, W)
    sel = wfree[:, :, None, :] & (wrank[:, :, None, :]
                                  == r[None, None, :, None])  # (G,ST,R,W)
    wcol = (sel * torch.arange(W, device=dev)).sum(dim=3)
    exec_dur = _execute(cfg, arr.u_exec, job[..., QF_BASE]) \
        * params.slowdown[:, :, None]
    wrow = srv_ids[None, :, None] * W + wcol          # (G, ST, R)
    # responses are read from the PRE-overwrite worker metadata
    meta_flat = torch.cat(
        [torch.where(busy_after, rem, 0.0)[..., None], meta[..., 1:]],
        dim=3).view(g, ST * W, WF)
    q_count = count1 - n_start
    resp_payload = torch.cat([                       # (G, ST·W, WF + 2)
        meta_flat,
        srv_ids.repeat_interleave(W).to(_F32)[None, :, None].expand(
            g, ST * W, 1),
        q_count.repeat_interleave(W, dim=1).to(_F32)[:, :, None]], dim=2)
    new_meta = torch.stack([
        exec_dur + cfg.server_overhead_us,
        job[..., QF_TARR], job[..., QF_RID], job[..., QF_CLO],
        job[..., QF_IDX], job[..., QF_CLIENT],
        job[..., QF_HOP], job[..., QF_FRACK]], dim=3)  # (G, ST, R, WF)
    scatter_last(meta_flat, wrow.reshape(g, -1),
                 new_meta.reshape(g, ST * R, WF), startm.reshape(g, -1))
    queues = rq._replace(
        head=((q_head + n_start) % Q).to(_I32).view(g, RK, S),
        count=q_count.to(_I32).view(g, RK, S))

    # -- compact completions into the response lanes -----------------
    K = min(cfg.max_responses, ST * W)
    done_flat = done.reshape(g, ST * W)
    n_done_all = _sum(done_flat)
    m = m._replace(
        n_resp=m.n_resp + n_done_all,
        n_resp_empty=m.n_resp_empty + _sum(
            done_flat & (q_count.repeat_interleave(W, dim=1) == 0)),
        lost_down_resp=m.lost_down_resp
        + torch.where(arr.down, n_done_all, 0).to(_I32))
    rrank = _rank_among_earlier(done_flat)
    clipped = done_flat & (rrank >= K)
    m = m._replace(n_resp_clipped=m.n_resp_clipped + _sum(clipped))
    resp = torch.zeros((g, K, WF + 2), dtype=_F32, device=dev)
    scatter_last(resp, rrank, resp_payload, done_flat & ~clipped)
    n_done = torch.clamp(n_done_all, max=K)
    resp_active = ((torch.arange(K, device=dev) < n_done[:, None])
                   & ~arr.down[:, None])

    state = state._replace(
        queues=queues,
        workers=state.workers._replace(
            meta=meta_flat.view(g, RK, S, W, WF)),
        metrics=m)
    if cfg.telemetry:
        # finishes before starts: completions free the rows the dequeued
        # jobs then occupy, and emit order is the within-tick order; a
        # finish's fields are the pre-overwrite rows, copied into
        # resp_payload before the dequeue wrote meta_flat
        tr = emit(state.trace, done_flat, tick=arr.tick,
                  kind=EV_SERVER_FINISH, rid=resp_payload[..., WF_RID],
                  server=srv_ids.repeat_interleave(W),
                  client=resp_payload[..., WF_CLIENT],
                  arg=q_count.repeat_interleave(W, dim=1))  # qlen left
        tr = emit(tr, startm.reshape(g, -1), tick=arr.tick,
                  kind=EV_SERVER_START, rid=job[..., QF_RID].reshape(g, -1),
                  server=srv_ids.repeat_interleave(R),
                  client=job[..., QF_CLIENT].reshape(g, -1),
                  arg=job[..., QF_CLO].reshape(g, -1))
        state = state._replace(trace=tr)

    def field(i, dtype):
        return resp[..., i].to(dtype)

    return state, Responses(
        active=resp_active,
        rid=field(WF_RID, _I32),
        clo=field(WF_CLO, _I32),
        idx=field(WF_IDX, torch.int64),
        client=field(WF_CLIENT, torch.int64),
        tarr=resp[..., WF_TARR],
        hop=resp[..., WF_HOP],
        frack=field(WF_FRACK, torch.int64),
        sid=field(WF, torch.int64),
        qlen=field(WF + 1, _I32))


def stage_response_filter(cfg: FleetConfig, params, state: FleetState,
                          arr: Arrivals, resp: Responses, out=None):
    """Switch response path: StateT update + the fingerprint filter at each
    pair's filter switch, one flattened-table call for the whole fabric,
    plus the coordinator's response-side bookkeeping.  ``out``: a ``(G,
    K)`` bool buffer the ``pallas`` and ``tickfuse`` backends write the
    drop flags into."""
    RK = cfg.n_racks
    T = cfg.n_filter_tables
    m = state.metrics
    idx_flat = resp.frack * T + resp.idx
    drop = _filter_responses(cfg, arr.sstate, arr.tables, resp.rid,
                             idx_flat, resp.clo, resp.sid, resp.qlen,
                             resp.active, out)
    m = m._replace(
        n_filtered=m.n_filtered + _sum(drop & resp.active),
        n_spine_filtered=m.n_spine_filtered
        + _sum(drop & resp.active & (resp.frack == RK)))
    state = state._replace(metrics=m)
    if cfg.telemetry:
        state = state._replace(trace=emit(
            state.trace, drop & resp.active, tick=arr.tick,
            kind=EV_FILTER_DROP, rid=resp.rid, server=resp.sid,
            client=resp.client, arg=resp.frack))  # arg: filter switch
    if cfg.coordinator:
        # every response of a coordinator policy passes back through the
        # coordinator CPU: it costs a credit and frees an outstanding slot
        # (the idleness signal the next tick's drain reads)
        coord = state.coord
        is_coord = id_mask(params.policy_id, registry.coordinator_ids())
        dec = resp.active & is_coord[:, None]
        scatter_add_drop(coord.outstanding, resp.sid, -1, dec)
        credit = coord.credit - _sum(dec).to(_F32)
        state = state._replace(coord=coord._replace(
            credit=torch.clamp(credit, min=-float(cfg.drain_per_tick))))
    return state, drop


def stage_client(cfg: FleetConfig, params, state: FleetState,
                 arr: Arrivals, resp: Responses, drop, const_lat,
                 div: Divisors):
    """Client receiver threads: dedup of redundant copies, FCFS backlog
    with per-response RX cost, latency recording into the per-rack
    log-spaced histograms."""
    RK, S, C = cfg.n_racks, cfg.n_servers, cfg.n_clients
    g, dev = drop.shape[0], drop.device
    dt = _f32(cfg.dt_us)
    t0_us = _f32(cfg.warmup_us)
    t1_us = _f32(cfg.duration_us)
    m = state.metrics

    deliver = resp.active & ~drop
    _, redundant, evicted = dedup_tick(state.dedup, resp.rid, deliver)
    first = deliver & ~redundant
    m = m._replace(n_redundant=m.n_redundant + _sum(redundant),
                   n_dedup_evicted=m.n_dedup_evicted + evicted,
                   n_completed=m.n_completed + _sum(first))
    # receiver threads: FCFS backlog with per-response RX cost
    cli_onehot = ((resp.client[:, None, :]
                   == torch.arange(C, device=dev)[None, :, None])
                  & deliver[:, None, :])             # (G, C, K)
    pos = torch.gather(_rank_among_earlier(cli_onehot), 1,
                       resp.client[:, None, :])[:, 0]
    backlog_pre = torch.clamp(state.client_backlog - dt, min=0.0)
    wait = torch.gather(backlog_pre, 1, resp.client) \
        + (pos + 1) * cfg.client_rx_us
    backlog = backlog_pre + cli_onehot.sum(dim=2) * cfg.client_rx_us
    t_fin = arr.t_us + wait
    if cfg.coordinator:
        # coordinator responses serialize through its CPU before reaching
        # the client (same rank model as the receiver threads)
        is_coord = id_mask(params.policy_id, registry.coordinator_ids())
        crank = _rank_among_earlier(deliver)
        t_fin = t_fin + torch.where(is_coord[:, None] & deliver,
                                    (crank + 1.0) * cfg.coord_cpu_us, 0.0)
    lat = t_fin - resp.tarr + const_lat[:, None] + resp.hop
    rec = first & (t_fin >= t0_us) & (t_fin <= t1_us)
    # true float32 divisions, by tensors (``div``, ROADMAP C9)
    bins = torch.clamp(
        jr.log_f32(torch.maximum(lat, div.hist_lo) / div.hist_lo)
        / div.log_growth, 0, cfg.hist_bins - 1).to(torch.int64)
    # per-rack histograms, binned by the rack that served the winning
    # response (non-recorded lanes write nothing)
    hist = m.hist.view(g, RK * cfg.hist_bins)
    scatter_add_drop(hist, (resp.sid // S) * cfg.hist_bins + bins, 1, rec)
    m = m._replace(n_completed_win=m.n_completed_win + _sum(rec))
    state = state._replace(client_backlog=backlog.to(_F32), metrics=m)
    if cfg.telemetry:
        tr = emit(state.trace, first, tick=arr.tick,
                  kind=EV_CLIENT_COMPLETE, rid=resp.rid, server=resp.sid,
                  client=resp.client,
                  arg=torch.round(lat))  # arg: latency (µs)
        tr = emit(tr, redundant, tick=arr.tick, kind=EV_CLIENT_REDUNDANT,
                  rid=resp.rid, server=resp.sid, client=resp.client)
        state = state._replace(trace=tr, series=series_record_hist(
            state.series, arr.tick // cfg.window_ticks, bins, rec))
    return state


def _filter_responses(cfg, server_state, tables, rid, idx, clo, sid, qlen,
                      active, out=None):
    """Response path over the flattened fabric: StateT update + the
    fingerprint filter, with the backend ``cfg.filter_backend`` selects.
    ``server_state`` ``(G, n_racks·S)`` and ``tables`` ``(G, (n_racks+1)·
    n_tables, n_slots)`` are updated in place; returns ``drop`` (in ``out``
    under ``pallas`` and ``tickfuse``, when given)."""
    if cfg.filter_backend == "tickfuse":
        # StateT write + filter in one CUDA launch, which reads the lanes
        # as they are and neutralises the inactive ones itself
        # (kernels/tickfuse.py)
        return tickfuse_masked(server_state, tables, rid, idx, clo, sid,
                               qlen, active, out=out)[2]
    n_servers = server_state.shape[1]
    rid = rid.to(_I32).contiguous()
    idx = idx.to(_I32).contiguous()
    if cfg.filter_backend == "vectorized":
        st = SwitchState(seq=None, server_state=server_state,
                         filter_tables=tables)
        _, res = filter_tick_vectorized(st, rid, idx, clo, sid, qlen,
                                        active)
        return res.drop
    # scan / pallas: inactive lanes neutralised up front (CLO=0 never
    # touches the filter; an out-of-range sid never touches StateT), StateT
    # via the last-lane-wins scatter, then the table
    sid_m = torch.where(active, sid, n_servers).to(_I32).contiguous()
    clo_m = torch.where(active, clo, 0).to(_I32).contiguous()
    qlen = qlen.to(_I32).contiguous()
    scatter_last(server_state, sid_m, qlen, active)
    if cfg.filter_backend == "scan":
        return fingerprint_filter_ref(tables, rid, idx, clo_m)[1]
    # pallas: the CUDA fingerprint-filter kernel (kernels/fingerprint_filter)
    return fingerprint_filter(tables, rid, idx, clo_m, out=out)[1]


# ---------------------------------------------------------------- pipeline --
class Divisors(NamedTuple):
    """The float32 divisors the stages divide by every tick, as 0-d tensors
    on the run's device, made once a run.  Dividing by a tensor is true
    division; torch's CUDA division by a Python number multiplies by its
    rounded reciprocal, which moved ~7 latency bins in a million against
    the CPU and the reference (ROADMAP C9)."""
    hist_lo: torch.Tensor     # the latency histogram's lowest edge (µs)
    log_growth: torch.Tensor  # log of its bin growth factor
    slots: torch.Tensor       # max(B−1, 1): the batch server's coupling


def divisors(cfg: FleetConfig, device) -> Divisors:
    """:class:`Divisors` for ``cfg`` on ``device``."""
    def f32(x):
        return torch.tensor(x, dtype=_F32, device=device)

    return Divisors(hist_lo=f32(cfg.hist_lo_us),
                    log_growth=f32(float(np.log(cfg.hist_growth))),
                    slots=f32(float(max(cfg.n_slots - 1, 1))))


def const_latency(cfg: FleetConfig, params) -> torch.Tensor:
    """In-network constants added to every recorded latency, ``(G,)``:
    client TX + four link hops + two pipeline passes + the spine round trip
    when the fabric has one; client-duplicating policies pay the doubled
    TX.  With the coordinator stage on, coordinator policies also detour
    switch → coordinator → switch: one extra link hop each way plus the
    request-processing CPU pass (the dispatch and response CPU passes are
    charged inside the stages, where their serialization is visible)."""
    const_lat = (cfg.client_tx_us + 4 * cfg.link_us
                 + 2 * cfg.pipeline_pass_us + cfg.spine_extra_us
                 + torch.where(id_mask(params.policy_id,
                                       registry.client_dup_ids()),
                               cfg.client_tx_us, 0.0).to(_F32))
    if cfg.coordinator:
        const_lat = const_lat + torch.where(
            id_mask(params.policy_id, registry.coordinator_ids()),
            2.0 * cfg.link_us + cfg.coord_cpu_us, 0.0).to(_F32)
    return const_lat


def build_step(cfg: FleetConfig, params, group_pairs: torch.Tensor):
    """Compose the stages into the tick function the engine loops over.
    ``params`` is a ``RunParams`` of ``(G, ...)`` tensors on the run's
    device; ``group_pairs`` the GrpT tensor (int64) there."""
    const_lat = const_latency(cfg, params)
    div = divisors(cfg, params.policy_id.device)
    xhop = _f32(cfg.interrack_extra_us)
    recover_ticks = frozenset(params.fail_until_tick.tolist())
    ids = _present(params)
    # the kernel backends write every tick's drop flags into one buffer,
    # allocated here so a captured chunk (fused.py) never allocates it
    drop_out = None
    if cfg.filter_backend in ("pallas", "tickfuse"):
        k = min(cfg.max_responses, cfg.n_servers_total * worker_lanes(cfg))
        drop_out = torch.empty((params.policy_id.shape[0], k),
                               dtype=torch.bool,
                               device=params.policy_id.device)

    def step(state: FleetState, xs):
        state, arr = stage_arrival(cfg, params, state, xs, recover_ticks)
        state, arr, routed, lanes = stage_route(cfg, params, state, arr,
                                                group_pairs, xhop, ids)
        state, lanes = stage_coordinator(cfg, params, state, arr, routed,
                                         lanes, ids)
        state, lanes = stage_hedge_timer(cfg, params, state, arr, routed,
                                         lanes, ids)
        # link failures: copies onto a dead link vanish before the servers,
        # responses from partitioned servers vanish before the filter
        # switch; inert windows leave every value unchanged
        state, lanes = stage_link_failure(cfg, params, state, arr, lanes)
        state, resp = stage_server(cfg, params, state, arr, lanes, div)
        state, resp = stage_link_response(cfg, params, state, arr, resp)
        state, drop = stage_response_filter(cfg, params, state, arr, resp,
                                            drop_out)
        state = stage_client(cfg, params, state, arr, resp, drop, const_lat,
                             div)
        if cfg.telemetry:
            state = state._replace(series=series_tick(
                cfg, state.series, state.metrics, state.queues.count,
                arr.tick))
        return state

    return step
