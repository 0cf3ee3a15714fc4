"""Device-resident fleet state: the whole 2-tier fabric as tensors.

Port of ``repro.fleetsim.state`` with the config axis written out: every
tensor carries a leading ``G`` axis (one configuration per row; a single run
is ``G = 1``).  The layouts behind it are the reference's:

* each server's FCFS queue is a **ring buffer**: ``head`` / ``count`` per
  server plus one stacked ``(G, R, S, Q, QF)`` payload tensor;
* worker metadata is one ``(G, R, S, W, WF)`` tensor; a worker is busy iff
  its ``WF_REM`` field is positive;
* integer payload fields (req ids, CLO, …) ride in the float32 payloads;
  ``FleetConfig`` bounds req ids below 2²⁴ so the round trip is exact;
* under ``server_model="batch"`` the worker rows are the decode slots
  (``n_slots`` of them, the same ``WF`` layout);
* the optional stages' sub-states (:class:`CoordState`,
  :class:`HedgeWheel`) and telemetry's (:class:`~repro_torch.fleetsim.
  telemetry.device.TraceBuffer`, ``SeriesState``) are ``None`` unless
  their ``FleetConfig`` flag is on.

:func:`state_from_numpy` and :func:`to_numpy` carry a reference
``FleetState`` (numpy arrays, e.g. from ``jax.device_get``) across and
back, so both engines can start from one mid-run state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.fleetsim.config import FleetConfig
from repro_torch.fleetsim.telemetry.device import (
    SeriesState,
    TraceBuffer,
    init_series_state,
    init_trace_buffer,
)

# queue payload fields, (G, R, S, Q, QF) — float32, ints exact below 2^24
QF_BASE = 0     # intrinsic service demand (µs)
QF_TARR = 1     # switch-arrival time (µs)
QF_RID = 2      # REQ_ID
QF_CLO = 3      # CLO marking
QF_IDX = 4      # filter-table index (within one switch's table group)
QF_CLIENT = 5   # client id
QF_HOP = 6      # extra per-copy hop latency (µs; inter-rack clone detour)
QF_FRACK = 7    # filter location: home rack id, or n_racks for the spine
QF = 8

# worker payload fields, (G, R, S, W, WF); busy iff REM > 0
WF_REM = 0      # remaining execution time (µs); 0 ⇔ idle
WF_TARR = 1
WF_RID = 2
WF_CLO = 3
WF_IDX = 4
WF_CLIENT = 5
WF_HOP = 6
WF_FRACK = 7
WF = 8

WHEEL_RID = 0    # timer-wheel entry fields, (G, n_slots, width, WH) — float32
WHEEL_DST = 1    # deferred duplicate's destination (fabric-global)
WHEEL_IDX = 2    # filter-table index
WHEEL_CLIENT = 3
WHEEL_BASE = 4   # intrinsic demand shared with the original
WHEEL_TARR = 5   # the ORIGINAL arrival time — the hedge pays the delay
WHEEL_FRACK = 6  # filter location (home rack)
WH = 7


class FabricSwitch(NamedTuple):
    """All switch soft state of the fabric (wiped on failure, §3.6): the
    spine's REQ_ID sequence, every rack's StateT, and the filter table
    groups of every rack plus the spine's (group ``n_racks``)."""

    seq: torch.Tensor            # (G,) int32
    server_state: torch.Tensor   # (G, n_racks, S) int32
    filter_tables: torch.Tensor  # (G, n_racks + 1, n_tables, n_slots) int32


class RingQueues(NamedTuple):
    """Per-server FCFS ring buffers, rack-major."""

    head: torch.Tensor     # (G, n_racks, S) int32 — oldest occupied slot
    count: torch.Tensor    # (G, n_racks, S) int32 — waiting requests
    data: torch.Tensor     # (G, n_racks, S, Q, QF) float32 payload


class Workers(NamedTuple):
    # (G, n_racks, S, W, WF) float32; busy ⇔ REM > 0.  W is
    # worker_lanes(cfg): the decode slots under the batch server
    meta: torch.Tensor


class CoordState(NamedTuple):
    """Array-form coordinator node (LÆDGE, §2.2): a CPU queue hanging off
    the top switch.  Pending requests wait in a ring of ``QF``-format rows;
    each tick the drain pops up to ``FleetConfig.drain_per_tick`` of them
    onto servers chosen by the policy's registered ``coordinator`` rule,
    spending one CPU *credit* per transmitted copy (credits accrue at
    ``dt / coord_cpu_us`` a tick and go negative when responses flood the
    CPU).  ``outstanding`` is the coordinator's own dispatched-minus-
    responded view per server (idle ⇔ outstanding < n_workers)."""

    outstanding: torch.Tensor  # (G, n_racks · S) int32
    head: torch.Tensor         # (G,) int32 — oldest occupied ring slot
    count: torch.Tensor        # (G,) int32 — pending requests
    data: torch.Tensor         # (G, coordinator_cap, QF) float32 rows
    credit: torch.Tensor       # (G,) float32 — CPU packet budget


class HedgeWheel(NamedTuple):
    """Fixed-depth timer wheel firing delayed hedge duplicates: an entry
    armed at tick ``t`` lands in slot ``(t + delay) % n_slots`` and fires
    ``delay`` ticks later (the wheel is deeper than the delay horizon).
    Per-slot occupancy beyond ``wheel_width`` drops the latest lanes
    (counted in ``Metrics.n_wheel_dropped``)."""

    count: torch.Tensor    # (G, n_slots) int32 — armed entries per slot
    data: torch.Tensor     # (G, n_slots, width, WH) float32 entries


class Metrics(NamedTuple):
    """Running counters (``(G,)`` int32 each) and the per-rack log-spaced
    latency histograms — the reference's fields, in its order."""

    hist: torch.Tensor            # (G, n_racks, hist_bins) — by serving rack
    n_arrivals: torch.Tensor      # requests admitted at the fabric
    n_truncated: torch.Tensor     # Poisson arrivals clipped by lane headroom
    n_dropped_down: torch.Tensor  # arrivals lost while the fabric was dark
    n_cloned: torch.Tensor
    n_interrack_cloned: torch.Tensor  # … of which the clone crossed racks
    n_clone_drops: torch.Tensor   # server-side CLO=2 stale-state drops
    n_filtered: torch.Tensor      # redundant responses dropped at a switch
    n_spine_filtered: torch.Tensor  # … of which at the spine
    n_redundant: torch.Tensor     # redundant responses absorbed at clients
    n_overflow: torch.Tensor      # queue-slot exhaustion drops
    n_dedup_evicted: torch.Tensor  # live client fingerprints lost
    n_resp_clipped: torch.Tensor  # completions beyond the response lanes
    n_completed: torch.Tensor     # first responses delivered (whole run)
    n_completed_win: torch.Tensor  # … inside the measurement window
    n_resp: torch.Tensor          # all server completions
    n_resp_empty: torch.Tensor    # … that piggybacked qlen == 0
    lost_down_resp: torch.Tensor  # responses lost while the fabric was dark
    n_coord_queued: torch.Tensor  # requests parked at the coordinator
    n_coord_overflow: torch.Tensor  # … lost to coordinator-ring exhaustion
    n_hedges_armed: torch.Tensor  # timer-wheel entries armed
    n_hedges_cancelled: torch.Tensor  # … cancelled (response / fabric dark)
    n_wheel_dropped: torch.Tensor  # … lost to wheel-slot exhaustion
    n_slot_busy: torch.Tensor     # Σ busy decode slots over ticks (batch)
    n_link_dropped_req: torch.Tensor   # copies lost on a dead link
    n_link_dropped_resp: torch.Tensor  # responses lost on a dead link


class FleetState(NamedTuple):
    switch: FabricSwitch
    dedup: torch.Tensor           # (G, n_dedup_slots) int32 fingerprints
    queues: RingQueues
    workers: Workers
    client_backlog: torch.Tensor  # (G, C) float32 receiver backlog (µs)
    key: torch.Tensor             # (G, 2) int64 — PRNG carry (uint32 words)
    metrics: Metrics
    # optional stage sub-states: None unless the matching FleetConfig flag
    # turned the stage on (telemetry's are pure observers, never fed back)
    coord: CoordState | None = None
    wheel: HedgeWheel | None = None
    trace: TraceBuffer | None = None
    series: SeriesState | None = None


def worker_lanes(cfg: FleetConfig) -> int:
    """Worker rows per server: the decode slots under
    ``server_model="batch"``, else the FCFS workers."""
    return cfg.n_slots if cfg.server_model == "batch" else cfg.n_workers


def init_metrics(cfg: FleetConfig, g: int, device=None) -> Metrics:
    def z():
        return torch.zeros((g,), dtype=torch.int32, device=device)

    hist = torch.zeros((g, cfg.n_racks, cfg.hist_bins), dtype=torch.int32,
                       device=device)
    return Metrics(hist, *(z() for _ in Metrics._fields[1:]))


def init_coord_state(cfg: FleetConfig, g: int, device=None) -> CoordState:
    return CoordState(
        outstanding=torch.zeros((g, cfg.n_servers_total), dtype=torch.int32,
                                device=device),
        head=torch.zeros((g,), dtype=torch.int32, device=device),
        count=torch.zeros((g,), dtype=torch.int32, device=device),
        data=torch.zeros((g, cfg.coordinator_cap, QF), dtype=torch.float32,
                         device=device),
        credit=torch.zeros((g,), dtype=torch.float32, device=device))


def init_hedge_wheel(cfg: FleetConfig, g: int, device=None) -> HedgeWheel:
    return HedgeWheel(
        count=torch.zeros((g, cfg.wheel_slots), dtype=torch.int32,
                          device=device),
        data=torch.zeros((g, cfg.wheel_slots, cfg.wheel_width, WH),
                         dtype=torch.float32, device=device))


def init_fleet_state(cfg: FleetConfig, key: torch.Tensor) -> FleetState:
    """Empty fabric for ``G = key.shape[0]`` configurations, on ``key``'s
    device."""
    g, dev = key.shape[0], key.device
    r, s, q, w = cfg.n_racks, cfg.n_servers, cfg.queue_cap, worker_lanes(cfg)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return FleetState(
        switch=FabricSwitch(
            seq=torch.zeros((g,), **i32),
            server_state=torch.zeros((g, r, s), **i32),
            filter_tables=torch.zeros(
                (g, r + 1, cfg.n_filter_tables, cfg.n_filter_slots), **i32)),
        dedup=torch.zeros((g, cfg.n_dedup_slots), **i32),
        queues=RingQueues(head=torch.zeros((g, r, s), **i32),
                          count=torch.zeros((g, r, s), **i32),
                          data=torch.zeros((g, r, s, q, QF), **f32)),
        workers=Workers(meta=torch.zeros((g, r, s, w, WF), **f32)),
        client_backlog=torch.zeros((g, cfg.n_clients), **f32),
        key=key.to(torch.int64),
        metrics=init_metrics(cfg, g, dev),
        coord=init_coord_state(cfg, g, dev) if cfg.coordinator else None,
        wheel=init_hedge_wheel(cfg, g, dev) if cfg.hedge_timer else None,
        trace=init_trace_buffer(cfg, g, dev) if cfg.telemetry else None,
        series=init_series_state(cfg, g, dev) if cfg.telemetry else None,
    )


# ----------------------------------------------------- carrying state across
def _tensor(a, lead: bool, device) -> torch.Tensor:
    a = np.array(a, order="C")        # a writable copy, 0-d stays 0-d
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    t = torch.from_numpy(a).to(device)
    return t[None] if lead else t


def state_from_numpy(cfg: FleetConfig, tree, *, device=None) -> FleetState:
    """Port tensors from a reference ``FleetState`` whose leaves are numpy
    arrays.  A single run's state (no sweep axis) becomes ``G = 1``; a
    batched state keeps its leading axis.  The optional sub-states (the
    coordinator's, the hedge wheel's, telemetry's) come across when
    present."""
    if (tree.coord is not None) != cfg.coordinator or \
            (tree.wheel is not None) != cfg.hedge_timer or \
            (tree.trace is not None) != cfg.telemetry:
        raise ValueError("the state's optional sub-states do not match "
                         "cfg.coordinator / cfg.hedge_timer / cfg.telemetry")
    lead = np.ndim(tree.switch.seq) == 0

    def conv(a):
        return _tensor(a, lead, device)

    state = FleetState(
        switch=FabricSwitch(*map(conv, tree.switch)),
        dedup=conv(tree.dedup),
        queues=RingQueues(*map(conv, tree.queues)),
        workers=Workers(*map(conv, tree.workers)),
        client_backlog=conv(tree.client_backlog),
        key=conv(tree.key),
        metrics=Metrics(*map(conv, tree.metrics)),
        coord=None if tree.coord is None
        else CoordState(*map(conv, tree.coord)),
        wheel=None if tree.wheel is None
        else HedgeWheel(*map(conv, tree.wheel)),
        trace=None if tree.trace is None
        else TraceBuffer(*map(conv, tree.trace)),
        series=None if tree.series is None
        else SeriesState(*map(conv, tree.series)))
    if state.queues.data.shape[1:] != (cfg.n_racks, cfg.n_servers,
                                       cfg.queue_cap, QF):
        raise ValueError("state shapes do not match cfg")
    return state


def to_numpy(tree):
    """The same NamedTuple tree with numpy leaves in the reference's dtypes
    (the PRNG key back to uint32), for comparing with the reference."""
    if isinstance(tree, torch.Tensor):
        a = tree.detach().cpu().numpy()
        return a.astype(np.uint32) if a.dtype == np.int64 else a
    if tree is None:
        return None
    return type(tree)(*(to_numpy(x) for x in tree))
