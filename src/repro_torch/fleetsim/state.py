"""Device-resident fleet state: the whole 2-tier fabric as tensors.

Port of ``repro.fleetsim.state`` with the config axis written out: every
tensor carries a leading ``G`` axis (one configuration per row; a single run
is ``G = 1``).  The layouts behind it are the reference's:

* each server's FCFS queue is a **ring buffer**: ``head`` / ``count`` per
  server plus one stacked ``(G, R, S, Q, QF)`` payload tensor;
* worker metadata is one ``(G, R, S, W, WF)`` tensor; a worker is busy iff
  its ``WF_REM`` field is positive;
* integer payload fields (req ids, CLO, …) ride in the float32 payloads;
  ``FleetConfig`` bounds req ids below 2²⁴ so the round trip is exact.

:func:`state_from_numpy` and :func:`to_numpy` carry a reference
``FleetState`` (numpy arrays, e.g. from ``jax.device_get``) across and
back, so both engines can start from one mid-run state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.fleetsim.config import FleetConfig

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
    meta: torch.Tensor     # (G, n_racks, S, W, WF) float32; busy ⇔ REM > 0


class Metrics(NamedTuple):
    """Running counters (``(G,)`` int32 each) and the per-rack log-spaced
    latency histograms — the reference's fields, in its order.  The
    counters of stages the port has not ported yet stay zero."""

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
    n_coord_queued: torch.Tensor  # coordinator stage (not ported yet)
    n_coord_overflow: torch.Tensor
    n_hedges_armed: torch.Tensor  # hedge-timer stage (not ported yet)
    n_hedges_cancelled: torch.Tensor
    n_wheel_dropped: torch.Tensor
    n_slot_busy: torch.Tensor     # batch server stage (not ported yet)
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
    # optional stage sub-states of the reference; always None in the port
    # until those stages are ported (ROADMAP.md A7, A9)
    coord: None = None
    wheel: None = None
    trace: None = None
    series: None = None


def init_metrics(cfg: FleetConfig, g: int, device=None) -> Metrics:
    def z():
        return torch.zeros((g,), dtype=torch.int32, device=device)

    hist = torch.zeros((g, cfg.n_racks, cfg.hist_bins), dtype=torch.int32,
                       device=device)
    return Metrics(hist, *(z() for _ in Metrics._fields[1:]))


def init_fleet_state(cfg: FleetConfig, key: torch.Tensor) -> FleetState:
    """Empty fabric for ``G = key.shape[0]`` configurations, on ``key``'s
    device."""
    g, dev = key.shape[0], key.device
    r, s, q, w = cfg.n_racks, cfg.n_servers, cfg.queue_cap, cfg.n_workers
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
    batched state keeps its leading axis.  The reference's optional
    sub-states must be absent."""
    if any(getattr(tree, f) is not None
           for f in ("coord", "wheel", "trace", "series")):
        raise NotImplementedError(
            "the port has no optional stages yet (ROADMAP.md A7, A9)")
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
        metrics=Metrics(*map(conv, tree.metrics)))
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
