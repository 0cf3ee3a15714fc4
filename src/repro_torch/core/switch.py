"""The NetClone switch data plane: the batched tensor form the engines use,
and the exact scalar form the discrete-event simulator drives.

:class:`NetCloneSwitch` (with :class:`SwitchCosts`) is the port's copy of
``repro.core.switch``: Algorithm 1 line by line on one packet at a time,
over the numpy tables of :mod:`repro_torch.core.tables`.  It lives in this
module so ``from repro_torch.core.switch import NetCloneSwitch`` mirrors the
reference's import.

The rest of the module is the batched tensor form of the data plane.

Port of ``repro.core.switch_jax`` with the config axis written out: every
state tensor and every lane tensor carries a leading ``G`` axis, and a
single switch is ``G = 1``.  One dispatch tick makes the cloning decisions
for a whole batch of requests; one filter tick runs a whole batch of
responses against StateT and the fingerprint tables.

Unlike the reference's pure functions, the filter ticks update the state's
tensors **in place** (and return the state), which spares a table copy per
tick; callers that need the old state clone it first.

The response filter has three forms:

* :func:`filter_tick` — lane-sequential, exact switch semantics (the plain
  lane loop of :mod:`repro_torch.kernels.ref`);
* :func:`filter_tick_vectorized` — one scatter per tick, with the
  reference's one documented divergence (a different-id slot collision
  inside one tick drops a response the sequential filter forwards);
* the CUDA kernels of :mod:`repro_torch.kernels`, sequential like
  :func:`filter_tick`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.core.header import CLO_CLONE, CLO_NONE, CLO_ORIG, Request, \
    Response
from repro_torch.core.tables import FilterTables, GroupTable, StateTable
from repro_torch.kernels.ref import fingerprint_filter_ref, fingerprint_slot
from repro_torch.scatter import scatter_last


def fingerprint_hash(req_id: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Slot of each request id (``switch_jax.fingerprint_hash_jax``), int32."""
    return fingerprint_slot(req_id, n_slots).to(torch.int32)


class SwitchState(NamedTuple):
    """All switch soft state of ``G`` switches (wiped on failure, §3.6)."""

    seq: torch.Tensor            # (G,) int32 — REQ_ID sequence
    server_state: torch.Tensor   # (G, n_servers) int32 — queue lengths
    filter_tables: torch.Tensor  # (G, n_tables, n_slots) int32


def init_switch_state(g: int, n_servers: int, n_tables: int = 2,
                      n_slots: int = 2 ** 12, device=None) -> SwitchState:
    i32 = dict(dtype=torch.int32, device=device)
    return SwitchState(
        seq=torch.zeros((g,), **i32),
        server_state=torch.zeros((g, n_servers), **i32),
        filter_tables=torch.zeros((g, n_tables, n_slots), **i32))


def group_pairs_array(n_servers: int, device=None) -> torch.Tensor:
    """GrpT as a tensor: ``(2·C(n,2), 2)`` int32, the reference's order."""
    return torch.as_tensor(GroupTable(n_servers).pairs, device=device)


class DispatchResult(NamedTuple):
    req_id: torch.Tensor   # (G, B) int32
    dst1: torch.Tensor     # (G, B) — always receives the CLO∈{0,1} copy
    dst2: torch.Tensor     # (G, B) — receives the CLO=2 clone when cloned
    cloned: torch.Tensor   # (G, B) bool


def dispatch_tick(state: SwitchState, group_pairs: torch.Tensor,
                  grp: torch.Tensor) -> tuple[SwitchState, DispatchResult]:
    """Request path (Alg. 1 lines 1-13) for ``(G, B)`` group draws.  Every
    lane reads StateT as of the start of the tick (requests never write
    it)."""
    b = grp.shape[1]
    req_id = (state.seq[:, None] + 1
              + torch.arange(b, dtype=torch.int32, device=grp.device))
    pair = group_pairs.long()[grp.long()]                  # (G, B, 2)
    s1, s2 = pair[..., 0], pair[..., 1]
    idle1 = torch.gather(state.server_state, 1, s1) == 0   # StateT read
    idle2 = torch.gather(state.server_state, 1, s2) == 0   # ShadowT read
    new_state = state._replace(seq=state.seq + b)
    return new_state, DispatchResult(req_id=req_id.to(torch.int32),
                                     dst1=s1, dst2=s2, cloned=idle1 & idle2)


class FilterResult(NamedTuple):
    drop: torch.Tensor  # (G, B) bool — redundant slower responses


def filter_tick(state: SwitchState, req_id, idx, clo, sid,
                qlen) -> tuple[SwitchState, FilterResult]:
    """Response path (Alg. 1 lines 14-26), lanes in order: StateT takes the
    last lane's queue length per server, then the filter walks the lanes.
    Updates ``state`` in place."""
    i32 = torch.int32
    scatter_last(state.server_state, sid, qlen.to(i32),
                 torch.ones(sid.shape, dtype=torch.bool, device=sid.device))
    _, drop = fingerprint_filter_ref(state.filter_tables, req_id.to(i32),
                                     idx.to(i32), clo.to(i32))
    return state, FilterResult(drop=drop)


def filter_tick_vectorized(state: SwitchState, req_id, idx, clo, sid, qlen,
                           active=None) -> tuple[SwitchState, FilterResult]:
    """One-scatter form of :func:`filter_tick` (``switch_jax.
    filter_tick_vectorized``): lanes sharing one ``(req_id, idx)`` key
    alternate hit/insert against the slot as the sequential filter does,
    resolved with ``O(B²)`` lane comparisons.  A different-id slot
    collision inside one tick drops the response where the sequential
    filter would forward it — the reference's documented divergence, kept.
    ``active`` masks padding lanes.  Updates ``state`` in place."""
    if active is None:
        active = torch.ones(req_id.shape, dtype=torch.bool,
                            device=req_id.device)
    req_id = req_id.to(torch.int32)
    idx = idx.to(torch.int64)
    g, n_tables, n_slots = state.filter_tables.shape

    # lines 15-16: last write wins per server, in lane order
    scatter_last(state.server_state, sid, qlen.to(torch.int32), active)

    part = active & (clo > 0)                     # lanes touching FilterT
    slot = fingerprint_slot(req_id, n_slots)
    flat = state.filter_tables.view(g, n_tables * n_slots)
    pos = idx.clamp(0, n_tables - 1) * n_slots + slot
    parked = torch.gather(flat, 1, pos) == req_id
    lane = torch.arange(req_id.shape[1], device=req_id.device)
    same = (part[:, :, None] & part[:, None, :]
            & (req_id[:, :, None] == req_id[:, None, :])
            & (idx[:, :, None] == idx[:, None, :]))
    k = (same & (lane[None, :] < lane[:, None])).sum(dim=2)   # group pos
    n = same.sum(dim=2)                                        # group size
    # a key group alternates hit/insert from the parked state: even
    # positions drop iff parked, odd iff not
    drop = part & torch.where(k % 2 == 0, parked, ~parked)
    parked_final = torch.where(n % 2 == 0, parked, ~parked)
    value = torch.where(parked_final, req_id, torch.zeros_like(req_id))
    in_range = (idx >= 0) & (idx < n_tables)
    scatter_last(flat, idx * n_slots + slot, value, part & in_range)
    return state, FilterResult(drop=drop)


def wipe(state: SwitchState) -> SwitchState:
    """Switch failure: lose all soft state (§3.6)."""
    return SwitchState(seq=torch.zeros_like(state.seq),
                       server_state=torch.zeros_like(state.server_state),
                       filter_tables=torch.zeros_like(state.filter_tables))


# ------------------------------------------------------ exact scalar form --
@dataclass(slots=True)
class SwitchCosts:
    """Per-pass latency model of the pipeline (µs).  A Tofino pass is a few
    hundred ns; a recirculated clone pays one extra pass (§3.4)."""

    pipeline_pass: float = 0.4
    recirculation: float = 0.4


class NetCloneSwitch:
    """Switch state + Algorithm 1, one packet at a time.

    ``process_request``/``process_response`` return *decisions* (where
    copies go, whether a response is dropped); the caller applies transport
    costs."""

    def __init__(
        self,
        n_servers: int,
        n_filter_tables: int = 2,
        n_filter_slots: int = 2 ** 17,
        costs: SwitchCosts | None = None,
        cloning_enabled: bool = True,
        filtering_enabled: bool = True,
    ):
        self.grp_table = GroupTable(n_servers)
        self.state_table = StateTable(n_servers)
        self.filter_tables = FilterTables(n_filter_tables, n_filter_slots)
        self.costs = costs or SwitchCosts()
        self.cloning_enabled = cloning_enabled
        self.filtering_enabled = filtering_enabled
        self.seq = 0  # global REQ_ID sequence (Alg. 1 line 2); 0 reserved
        # observability
        self.n_cloned = 0
        self.n_requests = 0

    # -- request path (Alg. 1 lines 1-13) --------------------------------
    def process_request(self, req: Request) -> list[tuple[Request, float]]:
        """Returns [(packet, switch_delay_µs), ...], one entry per emitted
        copy.  The clone pays the recirculation pass on top of the normal
        pipeline pass."""
        self.n_requests += 1
        self.seq += 1
        req.req_id = self.seq
        s1, s2 = self.grp_table.lookup(req.grp)
        req.dst = s1  # AddrT[Srv1] (line 5)
        base = self.costs.pipeline_pass
        if self.cloning_enabled and self.state_table.is_idle_pair(s1, s2):
            req.clo = CLO_ORIG  # line 7
            clone = Request(
                req_id=req.req_id,
                grp=req.grp,
                clo=CLO_CLONE,  # line 12 (set on recirculation)
                idx=req.idx,
                dst=s2,         # AddrT[pkt.sid] (line 13)
                t_arrival=req.t_arrival,
                service=req.service,
                client_id=req.client_id,
                key=req.key,
                op=req.op,
            )
            self.n_cloned += 1
            return [(req, base), (clone, base + self.costs.recirculation)]
        req.clo = CLO_NONE
        return [(req, base)]

    # -- response path (Alg. 1 lines 14-26) ------------------------------
    def process_response(self, resp: Response) -> tuple[bool, float]:
        """Returns (drop, switch_delay_µs)."""
        # lines 15-16: always refresh both state copies
        self.state_table.update(resp.sid, resp.state)
        drop = False
        if resp.clo != CLO_NONE and self.filtering_enabled:
            drop = self.filter_tables.process(resp.req_id, resp.idx)
        return drop, self.costs.pipeline_pass

    # -- failure handling (§3.6) -----------------------------------------
    def fail(self) -> None:
        """Switch failure: all soft state is lost; REQ_ID restarts from 0."""
        self.state_table.wipe()
        self.filter_tables.wipe()
        self.seq = 0

    def remove_server(self, sid: int) -> None:
        """Control-plane reaction to a server failure."""
        self.grp_table.remove_server(sid)
