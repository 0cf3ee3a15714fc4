"""Array-form routing policies for one tick of arrival lanes.

Port of ``repro.fleetsim.policies``.  Each branch answers, for ``(G, A)``
arrival lanes at once, where the copies go and with what CLO marking.  The
reference multiplexes the branches with ``lax.switch`` on a traced policy
id, which under ``vmap`` computes every branch and selects per sweep row;
the port does that directly: :func:`route` computes the five always-on
branches and selects each config's with ``torch.where``.
"""

from __future__ import annotations

import torch

from repro_torch.core.header import CLO_CLONE, CLO_NONE, CLO_ORIG
from repro_torch.kernels.ref import fingerprint_slot
from repro_torch.scatter import scatter_last
from repro_torch.scenarios import registry

_I32 = torch.int32


def _no_clone(dst):
    zero = torch.zeros_like(dst, dtype=_I32)
    return (dst, dst, torch.zeros_like(dst, dtype=torch.bool),
            zero + CLO_NONE, zero + CLO_NONE)


def _route_baseline(server_state, pair, r1, r2):
    # uniform random single copy
    return _no_clone(r1)


def _route_cclone(server_state, pair, r1, r2):
    # two copies to distinct random servers, both ordinary (CLO_NONE)
    clo = torch.full_like(r1, CLO_NONE, dtype=_I32)
    return r1, r2, torch.ones_like(r1, dtype=torch.bool), clo, clo


def _route_netclone(server_state, pair, r1, r2):
    # dispatch_tick's predicate: clone iff the candidate pair is tracked-idle
    s1, s2 = pair[..., 0], pair[..., 1]
    cloned = ((torch.gather(server_state, 1, s1) == 0)      # StateT read
              & (torch.gather(server_state, 1, s2) == 0))   # ShadowT read
    clo1 = torch.where(cloned, CLO_ORIG, CLO_NONE).to(_I32)
    clo2 = torch.full_like(s1, CLO_CLONE, dtype=_I32)
    return s1, s2, cloned, clo1, clo2


def _route_racksched(server_state, pair, r1, r2):
    # power-of-two-choices JSQ on piggybacked queue lengths
    jsq = torch.where(torch.gather(server_state, 1, r1)
                      <= torch.gather(server_state, 1, r2), r1, r2)
    return _no_clone(jsq)


def _route_ncrs(server_state, pair, r1, r2):
    # §3.7 integration: idle-idle pair → clone; otherwise JSQ between the
    # candidates instead of blindly Srv1
    s1, s2 = pair[..., 0], pair[..., 1]
    q1 = torch.gather(server_state, 1, s1)
    q2 = torch.gather(server_state, 1, s2)
    cloned = (q1 == 0) & (q2 == 0)
    dst1 = torch.where(cloned, s1, torch.where(q1 <= q2, s1, s2))
    clo1 = torch.where(cloned, CLO_ORIG, CLO_NONE).to(_I32)
    clo2 = torch.full_like(s1, CLO_CLONE, dtype=_I32)
    return dst1, s2, cloned, clo1, clo2


# the always-on branch table, by registry id (laedge and hedge route
# through the coordinator and hedge-timer stages, not ported yet)
ROUTE_BRANCHES = {
    registry.get("baseline").policy_id: _route_baseline,
    registry.get("c-clone").policy_id: _route_cclone,
    registry.get("netclone").policy_id: _route_netclone,
    registry.get("racksched").policy_id: _route_racksched,
    registry.get("netclone+racksched").policy_id: _route_ncrs,
}


def id_mask(policy_id: torch.Tensor, ids: tuple[int, ...]) -> torch.Tensor:
    """Per-config membership of ``policy_id`` ``(G,)`` in a static id
    tuple."""
    out = torch.zeros_like(policy_id, dtype=torch.bool)
    for i in ids:
        out = out | (policy_id == i)
    return out


def route(policy_id, server_state, pair, r1, r2):
    """Route ``(G, A)`` arrival lanes, each config under its own policy id.

    ``server_state`` is ``(G, n)``; ``pair`` ``(G, A, 2)`` is the GrpT
    lookup; ``r1`` / ``r2`` are distinct uniform candidates.  Every branch
    is computed and each config takes its own.  Returns ``(dst1, dst2,
    cloned, clo1, clo2)``, each ``(G, A)``."""
    out = None
    for pid, branch in ROUTE_BRANCHES.items():
        res = branch(server_state, pair, r1, r2)
        if out is None:
            out = res
            continue
        sel = (policy_id == pid)[:, None]
        out = tuple(torch.where(sel, b, a) for a, b in zip(out, res))
    return out


def default_spine_place(rack_load, server_state, home, r1, r2, remote_cand,
                        *, n_racks, n_servers):
    """Default spine placement (§3.7): the remote member of a cross-rack
    pair is the lane's uniform candidate ``remote_cand`` (rack-local id) in
    the least-loaded rack other than home (first such rack on a tie)."""
    big = 1 << 24
    racks = torch.arange(n_racks, device=home.device)
    masked = rack_load[:, None, :] + torch.where(
        home[:, :, None] == racks, big, 0)                  # (G, A, RK)
    r_star = torch.argmin(masked, dim=2)
    return (r_star * n_servers + remote_cand).to(remote_cand.dtype)


def route_fabric(policy_id, server_state, pair, r1, r2, home_rack,
                 remote_cand, *, n_racks: int, n_servers: int, dead=None):
    """Fabric routing: each lane's home-rack switch decision
    (:func:`route`) plus, with more than one rack, the spine's inter-rack
    upgrade of saturated ``spine_clone`` lanes (see the reference's
    docstring).  ``dead`` ``(G, n_racks·n_servers)`` marks dead links; an
    all-false mask changes nothing."""
    dst1, dst2, cloned, clo1, clo2 = route(policy_id, server_state, pair,
                                           r1, r2)
    if n_racks == 1:
        return dst1, dst2, cloned, clo1, clo2

    g = server_state.shape[0]
    per_rack = server_state.reshape(g, n_racks, n_servers)
    rack_load = per_rack.sum(dim=2, dtype=_I32)     # spine's aggregate view
    rack_min = per_rack.amin(dim=2)
    if dead is not None:
        # a fully partitioned rack reads as saturated to the spine
        rack_load = rack_load + torch.where(
            dead.reshape(g, n_racks, n_servers).all(dim=2), 1 << 24, 0)
    remote = default_spine_place(rack_load, server_state, home_rack, r1, r2,
                                 remote_cand, n_racks=n_racks,
                                 n_servers=n_servers)
    dead_ok = torch.ones_like(cloned)
    if dead is not None:
        dead_ok = ~torch.gather(dead, 1, remote)
    wants_clone = id_mask(policy_id, registry.spine_clone_ids())[:, None]
    xclone = (wants_clone & ~cloned
              & (torch.gather(rack_min, 1, home_rack) > 0)  # home saturated
              & (torch.gather(server_state, 1, remote) == 0)
              & dead_ok)
    dst2 = torch.where(xclone, remote, dst2)
    clo1 = torch.where(xclone, CLO_ORIG, clo1).to(_I32)
    clo2 = torch.where(xclone, CLO_CLONE, clo2).to(_I32)
    return dst1, dst2, cloned | xclone, clo1, clo2


def dedup_tick(table: torch.Tensor, req_id: torch.Tensor,
               active: torch.Tensor):
    """Client-side first-response tracking, fingerprint-table style.

    The first response of a request inserts its id; the second finds it,
    clears the slot and is flagged *redundant*.  Copies landing in one tick
    resolve in lane order (the parked/parity replay of the vectorized
    filter).  ``table`` ``(G, n_slots)`` is updated in place.  Returns
    ``(table, redundant, evicted)``, ``evicted`` ``(G,)`` counting live
    foreign fingerprints overwritten on a slot collision."""
    req_id = req_id.to(_I32)
    n_slots = table.shape[1]
    # same multiplicative hash family as the switch filter
    slot = fingerprint_slot(req_id, n_slots)
    occupant = torch.gather(table, 1, slot)
    parked = occupant == req_id
    lane = torch.arange(req_id.shape[1], device=req_id.device)
    same = (active[:, :, None] & active[:, None, :]
            & (req_id[:, :, None] == req_id[:, None, :]))
    k = (same & (lane[None, :] < lane[:, None])).sum(dim=2)
    n = same.sum(dim=2)
    redundant = active & torch.where(k % 2 == 0, parked, ~parked)
    parked_final = torch.where(n % 2 == 0, parked, ~parked)
    value = torch.where(parked_final, req_id, torch.zeros_like(req_id))
    # a first-of-group insert over a different live id evicts that request
    evicted = (active & (k == 0) & ~parked & (occupant != 0)).sum(
        dim=1, dtype=_I32)
    scatter_last(table, slot, value, active)
    return table, redundant, evicted
