"""Array-form routing policies for one tick of arrival lanes.

Port of ``repro.fleetsim.policies``.  Each branch answers, for ``(G, A)``
arrival lanes at once, where the copies go and with what CLO marking.  The
branches are **attached to the unified policy registry**
(``repro_torch.scenarios.registry``) against the entries
``repro_torch.core.policies`` registered, and the branch tables of
:func:`route` / :func:`route_fabric` and the optional stages' hooks are
read from the registry — so a policy registered once (even from an example
script) runs here with no engine edit.  The reference multiplexes the
branches with ``lax.switch`` on a traced policy id, which under ``vmap``
computes every branch and selects per sweep row; the port does that
directly, computing the branches of the policies present in the batch and
selecting each config's with ``torch.where``.
"""

from __future__ import annotations

import functools

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


def _route_laedge(server_state, pair, r1, r2):
    # LÆDGE never dispatches at the switch: the engine parks these lanes at
    # the coordinator node (stage_coordinator) and this branch only fills
    # the table.  Copies are CLO_ORIG: ordinary at the servers (no CLO=2
    # drop), paired at the filter so the slower response is absorbed
    # exactly where the DES coordinator's seen-set absorbs it.
    clo = torch.full_like(r1, CLO_ORIG, dtype=_I32)
    return r1, r2, torch.zeros_like(r1, dtype=torch.bool), clo, clo


def _route_hedge(server_state, pair, r1, r2):
    # delayed hedging: the original goes to Srv1 of the GrpT pair NOW with
    # CLO_ORIG (its response must park a fingerprint — that is both the
    # filter pairing and the timer-cancel signal); the duplicate is armed
    # into the timer wheel (stage_hedge_timer), not dispatched here
    s1 = pair[..., 0]
    clo1 = torch.full_like(s1, CLO_ORIG, dtype=_I32)
    clo2 = torch.full_like(s1, CLO_CLONE, dtype=_I32)  # clone lane inactive
    return s1, pair[..., 1], torch.zeros_like(s1, dtype=torch.bool), clo1, \
        clo2


def _nth_idle(idle, n):
    """Fabric-global id of the ``n``-th idle server of each config (rank
    matching): ``idle`` ``(G, N)`` bool, ``n`` ``(G,)``.  A config with no
    ``n``-th idle server gets 0, as ``argmax`` over all-False gives (the
    first maximal index)."""
    m = idle.to(torch.int64)
    ranks = torch.cumsum(m, dim=1) - m
    return torch.argmax((idle & (ranks == n[:, None])).to(_I32), dim=1)


def _laedge_ranks(n_idle, u1, u2):
    """LÆDGE's choice as ranks among the idle servers: ``(i1, i2,
    clone)`` for ``n_idle`` idle servers and the pop's two uniforms
    (elementwise over any broadcast shape, float32 products as in the
    reference)."""
    n1 = torch.clamp(n_idle, min=1)
    i1 = torch.minimum((u1 * n1).to(torch.int64), n1 - 1)
    off = (u2 * torch.clamp(n_idle - 1, min=1)).to(torch.int64)
    i2 = torch.where(n_idle > 1,
                     (i1 + 1 + torch.minimum(off, n_idle - 2)) % n1, i1)
    return i1, i2, n_idle >= 2


def laedge_coordinator(idle, n_idle, u1, u2):
    """LÆDGE's dispatch rule, per drained coordinator-queue entry: two
    *distinct random* idle servers when ≥ 2 are idle (clone), the single
    idle one when exactly one is — mirroring the DES coordinator's
    ``rng.choice`` over its idle set.  With 0 idle the engine keeps the
    entry queued, so the returned ids are inert.  ``idle`` ``(G, N)``,
    the rest ``(G,)``."""
    i1, i2, clone = _laedge_ranks(n_idle, u1, u2)
    return _nth_idle(idle, i1), _nth_idle(idle, i2), clone


# a coordinator hook whose servers are ``_nth_idle`` of ranks that depend
# on the idle count alone names that rank rule here: the engine then
# tabulates it over every idle count once a tick instead of calling the
# hook for each pop (stages.stage_coordinator)
laedge_coordinator.ranks = _laedge_ranks


def hedge_deferred_dst(pair, r1, r2):
    """The hedge duplicate races Srv2 of the same GrpT pair the original
    went to — identical to the DES ``HedgePolicy`` pairing."""
    return pair[..., 1]


# attach the array branches to the registry entries core.policies created —
# a policy now lives in ONE table shared by both engines.  laedge and
# hedge additionally attach their pipeline-stage hooks: that single line is
# their whole FleetSim integration.
registry.attach_route("baseline", _route_baseline)
registry.attach_route("c-clone", _route_cclone)
registry.attach_route("netclone", _route_netclone)
registry.attach_route("racksched", _route_racksched)
registry.attach_route("netclone+racksched", _route_ncrs)
registry.attach_route("laedge", _route_laedge, coordinator=laedge_coordinator)
registry.attach_route("hedge", _route_hedge, hedge_timer=hedge_deferred_dst)


def id_mask(policy_id: torch.Tensor, ids) -> torch.Tensor:
    """Per-config membership of ``policy_id`` ``(G,)`` in a static id
    tuple."""
    out = torch.zeros_like(policy_id, dtype=torch.bool)
    for i in ids:
        out = out | (policy_id == i)
    return out


def select_branches(policy_id, branches, ids, args, default=None):
    """Each config's branch: ``branches[pid](*args)`` for the ids in
    ``ids`` (the policies present in the batch), selected per config with
    ``torch.where`` on ``policy_id`` ``(G,)`` (outputs lead with ``G``).
    ``default`` (an output tuple, or one tensor) fills configs whose id is
    not in ``ids``; without it the first branch does."""
    out = default
    for pid in ids:
        res = branches[pid](*args)
        if out is None:
            out = res
            continue
        single = isinstance(res, torch.Tensor)
        res_t = (res,) if single else res
        out_t = (out,) if single else out
        sel = policy_id == pid
        res_t = tuple(torch.where(sel.reshape(sel.shape + (1,) * (b.dim() - 1)),
                                  b, a) for a, b in zip(out_t, res_t))
        out = res_t[0] if single else res_t
    return out


def route(policy_id, server_state, pair, r1, r2, ids=None):
    """Route ``(G, A)`` arrival lanes, each config under its own policy id.

    ``server_state`` is ``(G, n)``; ``pair`` ``(G, A, 2)`` is the GrpT
    lookup; ``r1`` / ``r2`` are distinct uniform candidates.  The branch
    table comes from the registry; the branches of ``ids`` (default: every
    array policy) are computed and each config takes its own.  Returns
    ``(dst1, dst2, cloned, clo1, clo2)``, each ``(G, A)``."""
    branches = registry.route_branches()
    if ids is None:
        ids = range(len(branches))
    return select_branches(policy_id, branches, ids,
                           (server_state, pair, r1, r2))


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


def _spine_remote(policy_id, ids, args, n_racks, n_servers):
    """Each config's spine placement: the registry's hook of its policy,
    or :func:`default_spine_place`; each distinct hook of the policies in
    ``ids`` is computed once."""
    hooks = registry.spine_placements()
    by_hook: dict = {}
    for pid in ids:
        by_hook.setdefault(hooks[pid] or default_spine_place, []).append(pid)
    out = None
    for hook, pids in by_hook.items():
        res = functools.partial(hook, n_racks=n_racks,
                                n_servers=n_servers)(*args)
        out = res if out is None else torch.where(
            id_mask(policy_id, pids)[:, None], res, out)
    return out


def route_fabric(policy_id, server_state, pair, r1, r2, home_rack,
                 remote_cand, *, n_racks: int, n_servers: int, dead=None,
                 ids=None):
    """Fabric routing: each lane's home-rack switch decision
    (:func:`route`) plus, with more than one rack, the spine's inter-rack
    upgrade of saturated ``spine_clone`` lanes, placed by each policy's
    registered spine hook (see the reference's docstring).  ``dead``
    ``(G, n_racks·n_servers)`` marks dead links; an all-false mask changes
    nothing.  ``ids``: the policy ids present in the batch (default:
    every array policy)."""
    if ids is None:
        ids = range(len(registry.array_policies()))
    dst1, dst2, cloned, clo1, clo2 = route(policy_id, server_state, pair,
                                           r1, r2, ids)
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
    remote = _spine_remote(policy_id, ids, (rack_load, server_state,
                                            home_rack, r1, r2, remote_cand),
                           n_racks, n_servers)
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
