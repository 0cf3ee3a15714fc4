"""Unified policy registry — one registration, every engine, every sweep;
the port's copy of ``repro.scenarios.registry``.

A policy is registered **once** with a name, a stable dense int id (the
array engine's branch index), a DES :class:`SwitchPolicy` factory, and —
attached by ``repro_torch.fleetsim.policies`` — an array-form ``route``
branch plus optional spine-placement and stage hooks.  Everything
downstream derives from this table:

* ``repro_torch.core.policies.make_policy`` builds DES policies from it;
* ``repro_torch.fleetsim.config.POLICY_IDS`` / ``POLICY_NAMES`` are *live
  views* of it, so registering a custom policy (e.g. a spine-placement
  variant) enters it into both engines, every
  :class:`~repro_torch.scenarios.spec.SweepSpec` with
  ``policies="registered"``, and the ``validate`` cross-checks;
* the FleetSim branch tables (``route``, spine placement, client-dup TX,
  the coordinator and hedge-timer hooks) are read from it each time an
  engine builds its tick; :func:`version` counts registrations.

Duplicate names or ids raise :class:`DuplicatePolicyError`.

This module is import-light on purpose (no torch, no engine imports); the
builtin registrations live with their implementations and are pulled in
lazily by the accessors in two tiers — name/id/flag accessors load only
``repro_torch.core.policies`` (numpy-only, so the DES never pays the torch
import), while the route-table accessors additionally load
``repro_torch.fleetsim.policies`` — which keeps ``core`` ↔ ``fleetsim``
free of import cycles.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Any, Callable

__all__ = [
    "DuplicatePolicyError",
    "PolicyDef",
    "register",
    "attach_route",
    "remove",
    "get",
    "route_of",
    "names",
    "array_policies",
    "two_engine_names",
    "policy_id_map",
    "policy_name_map",
    "route_branches",
    "spine_placements",
    "spine_clone_ids",
    "client_dup_ids",
    "coordinator_ids",
    "hedge_timer_ids",
    "coordinator_branches",
    "hedge_timer_branches",
    "needs_coordinator",
    "needs_hedge_timer",
    "version",
]


class DuplicatePolicyError(ValueError):
    """A policy name or id was registered twice."""


@dataclass(frozen=True)
class PolicyDef:
    """One policy, as seen by every engine.

    ``policy_id`` is the dense int the array engine switches on (``None``
    for DES-only policies).  ``des`` builds the DES ``SwitchPolicy``;
    ``route`` is the array-form branch ``(server_state, pair, r1, r2) ->
    (dst1, dst2, cloned, clo1, clo2)``.  ``spine_clone`` marks policies
    whose saturated lanes the spine may upgrade to inter-rack clones
    (§3.7), with ``spine_place(rack_load, server_state, home, r1, r2,
    remote_cand, *, n_racks, n_servers)`` overriding the default
    least-loaded-rack placement.  ``client_dup`` marks client-side
    duplication (the sender pays doubled TX cost, as C-Clone does).

    Two optional *stage hooks* route a policy through FleetSim's staged
    tick pipeline (``repro_torch.fleetsim.stages``) instead of plain immediate
    dispatch:

    * ``coordinator(idle, n_idle, u1, u2) -> (s1, s2, clone)`` — the
      policy's coordinator-node dispatch rule, called per drained queue
      entry (LÆDGE: clone to two random idle servers iff ≥ 2 are idle).
      Arrival lanes of such policies are *queued at the coordinator node*
      and drained by this rule each tick, never dispatched directly.
    * ``hedge_timer(pair, r1, r2) -> deferred_dst`` — the destination of
      a delayed duplicate armed into the engine's timer wheel at arrival
      and fired ``FleetConfig.hedge_delay_us`` later unless the first
      response arrived meanwhile.

    Both hooks are torch callables, so — like ``route`` itself — they are
    attached by ``repro_torch.fleetsim.policies`` via :func:`attach_route`.
    """

    name: str
    policy_id: int | None = None
    des: Callable[..., Any] | None = None
    route: Callable | None = None
    spine_clone: bool = False
    spine_place: Callable | None = None
    client_dup: bool = False
    coordinator: Callable | None = None
    hedge_timer: Callable | None = None
    description: str = ""


_REGISTRY: dict[str, PolicyDef] = {}
_VERSION = 0
# builtin registrations (names, ids, DES factories, flags) — numpy-only
_CORE_MODULE = "repro_torch.core.policies"
# builtin array branches — pulls in torch; only loaded for route accessors
_ROUTE_MODULE = "repro_torch.fleetsim.policies"
_loading = False


def _bump() -> None:
    global _VERSION
    _VERSION += 1


def _import_guarded(mod: str) -> None:
    global _loading
    if _loading:
        return
    _loading = True
    try:
        importlib.import_module(mod)
    finally:
        _loading = False


def _ensure_builtins() -> None:
    """Load the builtin registrations (idempotent; re-entrant imports
    during their own load are no-ops).  Deliberately does NOT import the
    fleetsim branch module, so DES-only consumers stay numpy-only — see
    :func:`_ensure_routes` for the torch tier."""
    _import_guarded(_CORE_MODULE)


def _ensure_routes() -> None:
    """Additionally load the builtin array branches (imports torch)."""
    _ensure_builtins()
    _import_guarded(_ROUTE_MODULE)


def register(
    name: str,
    *,
    policy_id: int | None = None,
    des: Callable[..., Any] | None = None,
    route: Callable | None = None,
    spine_clone: bool = False,
    spine_place: Callable | None = None,
    client_dup: bool = False,
    coordinator: Callable | None = None,
    hedge_timer: Callable | None = None,
    description: str = "",
) -> PolicyDef:
    """Register a policy under a unique name (and unique id, if array-form).

    Raises :class:`DuplicatePolicyError` on name or id collision instead of
    silently overwriting either direction of the map.
    """
    # load the builtin table first so a user registration collides *here*,
    # at its own call site, rather than poisoning the later builtin import.
    # The builtins' own register() calls must skip this: while their module
    # is mid-import it is already in sys.modules, and re-importing it (or
    # the route module, which attaches to entries not yet registered) would
    # re-enter a half-initialized table.
    import sys

    if _CORE_MODULE not in sys.modules:
        _ensure_builtins()
    if name in _REGISTRY:
        raise DuplicatePolicyError(f"policy {name!r} is already registered")
    if policy_id is not None:
        taken = {d.policy_id: d.name for d in _REGISTRY.values()
                 if d.policy_id is not None}
        if policy_id in taken:
            raise DuplicatePolicyError(
                f"policy id {policy_id} is already registered "
                f"to {taken[policy_id]!r}")
        if policy_id < 0:
            raise ValueError("policy_id must be non-negative")
    d = PolicyDef(name=name, policy_id=policy_id, des=des, route=route,
                  spine_clone=spine_clone, spine_place=spine_place,
                  client_dup=client_dup, coordinator=coordinator,
                  hedge_timer=hedge_timer, description=description)
    _REGISTRY[name] = d
    _bump()
    return d


def attach_route(name: str, route: Callable, *,
                 spine_place: Callable | None = None,
                 coordinator: Callable | None = None,
                 hedge_timer: Callable | None = None) -> PolicyDef:
    """Attach (or replace) the array-form branches of an existing policy.

    Used by ``repro_torch.fleetsim.policies`` to add the engine branches (the
    route, and optionally the ``coordinator`` / ``hedge_timer`` stage
    hooks) to policies whose DES side registered first; the policy must
    already carry an id.
    """
    _ensure_builtins()
    d = get(name)
    if d.policy_id is None:
        raise ValueError(f"policy {name!r} has no policy_id; register it "
                         "with one before attaching an array branch")
    d = replace(d, route=route,
                spine_place=spine_place if spine_place is not None
                else d.spine_place,
                coordinator=coordinator if coordinator is not None
                else d.coordinator,
                hedge_timer=hedge_timer if hedge_timer is not None
                else d.hedge_timer)
    _REGISTRY[name] = d
    _bump()
    return d


def remove(name: str) -> None:
    """Unregister a policy (intended for tests and example teardown — the
    builtin table is append-only in normal use).  Refuses to punch a hole
    in the dense id range: remove higher ids first."""
    _ensure_builtins()
    if name not in _REGISTRY:
        raise KeyError(name)
    pid = _REGISTRY[name].policy_id
    if pid is not None:
        higher = [d.name for d in _REGISTRY.values()
                  if d.policy_id is not None and d.policy_id > pid]
        if higher:
            raise ValueError(
                f"removing {name!r} (id {pid}) would leave an id hole "
                f"below {higher} and break the dense branch table; "
                "remove higher ids first")
    del _REGISTRY[name]
    _bump()


def route_of(name: str) -> Callable:
    """The array route branch of a registered policy (loads the torch branch
    tier first, so it is safe in any import order) — for custom
    registrations that reuse a builtin's in-rack behaviour."""
    _ensure_routes()
    r = get(name).route
    if r is None:
        raise ValueError(f"policy {name!r} has no array route branch")
    return r


def get(name: str) -> PolicyDef:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def names() -> list[str]:
    """All registered policy names (registration order)."""
    _ensure_builtins()
    return list(_REGISTRY)


def array_policies() -> list[PolicyDef]:
    """Array-capable policies sorted by id, validated dense ``0..N-1`` (the
    branch table, indexed by id, cannot have holes)."""
    _ensure_builtins()
    defs = sorted((d for d in _REGISTRY.values() if d.policy_id is not None),
                  key=lambda d: d.policy_id)
    ids = [d.policy_id for d in defs]
    if ids != list(range(len(ids))):
        raise ValueError(f"array policy ids must be dense 0..N-1, got {ids}")
    return defs


def two_engine_names() -> list[str]:
    """Policies runnable through *both* engines (a DES factory and an
    array id) — the default sweep population."""
    _ensure_builtins()
    return [d.name for d in array_policies() if d.des is not None]


def policy_id_map() -> dict[str, int]:
    return {d.name: d.policy_id for d in array_policies()}


def policy_name_map() -> dict[int, str]:
    return {d.policy_id: d.name for d in array_policies()}


def route_branches() -> list[Callable]:
    """The route branch table, sorted by id.  Every array policy must
    have a route attached by the time an engine builds its tick."""
    _ensure_routes()
    defs = array_policies()
    missing = [d.name for d in defs if d.route is None]
    if missing:
        raise ValueError(f"array policies without a route branch: {missing}")
    return [d.route for d in defs]


def spine_placements() -> list[Callable | None]:
    """Per-policy spine placement hooks (``None`` → engine default),
    sorted by id."""
    _ensure_routes()
    return [d.spine_place for d in array_policies()]


def spine_clone_ids() -> tuple[int, ...]:
    """Ids whose saturated lanes the spine may upgrade to inter-rack
    clones."""
    return tuple(d.policy_id for d in array_policies() if d.spine_clone)


def client_dup_ids() -> tuple[int, ...]:
    """Ids whose clients transmit both copies themselves (doubled TX)."""
    return tuple(d.policy_id for d in array_policies() if d.client_dup)


def coordinator_ids() -> tuple[int, ...]:
    """Ids whose arrival lanes are queued at the coordinator node and
    dispatched by their registered ``coordinator`` rule (LÆDGE-style)."""
    _ensure_routes()
    return tuple(d.policy_id for d in array_policies()
                 if d.coordinator is not None)


def hedge_timer_ids() -> tuple[int, ...]:
    """Ids that arm a delayed duplicate into the engine's timer wheel."""
    _ensure_routes()
    return tuple(d.policy_id for d in array_policies()
                 if d.hedge_timer is not None)


def coordinator_branches() -> list[Callable]:
    """Per-policy coordinator dispatch rules sorted by id, with a fallback
    no-op branch for policies without one (their lanes never reach the
    coordinator, but the table is dense)."""
    _ensure_routes()
    return [d.coordinator or _coordinator_noop for d in array_policies()]


def hedge_timer_branches() -> list[Callable]:
    """Per-policy deferred-duplicate destinations sorted by id (fallback:
    the lane's second uniform candidate — inert, such lanes never arm)."""
    _ensure_routes()
    return [d.hedge_timer or _hedge_timer_noop for d in array_policies()]


def _coordinator_noop(idle, n_idle, u1, u2):
    zero = n_idle * 0
    return zero, zero, n_idle < 0


def _hedge_timer_noop(pair, r1, r2):
    return r2


def needs_coordinator(name: str) -> bool:
    """Whether running ``name`` through FleetSim needs the coordinator
    stage compiled in (``FleetConfig.coordinator``)."""
    _ensure_routes()
    return get(name).coordinator is not None


def needs_hedge_timer(name: str) -> bool:
    """Whether running ``name`` through FleetSim needs the timer-wheel
    stage compiled in (``FleetConfig.hedge_timer``)."""
    _ensure_routes()
    return get(name).hedge_timer is not None


def version() -> int:
    """Monotonic registration counter — engines key their jit caches on it
    so a post-compile registration forces a retrace with the new branch
    table."""
    _ensure_builtins()
    return _VERSION
