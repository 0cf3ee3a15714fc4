"""The builtin policy table: names, dense ids, engine flags and DES
factories.

The port's copy of what ``repro.scenarios.registry`` holds for the builtin
registrations.  The array engine reads the ids and flags, and keeps its own
branch table (in ``repro_torch.fleetsim.policies``) keyed on the same ids.
The discrete-event simulator's factories are attached by
``repro_torch.core.policies``, where they are defined, as in the
reference; that module also registers the DES-only ``netclone-nofilter``,
which has no array id.  :func:`get` and :func:`names` load it on first use.
"""

from __future__ import annotations

import importlib
import sys
from typing import Any, Callable, NamedTuple

# the module that attaches the DES factories (numpy only)
_DES_MODULE = "repro_torch.core.policies"


class DuplicatePolicyError(ValueError):
    """A policy name was registered twice."""


class PolicyDef(NamedTuple):
    name: str
    policy_id: int | None        # array-engine id; None for DES-only
    spine_clone: bool = False    # the spine may upgrade saturated lanes
    client_dup: bool = False     # the client sends both copies (2x TX)
    coordinator: bool = False    # lanes park at the coordinator node
    hedge_timer: bool = False    # arms a delayed duplicate in the wheel
    description: str = ""
    des: Callable[..., Any] | None = None   # DES SwitchPolicy factory


_REGISTRY: dict[str, PolicyDef] = {d.name: d for d in (
    PolicyDef("baseline", 0,
              description="uniform random single copy (the paper's "
                          "baseline)"),
    PolicyDef("c-clone", 1, client_dup=True,
              description="client always sends two copies; no filtering"),
    PolicyDef("netclone", 2, spine_clone=True,
              description="dynamic cloning on tracked idle pairs + response "
                          "filtering"),
    PolicyDef("racksched", 3,
              description="power-of-two-choices JSQ on piggybacked loads"),
    PolicyDef("netclone+racksched", 4, spine_clone=True,
              description="§3.7: idle-idle pair clones, JSQ fallback "
                          "otherwise"),
    PolicyDef("laedge", 5, coordinator=True,
              description="LÆDGE coordinator node (CPU queue; clone iff >=2 "
                          "idle)"),
    PolicyDef("hedge", 6, hedge_timer=True,
              description="delayed hedging via per-request timers"),
)}


def _ensure_des() -> None:
    """Load the DES factories (idempotent; a no-op while that module is
    itself loading)."""
    if _DES_MODULE not in sys.modules:
        importlib.import_module(_DES_MODULE)


def attach_des(name: str, des: Callable[..., Any]) -> PolicyDef:
    """Attach the DES factory of a policy already in the table."""
    d = _REGISTRY[name]._replace(des=des)
    _REGISTRY[name] = d
    return d


def register(name: str, *, des: Callable[..., Any], client_dup: bool = False,
             description: str = "") -> PolicyDef:
    """Register a DES-only policy (no array-engine id) under a new name."""
    if name in _REGISTRY:
        raise DuplicatePolicyError(f"policy {name!r} is already registered")
    d = PolicyDef(name, None, client_dup=client_dup, description=description,
                  des=des)
    _REGISTRY[name] = d
    return d


def get(name: str) -> PolicyDef:
    _ensure_des()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def names() -> list[str]:
    """All registered policy names (registration order)."""
    _ensure_des()
    return list(_REGISTRY)


def _array() -> list[PolicyDef]:
    """The array engine's policies, by id."""
    return sorted((d for d in _REGISTRY.values() if d.policy_id is not None),
                  key=lambda d: d.policy_id)


def policy_id_map() -> dict[str, int]:
    return {d.name: d.policy_id for d in _array()}


def policy_name_map() -> dict[int, str]:
    return {d.policy_id: d.name for d in _array()}


def spine_clone_ids() -> tuple[int, ...]:
    return tuple(d.policy_id for d in _array() if d.spine_clone)


def client_dup_ids() -> tuple[int, ...]:
    return tuple(d.policy_id for d in _array() if d.client_dup)


def coordinator_ids() -> tuple[int, ...]:
    return tuple(d.policy_id for d in _array() if d.coordinator)


def hedge_timer_ids() -> tuple[int, ...]:
    return tuple(d.policy_id for d in _array() if d.hedge_timer)


def needs_coordinator(name: str) -> bool:
    return get(name).coordinator


def needs_hedge_timer(name: str) -> bool:
    return get(name).hedge_timer
