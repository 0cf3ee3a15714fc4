"""The builtin policy table: names, dense ids and engine flags.

The port's copy of what ``repro.scenarios.registry`` holds for the builtin
registrations of ``repro.core.policies``.  The reference attaches DES
factories and jax branch callables to the same entries; the port keeps only
the data the array engine reads and its own branch table (in
``repro_torch.fleetsim.policies``), keyed on the same ids.
"""

from __future__ import annotations

from typing import NamedTuple


class PolicyDef(NamedTuple):
    name: str
    policy_id: int
    spine_clone: bool = False    # the spine may upgrade saturated lanes
    client_dup: bool = False     # the client sends both copies (2x TX)
    coordinator: bool = False    # lanes park at the coordinator node
    hedge_timer: bool = False    # arms a delayed duplicate in the wheel
    description: str = ""


_POLICIES = (
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
)


def get(name: str) -> PolicyDef:
    for d in _POLICIES:
        if d.name == name:
            return d
    raise KeyError(f"unknown policy {name!r}; registered: "
                   f"{sorted(d.name for d in _POLICIES)}")


def policy_id_map() -> dict[str, int]:
    return {d.name: d.policy_id for d in _POLICIES}


def policy_name_map() -> dict[int, str]:
    return {d.policy_id: d.name for d in _POLICIES}


def spine_clone_ids() -> tuple[int, ...]:
    return tuple(d.policy_id for d in _POLICIES if d.spine_clone)


def client_dup_ids() -> tuple[int, ...]:
    return tuple(d.policy_id for d in _POLICIES if d.client_dup)


def coordinator_ids() -> tuple[int, ...]:
    return tuple(d.policy_id for d in _POLICIES if d.coordinator)


def hedge_timer_ids() -> tuple[int, ...]:
    return tuple(d.policy_id for d in _POLICIES if d.hedge_timer)


def needs_coordinator(name: str) -> bool:
    return get(name).coordinator


def needs_hedge_timer(name: str) -> bool:
    return get(name).hedge_timer
