"""Link failures and rack partitions (ChaosFuzz), port of
``repro.fleetsim.chaos``.

A :class:`LinkFailure` is a ``(start_tick, duration, link_mask)`` window.
During it, request copies routed onto a dead link are dropped before the
servers, responses from partitioned servers are dropped before any switch,
and the spine steers inter-rack placement away from fully partitioned
racks.  The window is a per-run input (``RunParams.link_*``); the absent
window is the inert ``(n_ticks+1, n_ticks+1, all-False)`` triple, under
which both stages below leave every value unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.fleetsim.config import FleetConfig


@dataclass(frozen=True)
class LinkFailure:
    """One dead-link window: ``[start_tick, start_tick + duration)`` ticks
    during which the named ``servers`` (fabric-global ids) and every server
    of the named ``racks`` are unreachable.

    The JSON form is strict-keyed (``start_tick`` / ``duration`` /
    ``racks`` / ``servers``), the sub-object a ``Scenario`` file carries as
    ``"link_failure"``.
    """

    start_tick: int
    duration: int
    racks: tuple[int, ...] = ()
    servers: tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "racks", tuple(int(r) for r in self.racks))
        object.__setattr__(self, "servers",
                           tuple(int(s) for s in self.servers))
        if self.start_tick < 0:
            raise ValueError(f"link_failure start_tick must be >= 0, got "
                             f"{self.start_tick}")
        if self.duration <= 0:
            raise ValueError(f"link_failure duration must be positive, got "
                             f"{self.duration}")
        if not self.racks and not self.servers:
            raise ValueError("link_failure needs at least one dead rack or "
                             "server (racks=[...] and/or servers=[...])")
        if any(r < 0 for r in self.racks) or any(s < 0 for s in self.servers):
            raise ValueError("link_failure rack/server ids must be >= 0")

    @property
    def window(self) -> tuple[int, int]:
        return (self.start_tick, self.start_tick + self.duration)

    def mask(self, n_racks: int, n_servers: int) -> np.ndarray:
        """Dead-server mask, shape ``(n_racks * n_servers,)`` bool over
        fabric-global server ids (rack-major, the engine's layout)."""
        total = n_racks * n_servers
        dead = np.zeros(total, bool)
        for r in self.racks:
            if r >= n_racks:
                raise ValueError(f"link_failure rack {r} out of range "
                                 f"(fabric has n_racks={n_racks})")
            dead[r * n_servers:(r + 1) * n_servers] = True
        for s in self.servers:
            if s >= total:
                raise ValueError(f"link_failure server {s} out of range "
                                 f"(fabric has n_racks*n_servers={total})")
            dead[s] = True
        if dead.all():
            raise ValueError(
                "link_failure partitions every server — that is a fabric "
                "wipe; use fail_window_ticks (switch failure) instead")
        return dead

    # ------------------------------------------------------------- JSON ----
    def to_json(self) -> dict:
        d: dict = {"start_tick": self.start_tick, "duration": self.duration}
        if self.racks:
            d["racks"] = list(self.racks)
        if self.servers:
            d["servers"] = list(self.servers)
        return d

    _JSON_KEYS = ("start_tick", "duration", "racks", "servers")

    @classmethod
    def from_json(cls, d: dict) -> "LinkFailure":
        unknown = sorted(set(d) - set(cls._JSON_KEYS))
        if unknown:
            # files are the API: a misspelled knob must not silently run a
            # failure-free campaign
            raise ValueError(f"unknown link_failure keys {unknown}; "
                             f"valid: {sorted(cls._JSON_KEYS)}")
        if "start_tick" not in d or "duration" not in d:
            raise ValueError("link_failure needs start_tick and duration")
        return cls(start_tick=int(d["start_tick"]),
                   duration=int(d["duration"]),
                   racks=tuple(d.get("racks", ())),
                   servers=tuple(d.get("servers", ())))


def check_link_failure(cfg: FleetConfig, link_failure: LinkFailure | None
                       ) -> tuple[int, int, np.ndarray]:
    """Resolve a window to the per-run ``(from_tick, until_tick, mask)``
    triple; ``None`` yields the inert triple (window past the horizon,
    all-false mask)."""
    if link_failure is None:
        return (cfg.n_ticks + 1, cfg.n_ticks + 1,
                np.zeros(cfg.n_servers_total, bool))
    f0, f1 = link_failure.window
    return f0, f1, link_failure.mask(cfg.n_racks, cfg.n_servers)


def link_dead(params, tick: int) -> torch.Tensor:
    """Per-server dead mask at ``tick``, ``(G, n_racks * n_servers)`` bool —
    all-false outside each config's window."""
    in_window = ((tick >= params.link_from_tick)
                 & (tick < params.link_until_tick))
    return params.link_mask & in_window[:, None]


# ------------------------------------------------------------- tick stages --
def stage_link_failure(cfg: FleetConfig, params, state, arr, lanes):
    """Drop request copies dispatched onto a dead link (between routing and
    the servers); the switch keeps its stale view."""
    dead = link_dead(params, arr.tick)
    hit = lanes.act & torch.gather(dead, 1, lanes.dst)
    m = state.metrics
    m = m._replace(n_link_dropped_req=m.n_link_dropped_req
                   + hit.sum(dim=1, dtype=torch.int32))
    return (state._replace(metrics=m),
            lanes._replace(act=lanes.act & ~hit))


def stage_link_response(cfg: FleetConfig, params, state, arr, resp):
    """Drop responses in flight from partitioned servers before they reach
    any switch: no fingerprint, no StateT refresh, no delivery."""
    dead = link_dead(params, arr.tick)
    hit = resp.active & torch.gather(dead, 1, resp.sid)
    m = state.metrics
    m = m._replace(n_link_dropped_resp=m.n_link_dropped_resp
                   + hit.sum(dim=1, dtype=torch.int32))
    return (state._replace(metrics=m),
            resp._replace(active=resp.active & ~hit))


def rack_dead_mask(dead: torch.Tensor, n_racks: int, n_servers: int
                   ) -> torch.Tensor:
    """Racks whose *every* server link is dead, ``(G, n_racks)`` bool."""
    return dead.reshape(dead.shape[0], n_racks, n_servers).all(dim=2)
