"""Cloning/scheduling policies compared in the paper (§2.2, §5.1.3); the
port's copy of ``repro.core.policies``, the discrete-event simulator's side.

Each policy answers two questions at the switch vantage point:

* ``route(req, rng)`` — which server(s) does this request go to, and with what
  CLO marking / extra pipeline delay?
* ``on_response(resp)`` — is this response dropped (redundant) or forwarded?

Policies:

* ``RandomPolicy``        — the paper's *baseline*: uniform random, no clones.
* ``CClonePolicy``        — C-Clone [Vulimiri+13]: client always sends two
                            copies; static, load-agnostic; no filtering.
* ``NetClonePolicy``      — the paper: dynamic cloning on tracked idle pairs +
                            fingerprint response filtering (wraps
                            :class:`repro_torch.core.switch.NetCloneSwitch`).
* ``RackSchedPolicy``     — RackSched [OSDI'20]: JSQ over power-of-two random
                            choices using piggybacked queue lengths.
* ``NetCloneRackSchedPolicy`` — the §3.7 integration: clone when the candidate
                            pair is idle-idle, else fall back to JSQ.
* ``LaedgePolicy``        — marker for LÆDGE [NSDI'21]; the coordinator data
                            path lives in the simulator (it is a *node*, not
                            switch logic).

CLO semantics are shared with the servers: CLO_CLONE requests are dropped by a
server whose queue is non-empty; CLO_NONE/CLO_ORIG are always served.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np

from repro_torch.core.header import CLO_CLONE, CLO_NONE, CLO_ORIG, Request, Response
from repro_torch.core.switch import NetCloneSwitch, SwitchCosts
from repro_torch.core.tables import StateTable
from repro_torch.scenarios import registry

#: (packet, extra-switch-delay-µs) pairs emitted by ``route``
Copy = tuple[Request, float]


class SwitchPolicy:
    """Interface + shared plumbing."""

    name = "abstract"
    needs_coordinator = False
    uses_groups = False

    def __init__(self, n_servers: int, costs: SwitchCosts | None = None):
        self.n_servers = n_servers
        self.costs = costs or SwitchCosts()
        self.seq = 0
        self.n_cloned = 0

    def _stamp(self, req: Request) -> None:
        self.seq += 1
        req.req_id = self.seq

    def route(self, req: Request, rng: np.random.Generator) -> list[Copy]:
        raise NotImplementedError

    def on_response(self, resp: Response) -> bool:
        """Return True iff the switch drops this response."""
        return False

    # -- failure handling ------------------------------------------------------
    def fail(self) -> None:  # switch failure: lose soft state
        self.seq = 0

    def remove_server(self, sid: int) -> None:
        raise NotImplementedError(f"{self.name} has no control-plane removal")

    @property
    def n_groups(self) -> int:
        return 0


class RandomPolicy(SwitchPolicy):
    """Baseline: forward to a uniformly random server."""

    name = "baseline"

    def __init__(self, n_servers, costs=None):
        super().__init__(n_servers, costs)
        self._alive = list(range(n_servers))

    def route(self, req, rng):
        self._stamp(req)
        req.dst = self._alive[int(rng.integers(len(self._alive)))]
        req.clo = CLO_NONE
        return [(req, self.costs.pipeline_pass)]

    def remove_server(self, sid):
        self._alive.remove(sid)


def _clone_of(req: Request, dst: int, clo: int) -> Request:
    return Request(
        req_id=req.req_id, grp=req.grp, clo=clo, idx=req.idx, dst=dst,
        t_arrival=req.t_arrival, service=req.service,
        client_id=req.client_id, key=req.key, op=req.op,
    )


class CClonePolicy(SwitchPolicy):
    """C-Clone: two copies to two distinct random servers, always.

    Both copies are ordinary requests (CLO_NONE → servers never drop them);
    there is no switch filtering, so the client processes both responses.
    The switch does no extra work (the *client* duplicated the packet), hence
    a single pipeline pass per copy.
    """

    name = "c-clone"

    def __init__(self, n_servers, costs=None):
        super().__init__(n_servers, costs)
        self._alive = list(range(n_servers))

    def route(self, req, rng):
        self._stamp(req)
        k = len(self._alive)
        i = int(rng.integers(k))
        j = (i + 1 + int(rng.integers(k - 1))) % k
        req.dst = self._alive[i]
        req.clo = CLO_NONE
        self.n_cloned += 1
        dup = _clone_of(req, self._alive[j], CLO_NONE)
        p = self.costs.pipeline_pass
        return [(req, p), (dup, p)]

    def remove_server(self, sid):
        self._alive.remove(sid)


class NetClonePolicy(SwitchPolicy):
    """The paper's switch data plane (Algorithm 1)."""

    name = "netclone"
    uses_groups = True

    def __init__(self, n_servers, costs=None, n_filter_tables: int = 2,
                 n_filter_slots: int = 2 ** 17, filtering_enabled: bool = True,
                 cloning_enabled: bool = True):
        super().__init__(n_servers, costs)
        self.switch = NetCloneSwitch(
            n_servers,
            n_filter_tables=n_filter_tables,
            n_filter_slots=n_filter_slots,
            costs=self.costs,
            cloning_enabled=cloning_enabled,
            filtering_enabled=filtering_enabled,
        )
        if not filtering_enabled:
            self.name = "netclone-nofilter"

    def route(self, req, rng):
        copies = self.switch.process_request(req)
        self.seq = self.switch.seq
        self.n_cloned = self.switch.n_cloned
        return copies

    def on_response(self, resp):
        drop, _delay = self.switch.process_response(resp)
        return drop

    def fail(self):
        self.switch.fail()
        self.seq = 0

    def remove_server(self, sid):
        self.switch.remove_server(sid)

    @property
    def n_groups(self):
        return self.switch.grp_table.n_groups


class RackSchedPolicy(SwitchPolicy):
    """RackSched: power-of-two-choices JSQ on piggybacked queue lengths."""

    name = "racksched"

    def __init__(self, n_servers, costs=None):
        super().__init__(n_servers, costs)
        self.loads = StateTable(n_servers)
        self._alive = list(range(n_servers))

    def route(self, req, rng):
        self._stamp(req)
        k = len(self._alive)
        i = int(rng.integers(k))
        j = (i + 1 + int(rng.integers(k - 1))) % k
        s1, s2 = self._alive[i], self._alive[j]
        req.dst = s1 if self.loads.load(s1) <= self.loads.load(s2) else s2
        req.clo = CLO_NONE
        return [(req, self.costs.pipeline_pass)]

    def on_response(self, resp):
        self.loads.update(resp.sid, resp.state)
        return False

    def fail(self):
        super().fail()
        self.loads.wipe()

    def remove_server(self, sid):
        self._alive.remove(sid)


class NetCloneRackSchedPolicy(NetClonePolicy):
    """NetClone + RackSched (§3.7): the state table becomes a load table.

    Idle-idle candidate pairs are cloned exactly as NetClone; otherwise the
    request goes to the shorter-queue candidate (JSQ fallback) instead of
    blindly to Srv1.
    """

    name = "netclone+racksched"

    def route(self, req, rng):
        sw = self.switch
        sw.n_requests += 1
        sw.seq += 1
        req.req_id = sw.seq
        s1, s2 = sw.grp_table.lookup(req.grp)
        p = sw.costs.pipeline_pass
        if sw.cloning_enabled and sw.state_table.is_idle_pair(s1, s2):
            req.dst = s1
            req.clo = CLO_ORIG
            sw.n_cloned += 1
            self.n_cloned = sw.n_cloned
            clone = _clone_of(req, s2, CLO_CLONE)
            return [(req, p), (clone, p + sw.costs.recirculation)]
        # JSQ fallback between the candidates (RackSched power-of-two)
        l1 = sw.state_table.load(s1)
        l2 = sw.state_table.shadow[s2]
        req.dst = s1 if l1 <= l2 else s2
        req.clo = CLO_NONE
        return [(req, p)]


class LaedgePolicy(SwitchPolicy):
    """LÆDGE marker: the switch only L3-forwards; the simulator routes all
    traffic through a CPU coordinator node implementing the LÆDGE algorithm
    (clone iff ≥2 idle; 1 idle → forward; 0 idle → queue at coordinator)."""

    name = "laedge"
    needs_coordinator = True

    def route(self, req, rng):  # pragma: no cover - handled by coordinator
        raise RuntimeError("LÆDGE routing happens in the coordinator node")


def _hedge_factory(n_servers, **kw):
    from repro_torch.core.hedging import HedgePolicy

    return HedgePolicy(n_servers, **kw)


def _netclone_nofilter_factory(n_servers, **kw):
    return NetClonePolicy(n_servers, filtering_enabled=False, **kw)


# --------------------------------------------------------------- registry ---
# Builtin registrations: name, stable array-engine id, DES factory and engine
# flags, in the reference's order.  The array branches and stage hooks are
# attached by ``repro_torch.fleetsim.policies``; the DES-only variant has no
# array-engine id.
registry.register(
    "baseline", policy_id=0, des=RandomPolicy,
    description="uniform random single copy (the paper's baseline)")
registry.register(
    "c-clone", policy_id=1, des=CClonePolicy, client_dup=True,
    description="client always sends two copies; no filtering [Vulimiri+13]")
registry.register(
    "netclone", policy_id=2, des=NetClonePolicy, spine_clone=True,
    description="dynamic cloning on tracked idle pairs + response filtering")
registry.register(
    "racksched", policy_id=3, des=RackSchedPolicy,
    description="power-of-two-choices JSQ on piggybacked loads [OSDI'20]")
registry.register(
    "netclone+racksched", policy_id=4, des=NetCloneRackSchedPolicy,
    spine_clone=True,
    description="§3.7: idle-idle pair clones, JSQ fallback otherwise")
registry.register(
    "laedge", policy_id=5, des=LaedgePolicy,
    description="LÆDGE coordinator node (CPU queue; clone iff >=2 idle)")
registry.register(
    "hedge", policy_id=6, des=_hedge_factory,
    description="delayed hedging via per-request timers (Tail at Scale)")
registry.register(
    "netclone-nofilter", des=_netclone_nofilter_factory,
    description="NetClone with response filtering disabled (Fig. 15)")


class _DESPolicies(Mapping):
    """Live registry view of the DES-capable factories (legacy
    ``POLICIES`` shape — prefer ``repro_torch.scenarios.registry``)."""

    def __getitem__(self, name):
        d = registry.get(name)
        if d.des is None:
            raise KeyError(name)
        return d.des

    def __iter__(self):
        return (n for n in registry.names()
                if registry.get(n).des is not None)

    def __len__(self):
        return sum(1 for _ in iter(self))


POLICIES = _DESPolicies()


def make_policy(name: str, n_servers: int, **kw) -> SwitchPolicy:
    """Build the DES policy registered under ``name``."""
    d = registry.get(name)
    if d.des is None:
        raise ValueError(f"policy {name!r} has no DES implementation")
    return d.des(n_servers, **kw)
