"""Discrete-event cluster simulator reproducing the paper's testbed (§5.1);
the port's copy of ``repro.core.simulator`` (numpy only).

Topology (Figure 2): open-loop clients ↔ ToR switch ↔ worker servers, plus an
optional LÆDGE coordinator node hanging off the switch.  Every latency knob is
calibrated to the paper's hardware story (Tofino pipeline pass ≈ 400 ns, VMA
kernel-bypass host processing ≈ 1 µs, 100 GbE links).

Server model (§4.2): one dispatcher + ``n_workers`` worker threads sharing a
single FCFS run queue.  The NetClone server-side rule is enforced here: a
CLO=2 request arriving at a server whose queue is non-empty is dropped.
Responses piggyback the post-dequeue queue length in STATE.

Clients: 2 machines by default, each with one receiver thread (FCFS, fixed
per-packet RX cost) — this is what makes redundant-response filtering matter
(Fig. 15) and halves C-Clone's useful throughput.

The simulator asks the *policy* (``repro_torch.core.policies``) for routing
decisions; NetClone's decisions come from ``NetCloneSwitch``
(:mod:`repro_torch.core.switch`), Algorithm 1 line by line.
"""

from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.header import CLO_CLONE, CLO_NONE, Request, Response
from repro_torch.core.policies import SwitchPolicy, _clone_of, make_policy
from repro_torch.core.workloads import ServiceProcess, load_to_rate, rate_to_load
from repro_torch.scenarios import registry
from repro_torch.scenarios.arrival import PoissonArrival

# event kinds
_REQ_AT_SWITCH = 0
_REQ_AT_SERVER = 1
_SERVER_DONE = 2
_RESP_AT_SWITCH = 3
_RESP_AT_CLIENT = 4
_CLIENT_DONE = 5
_COORD_REQ = 6     # request reaches coordinator CPU (LÆDGE)
_COORD_RESP = 7    # response reaches coordinator CPU (LÆDGE)
_SWITCH_RECOVER = 8
_HEDGE_FIRE = 9    # delayed-hedging timer expiry (core.hedging)


@dataclass(slots=True)
class NetworkCosts:
    """Transport/processing latency model (µs)."""

    link: float = 0.5            # host ↔ switch propagation + serialisation
    server_overhead: float = 1.0 # NIC + dispatcher per request (VMA)
    client_rx: float = 0.68      # receiver-thread per response (VMA ~µs);
                                 # calibrated so 2 receivers (2.94 MRPS) sit
                                 # just under the 6×15 workers (3.13 MRPS):
                                 # ≤1 response/request fits, redundancy
                                 # without filtering saturates them (Fig. 15)
    client_tx: float = 0.15      # sender-thread per request copy (C-Clone 2×)
    coord_cpu: float = 1.5       # LÆDGE coordinator CPU per packet


@dataclass
class SimResult:
    policy: str
    offered_load: float
    offered_rate_mrps: float
    throughput_mrps: float
    mean_us: float
    p50_us: float
    p99_us: float
    p999_us: float
    n_requests: int
    n_completed: int
    n_cloned: int
    n_clone_drops: int
    n_filtered: int
    n_redundant_at_client: int
    empty_queue_fraction: float
    latencies_us: np.ndarray = field(repr=False, default=None)
    throughput_timeline: tuple = field(repr=False, default=None)

    def row(self) -> dict:
        """Flat summary row.  Keys shared with
        :meth:`repro_torch.fleetsim.metrics.FleetResult.row` carry the same names,
        units, and rounding, so DES and FleetSim rows land in the same
        tables/CSVs without translation (key parity is pinned by
        ``tests/test_telemetry.py``)."""
        return {
            "policy": self.policy, "load": self.offered_load,
            "throughput_mrps": round(self.throughput_mrps, 4),
            "p50_us": round(self.p50_us, 1), "p99_us": round(self.p99_us, 1),
            "p999_us": round(self.p999_us, 1),
            "mean_us": round(self.mean_us, 1),
            "cloned": self.n_cloned, "filtered": self.n_filtered,
            "clone_drops": self.n_clone_drops,
            "redundant": self.n_redundant_at_client,
            "empty_q": round(self.empty_queue_fraction, 3),
            # DES-only columns
            "requests": self.n_requests, "completed": self.n_completed,
        }


class _Server:
    __slots__ = ("queue", "free_workers", "n_workers", "alive")

    def __init__(self, n_workers: int):
        self.queue: deque[Request] = deque()
        self.free_workers = n_workers
        self.n_workers = n_workers
        self.alive = True


class _Client:
    """Single receiver thread with FCFS per-packet RX cost."""

    __slots__ = ("busy_until",)

    def __init__(self):
        self.busy_until = 0.0


class Simulator:
    def __init__(
        self,
        policy: SwitchPolicy | str,
        service: ServiceProcess,
        n_servers: int = 6,
        n_workers: int = 15,
        n_clients: int = 2,
        costs: NetworkCosts | None = None,
        seed: int = 0,
        worker_counts: list[int] | None = None,
        **policy_kw,
    ):
        self.n_servers = n_servers
        # the *registered* name (registry flags like client_dup hang off it;
        # a custom registration may reuse a stock factory whose .name
        # differs) — None for ad-hoc policy objects passed in directly
        self._registered_name = policy if isinstance(policy, str) else None
        if isinstance(policy, str):
            policy = make_policy(policy, n_servers, **policy_kw)
        self.policy = policy
        self.service = service
        self.costs = costs or NetworkCosts()
        self.rng = np.random.default_rng(seed)
        wc = worker_counts if worker_counts is not None else [n_workers] * n_servers
        if len(wc) != n_servers:
            raise ValueError("worker_counts length mismatch")
        self.n_workers = int(np.mean(wc))
        self.servers = [_Server(w) for w in wc]
        self.clients = [_Client() for _ in range(n_clients)]
        self.n_clients = n_clients
        # LÆDGE coordinator state
        self._coord_busy_until = 0.0
        self._coord_pending: deque[Request] = deque()
        self._coord_outstanding = np.zeros(n_servers, dtype=np.int64)
        self._coord_seen: set[int] = set()
        # redundant responses absorbed at the coordinator — the LÆDGE
        # counterpart of switch filtering, surfaced as SimResult.n_filtered
        # so clone accounting balances for coordinator policies too
        self._coord_absorbed = 0
        # stats
        self.n_clone_drops = 0
        self.n_redundant_at_client = 0
        self._empty_q_responses = 0
        self._total_responses = 0
        # switch failure window
        self._switch_down_from = None
        self._switch_down_until = None
        self._drop_during_downtime = 0
        # link failure window (ChaosFuzz campaigns — the DES counterpart of
        # repro_torch.fleetsim.chaos): dead server ids over [from, until) µs
        self._link_down_from = None
        self._link_down_until = None
        self._link_dead: frozenset[int] = frozenset()
        self.n_link_dropped_req = 0
        self.n_link_dropped_resp = 0

    # ------------------------------------------------------------------ utils
    def _push(self, heap, t, kind, payload):
        self._evseq += 1
        heapq.heappush(heap, (t, self._evseq, kind, payload))

    def schedule_switch_failure(self, t_fail: float, t_recover: float) -> None:
        """Fig. 16: the switch goes dark in [t_fail, t_recover); on recovery
        all soft state (StateT/ShadowT/FilterT/SEQ) is wiped."""
        self._switch_down_from = t_fail
        self._switch_down_until = t_recover

    def _switch_is_down(self, t: float) -> bool:
        return (
            self._switch_down_from is not None
            and self._switch_down_from <= t < self._switch_down_until
        )

    def schedule_link_failure(self, t_fail: float, t_recover: float,
                              servers) -> None:
        """ChaosFuzz link failure: the links of ``servers`` are dead in
        ``[t_fail, t_recover)`` µs.  Request copies routed onto a dead link
        and responses in flight from a partitioned server are dropped (and
        counted in ``n_link_dropped_req`` / ``n_link_dropped_resp``); the
        switch keeps serving with stale state for the dead servers, so the
        surviving copy of a cloned pair still completes — the semantics
        :mod:`repro_torch.fleetsim.chaos` implements on the array engine."""
        servers = frozenset(int(s) for s in np.asarray(servers).reshape(-1))
        if not servers:
            raise ValueError("schedule_link_failure needs at least one "
                             "dead server id")
        bad = [s for s in servers if not 0 <= s < self.n_servers]
        if bad:
            raise ValueError(f"link-failure server ids {sorted(bad)} out of "
                             f"range (fabric has n_servers={self.n_servers})")
        self._link_down_from = t_fail
        self._link_down_until = t_recover
        self._link_dead = servers

    def _link_is_down(self, t: float, sid: int) -> bool:
        return (
            self._link_down_from is not None
            and self._link_down_from <= t < self._link_down_until
            and sid in self._link_dead
        )

    # ------------------------------------------------------------------- run
    def run(
        self,
        offered_load: float = 0.5,
        n_requests: int = 50_000,
        warmup_frac: float = 0.1,
        cooldown_frac: float = 0.05,
        timeline_bin_us: float | None = None,
        arrival=None,
        n_ticks: int | None = None,
    ) -> SimResult:
        """Replay one configuration.

        ``arrival`` plugs in a :class:`repro_torch.scenarios.arrival
        .ArrivalProcess`; the default (``None``) is the paper's open-loop
        Poisson at the load-derived rate.  A trace arrival replays its
        per-tick counts over ``n_ticks`` ticks (tiled like the array
        engine), ignoring ``offered_load``/``n_requests`` — the trace *is*
        the offered schedule.
        """
        c = self.costs
        rate = load_to_rate(offered_load, self.service,
                            self.n_servers, self.n_workers)
        rng = self.rng
        if arrival is None:
            arrival = PoissonArrival()
        if arrival.kind == "trace":
            if n_ticks is None:
                raise ValueError("trace arrivals need n_ticks")
            arrivals = arrival.des_times(rng, rate, 0, n_ticks=n_ticks)
            if len(arrivals) == 0:
                raise ValueError("trace produced no arrivals")
            n_requests = len(arrivals)
            rate = arrival.mean_rate_per_us(rate, n_ticks)
            offered_load = rate_to_load(rate, self.service,
                                        self.n_servers, self.n_workers)
        else:
            # every non-trace process answers through its own des_times
            arrivals = arrival.des_times(rng, rate, n_requests,
                                         n_ticks=n_ticks)
        services = self.service.intrinsic(rng, n_requests)
        ops = self.service.ops_of(services)
        n_groups = self.policy.n_groups
        grps = rng.integers(0, n_groups, n_requests) if n_groups else np.zeros(n_requests, dtype=np.int64)
        n_tables = getattr(getattr(self.policy, "switch", None), "filter_tables", None)
        n_tables = n_tables.n_tables if n_tables is not None else 1
        idxs = rng.integers(0, n_tables, n_requests)
        client_ids = rng.integers(0, self.n_clients, n_requests)

        heap: list = []
        self._evseq = 0
        latencies = np.full(n_requests, np.nan)
        first_resp_seen = np.zeros(n_requests, dtype=bool)
        completion_times = np.full(n_requests, np.nan)
        req_index_of_id: dict[int, int] = {}

        # Inject all arrivals as REQ_AT_SWITCH events (client TX + link).
        # Client-duplicating policies (C-Clone, or any registration flagged
        # client_dup — the same flag FleetSim reads): doubled TX cost.
        try:
            dup_at_client = registry.get(
                self._registered_name or self.policy.name).client_dup
        except KeyError:           # ad-hoc policy object, never registered
            dup_at_client = False
        tx = c.client_tx * (2.0 if dup_at_client else 1.0)
        for i in range(n_requests):
            r = Request(
                grp=int(grps[i]), idx=int(idxs[i]),
                t_arrival=float(arrivals[i]), service=float(services[i]),
                client_id=int(client_ids[i]), op=int(ops[i]),
            )
            self._push(heap, arrivals[i] + tx + c.link, _REQ_AT_SWITCH, (i, r))

        if self._switch_down_until is not None:
            self._push(heap, self._switch_down_until, _SWITCH_RECOVER, None)

        needs_coord = self.policy.needs_coordinator
        drained = 0
        while heap:
            t, _, kind, payload = heapq.heappop(heap)

            if kind == _SWITCH_RECOVER:
                self.policy.fail()  # wipe soft state on recovery (§3.6)
                continue

            if kind == _REQ_AT_SWITCH:
                i, req = payload
                req_index_of_id.setdefault(id(req), i)
                if self._switch_is_down(t):
                    self._drop_during_downtime += 1
                    completion_times[i] = np.nan
                    continue
                if needs_coord:
                    # plain L3 forward to the coordinator node
                    self._push(heap, t + self.policy.costs.pipeline_pass + c.link,
                               _COORD_REQ, (i, req))
                    continue
                for pkt, sw_delay in self.policy.route(req, rng):
                    req_index_of_id[id(pkt)] = i
                    self._push(heap, t + sw_delay + c.link, _REQ_AT_SERVER, (i, pkt))
                if self.policy.name == "hedge":
                    self._push(heap, t + self.policy.delay_us, _HEDGE_FIRE,
                               (i, req.req_id))
                continue

            if kind == _HEDGE_FIRE:
                i, rid = payload
                entry = self.policy._outstanding.pop(rid, None)
                if entry is not None and not self._switch_is_down(t):
                    _due, dst2, req0 = entry
                    clone = _clone_of(req0, dst2, CLO_CLONE)
                    self.policy.n_cloned += 1
                    self._push(heap, t + self.policy.costs.pipeline_pass + c.link,
                               _REQ_AT_SERVER, (i, clone))
                continue

            if kind == _COORD_REQ:
                i, req = payload
                done = max(t, self._coord_busy_until) + c.coord_cpu
                self._coord_busy_until = done
                self._dispatch_laedge(heap, done, i, req, rng)
                continue

            if kind == _REQ_AT_SERVER:
                i, req = payload
                if self._link_is_down(t, req.dst):
                    self.n_link_dropped_req += 1
                    continue  # copy lost on the dead link
                srv = self.servers[req.dst]
                if not srv.alive:
                    continue  # lost; original path still completes via pair
                if req.clo == CLO_CLONE and len(srv.queue) > 0:
                    self.n_clone_drops += 1   # server-side stale-state guard
                    continue
                if srv.free_workers > 0:
                    srv.free_workers -= 1
                    # server-side randomness drawn *per execution*: this is
                    # the variability cloning masks
                    exec_t = self.service.execute(rng, req.service)
                    self._push(heap, t + c.server_overhead + exec_t,
                               _SERVER_DONE, (i, req, req.dst))
                else:
                    srv.queue.append((i, req, t))
                continue

            if kind == _SERVER_DONE:
                i, req, sid = payload
                srv = self.servers[sid]
                if srv.queue:
                    j, nxt, _tq = srv.queue.popleft()
                    exec_t = self.service.execute(rng, nxt.service)
                    self._push(heap, t + c.server_overhead + exec_t,
                               _SERVER_DONE, (j, nxt, sid))
                else:
                    srv.free_workers += 1
                qlen = len(srv.queue)  # post-dequeue queue length
                self._total_responses += 1
                if qlen == 0:
                    self._empty_q_responses += 1
                resp = Response(req_id=req.req_id, sid=sid, state=qlen,
                                clo=req.clo, idx=req.idx,
                                t_arrival=req.t_arrival,
                                client_id=req.client_id, request=req)
                self._push(heap, t + c.link, _RESP_AT_SWITCH, (i, resp))
                continue

            if kind == _RESP_AT_SWITCH:
                i, resp = payload
                if self._switch_is_down(t):
                    continue  # response lost with the switch
                if self._link_is_down(t, resp.sid):
                    self.n_link_dropped_resp += 1
                    continue  # response lost on the dead link: no filter
                    # fingerprint, no client delivery
                if needs_coord:
                    self._push(heap, t + self.policy.costs.pipeline_pass + c.link,
                               _COORD_RESP, (i, resp))
                    continue
                drop = self.policy.on_response(resp)
                sw = self.policy.costs.pipeline_pass
                if not drop:
                    self._push(heap, t + sw + c.link, _RESP_AT_CLIENT, (i, resp))
                continue

            if kind == _COORD_RESP:
                i, resp = payload
                done = max(t, self._coord_busy_until) + c.coord_cpu
                self._coord_busy_until = done
                self._coord_outstanding[resp.sid] -= 1
                # dispatch buffered requests onto newly idle servers
                self._drain_laedge(heap, done, rng)
                if resp.req_id in self._coord_seen:
                    self._coord_absorbed += 1
                    continue  # the coordinator absorbs the slower response
                self._coord_seen.add(resp.req_id)
                self._push(heap, done + c.link, _RESP_AT_CLIENT, (i, resp))
                continue

            if kind == _RESP_AT_CLIENT:
                i, resp = payload
                cl = self.clients[resp.client_id]
                start = max(t, cl.busy_until)
                done = start + c.client_rx
                cl.busy_until = done
                if first_resp_seen[i]:
                    self.n_redundant_at_client += 1
                    continue
                first_resp_seen[i] = True
                self._push(heap, done, _CLIENT_DONE, (i, resp))
                continue

            if kind == _CLIENT_DONE:
                i, resp = payload
                completion_times[i] = t
                latencies[i] = t - resp.t_arrival
                drained += 1
                continue

        return self._collect(offered_load, rate, arrivals, latencies,
                             completion_times, warmup_frac, cooldown_frac,
                             timeline_bin_us)

    # ----------------------------------------------------------- LÆDGE paths
    def _laedge_idle(self) -> list[int]:
        out = []
        for s in range(self.n_servers):
            srv = self.servers[s]
            if srv.alive and self._coord_outstanding[s] < srv.n_workers:
                out.append(s)
        return out

    def _dispatch_laedge(self, heap, t, i, req, rng):
        c = self.costs
        idle = self._laedge_idle()
        if len(idle) >= 2:
            picks = rng.choice(len(idle), size=2, replace=False)
            s1, s2 = idle[picks[0]], idle[picks[1]]
            req.dst = s1
            self.policy.n_cloned += 1
            dup = Request(req_id=req.req_id or i + 1, grp=req.grp, clo=CLO_NONE,
                          idx=req.idx, dst=s2, t_arrival=req.t_arrival,
                          service=req.service, client_id=req.client_id)
            dup.req_id = req.req_id = i + 1  # coordinator-assigned id
            self._coord_outstanding[s1] += 1
            self._coord_outstanding[s2] += 1
            # two TX packets through the coordinator CPU
            t2 = self._coord_busy_until = max(t, self._coord_busy_until) + c.coord_cpu
            self._push(heap, t + c.link, _REQ_AT_SERVER, (i, req))
            self._push(heap, t2 + c.link, _REQ_AT_SERVER, (i, dup))
        elif len(idle) == 1:
            req.dst = idle[0]
            req.req_id = i + 1
            self._coord_outstanding[idle[0]] += 1
            self._push(heap, t + c.link, _REQ_AT_SERVER, (i, req))
        else:
            req.req_id = i + 1
            self._coord_pending.append((i, req))

    def _drain_laedge(self, heap, t, rng):
        while self._coord_pending:
            idle = self._laedge_idle()
            if not idle:
                return
            i, req = self._coord_pending.popleft()
            req.dst = idle[int(rng.integers(len(idle)))]
            self._coord_outstanding[req.dst] += 1
            c = self.costs
            t = self._coord_busy_until = max(t, self._coord_busy_until) + c.coord_cpu
            self._push(heap, t + c.link, _REQ_AT_SERVER, (i, req))

    # --------------------------------------------------------------- metrics
    def _collect(self, load, rate, arrivals, lat, done_t, warm, cool, bin_us):
        n = len(arrivals)
        t0 = arrivals[0] + warm * (arrivals[-1] - arrivals[0])
        t1 = arrivals[-1] - cool * (arrivals[-1] - arrivals[0])
        in_win = (arrivals >= t0) & (arrivals <= t1) & ~np.isnan(lat)
        lw = lat[in_win]
        # throughput: completions whose *completion* lands in the window
        comp_in_win = (done_t >= t0) & (done_t <= t1)
        thr = comp_in_win.sum() / (t1 - t0) if t1 > t0 else 0.0
        timeline = None
        if bin_us:
            tmax = np.nanmax(done_t)
            edges = np.arange(0.0, tmax + bin_us, bin_us)
            hist, _ = np.histogram(done_t[~np.isnan(done_t)], bins=edges)
            timeline = (edges[:-1], hist / bin_us)
        ft = getattr(getattr(self.policy, "switch", None), "filter_tables",
                     None)
        if ft is None:  # host-timer policies (hedge) own their tables
            ft = getattr(self.policy, "filter_tables", None)
        # coordinator policies absorb redundancy at the coordinator CPU,
        # not a filter table — same accounting role, same field
        n_filtered = (self._coord_absorbed
                      if self.policy.needs_coordinator
                      else ft.n_filtered if ft is not None else 0)
        return SimResult(
            policy=self.policy.name,
            offered_load=load,
            offered_rate_mrps=rate,
            throughput_mrps=float(thr),
            mean_us=float(np.mean(lw)) if lw.size else float("nan"),
            p50_us=float(np.percentile(lw, 50)) if lw.size else float("nan"),
            p99_us=float(np.percentile(lw, 99)) if lw.size else float("nan"),
            p999_us=float(np.percentile(lw, 99.9)) if lw.size else float("nan"),
            n_requests=n,
            n_completed=int((~np.isnan(lat)).sum()),
            n_cloned=self.policy.n_cloned,
            n_clone_drops=self.n_clone_drops,
            n_filtered=n_filtered,
            n_redundant_at_client=self.n_redundant_at_client,
            empty_queue_fraction=(self._empty_q_responses / self._total_responses
                                  if self._total_responses else 1.0),
            latencies_us=lw,
            throughput_timeline=timeline,
        )


def sweep_load(
    policy: str,
    service: ServiceProcess,
    loads,
    n_servers: int = 6,
    n_workers: int = 15,
    n_requests: int = 50_000,
    seed: int = 0,
    **kw,
) -> list[SimResult]:
    """One latency-vs-throughput curve (the paper's standard plot)."""
    out = []
    for li, load in enumerate(loads):
        sim = Simulator(policy, service, n_servers=n_servers,
                        n_workers=n_workers, seed=seed + 1000 * li, **kw)
        out.append(sim.run(offered_load=load, n_requests=n_requests))
    return out
