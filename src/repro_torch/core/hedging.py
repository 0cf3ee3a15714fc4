"""Beyond-paper baseline: delayed hedging (Dean & Barroso, "The Tail at
Scale") as a switch policy; the port's copy of ``repro.core.hedging``.

Hedged requests send the duplicate only after the original has been
outstanding for ``delay_us`` (typically ~p95 of service time).  Compared to
the paper's schemes:

* vs C-Clone — hedging adds ≤q% extra load (q = fraction of requests slower
  than the delay) instead of 100%, so it does not halve throughput;
* vs NetClone — hedging needs *per-request timers* at the cloning point.  A
  Tofino pipeline has no per-packet timers, which is precisely why the paper
  chooses state-tracked *immediate* cloning; a host-based dispatcher (our
  serving tier) can afford them.

The DES implements hedging at the switch vantage point with an oracle-free
timer wheel; the reference's ``benchmarks/figures.py::fig_hedge`` compares
it against NetClone.  The punchline the experiment shows: hedging approaches NetClone's
tail at low load but pays the full delay on every masked straggler, so its
p99 floor is ``delay + service`` while NetClone's clones race from t=0.
"""

from __future__ import annotations


from repro_torch.core.header import CLO_CLONE, CLO_NONE, CLO_ORIG, Request
from repro_torch.core.policies import SwitchPolicy, _clone_of
from repro_torch.core.tables import FilterTables


class HedgePolicy(SwitchPolicy):
    """Delayed hedging: duplicate a request only if it is still outstanding
    after ``delay_us``.  The simulator polls ``due_hedges`` each event."""

    name = "hedge"
    uses_groups = True

    def __init__(self, n_servers, costs=None, delay_us: float = 75.0,
                 n_filter_tables: int = 2, n_filter_slots: int = 2 ** 17):
        super().__init__(n_servers, costs)
        self.delay_us = float(delay_us)
        self.filter_tables = FilterTables(n_filter_tables, n_filter_slots)
        # req_id → (hedge_due_time, dst2, request); removed on first response
        self._outstanding: dict[int, tuple[float, int, Request]] = {}
        from repro_torch.core.tables import GroupTable

        self.grp_table = GroupTable(n_servers)

    @property
    def n_groups(self) -> int:
        return self.grp_table.n_groups

    def route(self, req, rng):
        self._stamp(req)
        s1, s2 = self.grp_table.lookup(req.grp)
        req.dst = s1
        req.clo = CLO_ORIG          # responses must hit the filter table
        self._outstanding[req.req_id] = (self.delay_us, s2, req)
        return [(req, self.costs.pipeline_pass)]

    def due_hedges(self, now: float) -> list[Request]:
        """Hedges whose timers expired; called by the simulator with the
        current time — timers are armed relative to the route() call."""
        out = []
        for rid, (due, dst2, req) in list(self._outstanding.items()):
            if due <= now:
                clone = _clone_of(req, dst2, CLO_CLONE)
                self.n_cloned += 1
                out.append(clone)
                del self._outstanding[rid]
        return out

    def arm(self, req_id: int, now: float) -> None:
        """Convert the relative delay into an absolute deadline."""
        if req_id in self._outstanding:
            due, dst2, req = self._outstanding[req_id]
            if due == self.delay_us:  # not armed yet
                self._outstanding[req_id] = (now + self.delay_us, dst2, req)

    def on_response(self, resp):
        self._outstanding.pop(resp.req_id, None)   # cancel pending hedge
        if resp.clo != CLO_NONE:
            return self.filter_tables.process(resp.req_id, resp.idx)
        return False

    def fail(self):
        super().fail()
        self.filter_tables.wipe()
        self._outstanding.clear()
