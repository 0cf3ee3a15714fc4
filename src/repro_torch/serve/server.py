"""NetClone serving cluster, port of ``repro.serve.server``: the batched
switch data plane in front of decode replicas.

The dispatch tier runs the port's batched data plane
(:mod:`repro_torch.core.switch`) with one switch (``G = 1``): one
``dispatch_tick`` decides cloning for every request that arrived this
tick, and one launch of kernel B1 (``fingerprint_filter``) deduplicates
every completion.  Policies:

* ``baseline``  — uniform random replica, no cloning;
* ``netclone``  — clone onto the group pair when both tracked-idle, server-
  side CLO=2 drop, fingerprint response filtering (the paper);
* ``netclone+racksched`` — paper §3.7: idle-idle pairs clone; otherwise the
  request goes to the shorter-queue candidate (JSQ power-of-two fallback);
* ``c-clone``   — always clone (for comparison curves).

The dispatcher draws from ``np.random.default_rng(seed)`` in the
reference's order (group, then the baseline's replica, then the filter
index), so it dispatches exactly as the reference does.  The switch state
lives on the CUDA device unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import switch as sw
from repro_torch.core.header import CLO_CLONE, CLO_NONE, CLO_ORIG
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import fingerprint_filter
from repro_torch.scatter import scatter_last
from repro_torch.serve.engine import Completion, DecodeReplica, ServeRequest


@dataclass
class ServeStats:
    latencies_ticks: list = field(default_factory=list)
    n_cloned: int = 0
    n_filtered: int = 0
    n_clone_drops: int = 0
    n_completed: int = 0

    def p(self, q: float) -> float:
        return float(np.percentile(self.latencies_ticks, q)) \
            if self.latencies_ticks else float("nan")


class NetCloneServer:
    def __init__(self, replicas: list[DecodeReplica], policy: str = "netclone",
                 n_tables: int = 2, n_slots: int = 4096, seed: int = 0,
                 device=None):
        self.replicas = replicas
        self.policy = policy
        self.device = resolve_device(device)
        n = len(replicas)
        self.state = sw.init_switch_state(1, n, n_tables, n_slots,
                                          device=self.device)
        self.group_pairs = sw.group_pairs_array(n, device=self.device)
        self.n_tables = n_tables
        self.rng = np.random.default_rng(seed)
        self.stats = ServeStats()
        self._arrival: dict[int, int] = {}
        self._done: dict[int, Completion] = {}

    def _lanes(self, values) -> torch.Tensor:
        """One (1, K) int32 lane tensor on the switch's device."""
        return torch.from_numpy(np.asarray(values, np.int32)[None]).to(
            self.device)

    # -- request path ----------------------------------------------------------
    def submit(self, prompts: list[np.ndarray], max_new_tokens: int,
               tick: int) -> list[int]:
        """Dispatch a batch of new requests; returns their request ids."""
        b = len(prompts)
        if b == 0:
            return []
        n = len(self.replicas)
        grp = self.rng.integers(0, self.group_pairs.shape[0], b)
        self.state, res = sw.dispatch_tick(self.state, self.group_pairs,
                                           self._lanes(grp))
        req_ids, dst1, dst2, cloned = (x[0].cpu().numpy() for x in res)
        if self.policy == "baseline":
            dst1 = self.rng.integers(0, n, b)
            cloned = np.zeros(b, bool)
        elif self.policy == "c-clone":
            cloned = np.ones(b, bool)
        elif self.policy == "netclone+racksched":
            # JSQ fallback between the candidates when not cloning (§3.7)
            loads = self.state.server_state[0].cpu().numpy()
            jsq = np.where(loads[dst1] <= loads[dst2], dst1, dst2)
            dst1 = np.where(cloned, dst1, jsq)
        idxs = self.rng.integers(0, self.n_tables, b)
        out = []
        for i in range(b):
            rid = int(req_ids[i])
            self._arrival[rid] = tick
            clo = CLO_ORIG if cloned[i] else CLO_NONE
            self.replicas[int(dst1[i])].submit(ServeRequest(
                req_id=rid, prompt=prompts[i], max_new_tokens=max_new_tokens,
                clo=clo, idx=int(idxs[i]), arrival_tick=tick, grp=int(grp[i])))
            if cloned[i]:
                self.stats.n_cloned += 1
                self.replicas[int(dst2[i])].submit(ServeRequest(
                    req_id=rid, prompt=prompts[i],
                    max_new_tokens=max_new_tokens, clo=CLO_CLONE,
                    idx=int(idxs[i]), arrival_tick=tick, grp=int(grp[i])))
            out.append(rid)
        return out

    # -- response path -----------------------------------------------------------
    def tick(self, tick: int) -> list[Completion]:
        comps: list[Completion] = []
        for r in self.replicas:
            comps.extend(r.tick(tick))
        if not comps:
            return []
        # batched response processing: StateT update + fingerprint filter
        sid = self._lanes([c.sid for c in comps])
        qlen = self._lanes([c.state for c in comps])
        scatter_last(self.state.server_state, sid, qlen,
                     torch.ones(sid.shape, dtype=torch.bool,
                                device=self.device))
        if self.policy in ("netclone", "netclone+racksched"):
            _, drop = fingerprint_filter(
                self.state.filter_tables,
                self._lanes([c.req_id for c in comps]),
                self._lanes([c.idx for c in comps]),
                self._lanes([c.clo for c in comps]))
            drop = drop[0].cpu().numpy()
        else:
            drop = np.zeros(len(comps), bool)
        delivered = []
        for c, d in zip(comps, drop):
            if d:
                self.stats.n_filtered += 1
                continue
            if c.req_id in self._done:
                continue        # redundant response reached the client
            self._done[c.req_id] = c
            self.stats.n_completed += 1
            arrival = self._arrival.get(c.req_id)
            if arrival is not None:
                self.stats.latencies_ticks.append(tick - arrival)
            delivered.append(c)
        self.stats.n_clone_drops = sum(r.n_clone_drops for r in self.replicas)
        return delivered

    def run(self, workload: list[tuple[int, np.ndarray]], max_new_tokens: int,
            max_ticks: int = 10_000) -> ServeStats:
        """Drive the cluster: workload = [(arrival_tick, prompt), ...]."""
        pending = sorted(workload, key=lambda x: x[0])
        t, i = 0, 0
        total = len(pending)
        while t < max_ticks and self.stats.n_completed < total:
            batch = []
            while i < len(pending) and pending[i][0] <= t:
                batch.append(pending[i][1])
                i += 1
            if batch:
                self.submit(batch, max_new_tokens, t)
            self.tick(t)
            t += 1
        return self.stats
