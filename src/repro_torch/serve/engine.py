"""Continuous-batching decode replica, port of ``repro.serve.engine``.

One replica = one model copy with a fixed number of decode slots and a FIFO
admission queue.  The NetClone contract lives at the queue boundary:

* responses piggyback the *post-dequeue* queue length (STATE field);
* a cloned request (CLO=2) is dropped on arrival if the queue is non-empty —
  the server-side guard against stale switch state (paper §3.4).

``tick()`` advances the replica by one decode step for every active slot and
admits queued requests into free slots ("prefill by decode": the prompt is
fed one token per tick, as in the reference).  ``slowdown_ticks`` models a
straggling replica: it skips that many ticks of work.

The slots' next tokens and positions are kept on the host and copied to the
device once per tick; the argmax stays on the device, and its result comes
back once per tick (the reference's ``np.asarray``).  A MoE model's
decode step routes dropless, each slot's token a group of its own, so a
slot's tokens do not depend on what the other slots hold.  The replica
runs on the CUDA device unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core.header import CLO_CLONE
from repro_torch.device import resolve_device
from repro_torch.models import family_of
from repro_torch.models.common import ModelConfig


@dataclass
class ServeRequest:
    req_id: int
    prompt: np.ndarray            # (P,) int32
    max_new_tokens: int
    clo: int = 0                  # CLO field
    idx: int = 0                  # filter-table index
    arrival_tick: int = 0
    grp: int = -1


@dataclass
class Completion:
    req_id: int
    tokens: np.ndarray
    sid: int
    state: int                    # piggybacked queue length
    clo: int
    idx: int
    finish_tick: int = 0


@dataclass
class _Slot:
    req: ServeRequest
    pos: int
    generated: list = field(default_factory=list)


class DecodeReplica:
    """A single model replica with continuous batching."""

    def __init__(self, cfg: ModelConfig, params: Any, sid: int,
                 n_slots: int = 4, s_max: int = 128, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.sid = sid
        self.n_slots = n_slots
        self.s_max = s_max
        self.device = resolve_device(device)
        self.queue: list[ServeRequest] = []
        self.slots: list[_Slot | None] = [None] * n_slots
        self.slowdown_ticks = 0
        self.n_clone_drops = 0
        self.n_decoded_tokens = 0
        self.n_decode_steps = 0     # model calls (one a tick with a slot)
        self._fam = family_of(cfg)
        self._cache = self._fam.init_cache(cfg, n_slots, s_max,
                                           device=self.device)
        self._tokens = np.zeros((n_slots, 1), np.int32)
        self._pos = np.zeros((n_slots,), np.int32)

    # -- NetClone server-side contract ---------------------------------------
    def submit(self, req: ServeRequest) -> bool:
        """Returns False iff the request was dropped (CLO=2 on busy queue)."""
        if len(req.prompt) == 0:
            raise ValueError("ServeRequest.prompt must hold at least one "
                             "token (prefill starts from prompt[0])")
        if req.clo == CLO_CLONE and self.queue_len > 0:
            self.n_clone_drops += 1
            return False
        self.queue.append(req)
        return True

    @property
    def queue_len(self) -> int:
        """Requests *waiting* beyond the free slots (a request a free slot
        admits at the next tick boundary is not queue depth)."""
        return max(0, len(self.queue) - self.slots.count(None))

    def inject_slowdown(self, ticks: int) -> None:
        self.slowdown_ticks += ticks

    # -- engine ---------------------------------------------------------------
    def _admit(self, tick: int) -> None:
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                # prefill-by-decode: feed prompt tokens one per tick start
                self.slots[i] = _Slot(req=req, pos=0)
                self._pos[i] = 0
                self._tokens[i, 0] = int(req.prompt[0])

    def tick(self, tick: int) -> list[Completion]:
        """One decode step for all active slots; returns completions."""
        if self.slowdown_ticks > 0:
            self.slowdown_ticks -= 1
            return []
        self._admit(tick)
        if all(s is None for s in self.slots):
            return []
        tokens = torch.from_numpy(self._tokens).to(self.device)
        pos = torch.from_numpy(self._pos).to(self.device)
        self.n_decode_steps += 1
        logits, self._cache = self._fam.decode_step(
            self.cfg, self.params, tokens, pos, self._cache,
            device=self.device)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        done: list[Completion] = []
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            self.n_decoded_tokens += 1
            slot.pos += 1
            p = slot.pos
            if p < len(slot.req.prompt):
                tok = int(slot.req.prompt[p])        # still prefilling
            else:
                tok = int(nxt[i])
                slot.generated.append(tok)
            self._tokens[i, 0] = tok
            self._pos[i] = p
            if len(slot.generated) >= slot.req.max_new_tokens:
                done.append(Completion(
                    req_id=slot.req.req_id,
                    tokens=np.asarray(slot.generated, np.int32),
                    sid=self.sid,
                    state=0,  # patched below, post-dequeue
                    clo=slot.req.clo,
                    idx=slot.req.idx,
                    finish_tick=tick,
                ))
                self.slots[i] = None
        if done:
            self._admit(tick)       # freed slots pull from the queue first
            for c in done:
                c.state = self.queue_len    # post-dequeue *waiting* depth
        return done
