"""The continuous-batching server stage (``FleetConfig.server_model=
"batch"``), port of ``repro.fleetsim.llmserve.stage``.

Each server is a continuous-batching replica with ``cfg.n_slots`` decode
slots instead of an FCFS worker pool: a queued request is admitted into any
free slot, **every** busy slot makes progress each tick, and a request
completes when its demand (prefill + generated-length × per-token decode,
in µs — see :mod:`repro_torch.fleetsim.llmserve.service`) is exhausted.
This is the array form of :class:`repro_torch.serve.engine.DecodeReplica`,
and the cross-validation tier in :mod:`repro_torch.fleetsim.llmserve.
oracle` holds the two to each other.

The stage reuses the FCFS state layout — the worker metadata tensor *is*
the slot tensor (same ``WF`` payload fields, ``REM`` holds remaining
demand) and the ring queue *is* the admission queue — so it composes with
every other stage unchanged.  After the slots advance, the reference's
batch stage and its FCFS stage run the same code line for line (the CLO=2
drop rule at the slot-wait boundary, the admission ring, admission into
the free slots, the response lanes, the trace records), which the port
shares as :func:`repro_torch.fleetsim.stages.serve_lanes`.  Batching
pressure is exported two ways:

* the response piggyback carries the post-admission **waiting** depth
  (requests beyond the free slots), matching ``DecodeReplica``'s
  ``queue_len``, so netclone/racksched policies clone/JSQ on batch
  pressure exactly as they do on FCFS queue depth;
* busy-slot occupancy accumulates into ``Metrics.n_slot_busy`` and
  surfaces as ``FleetResult.mean_slot_occupancy``.

``batch_coupling`` models the compute-bound end of the batching spectrum:
a slot running beside ``k`` busy neighbours progresses at ``1 / (1 +
coupling × (k-1)/(B-1))`` per tick, computed op for op in the reference's
float32 order.  At the default ``coupling=0`` slots are independent, and
with ``batch_slots == n_workers`` the stage's arithmetic is the FCFS
ring's (``tests/test_torch_llmserve.py``).  The stage runs only when the
static ``server_model`` flag says "batch"; ``"fcfs"`` ticks run no op of
this module.
"""

from __future__ import annotations

import torch

from repro_torch.fleetsim.config import FleetConfig
from repro_torch.fleetsim.state import WF, WF_REM, FleetState


def stage_server_batch(cfg: FleetConfig, params, state: FleetState,
                       arr, lanes, slot_div: torch.Tensor):
    """Slots advance (coupling-scaled) and count into ``n_slot_busy``; then
    the server-side CLO=2 drop rule at the slot-wait boundary, FCFS
    admission-ring enqueue, and admission of the oldest waiting requests
    into freed slots (demand drawn from the tick's ``arr.u_exec``:
    intrinsic base × per-execution noise × straggler slowdown + jitter
    spikes), through :func:`~repro_torch.fleetsim.stages.serve_lanes`.
    ``slot_div`` is max(B−1, 1) as a 0-d float32 tensor on the run's
    device (:class:`~repro_torch.fleetsim.stages.Divisors`)."""
    from repro_torch.fleetsim.stages import _f32, _sum, serve_lanes

    B = cfg.n_slots
    g = lanes.dst.shape[0]
    m = state.metrics

    # -- slots advance, completions (busy ⇔ REM > 0) -----------------
    # every busy slot progresses this tick; batch_coupling throttles the
    # per-slot rate with occupancy (0 → independent slots, memory-bound)
    meta = state.workers.meta.view(g, cfg.n_servers_total, B, WF)
    was_busy = meta[..., WF_REM] > 0
    k_busy = was_busy.sum(dim=2)                     # (G, ST)
    # float32, in the reference's order: coupling × max(k-1, 0), then
    # / max(B-1, 1), then 1 / (1 + …); each op rounds on its own.  The
    # divisor ``slot_div`` is that max as a 0-d tensor, so the division is
    # true division on CUDA too (ROADMAP C9)
    prod = (torch.clamp(k_busy - 1, min=0).to(torch.float32)
            * _f32(cfg.batch_coupling))
    frac = prod / slot_div
    speed = 1.0 / (1.0 + frac)
    step = _f32(cfg.dt_us) * speed                   # float32 product
    rem = torch.where(was_busy, meta[..., WF_REM] - step[..., None], 0.0)
    state = state._replace(metrics=m._replace(
        n_slot_busy=m.n_slot_busy + _sum(k_busy)))
    return serve_lanes(cfg, params, state, arr, lanes, meta, was_busy, rem)
