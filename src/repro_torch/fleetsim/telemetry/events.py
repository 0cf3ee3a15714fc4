"""FleetScope event vocabulary: the packed int32 trace-record layout (the
port's copy of ``repro.fleetsim.telemetry.events``).

Every telemetry emit point in the staged tick pipeline appends fixed-width
``REC`` -field int32 records to the device-resident ring buffer
(:class:`repro_torch.fleetsim.telemetry.device.TraceBuffer`).  The layout
is the contract between the device side (``stages.py`` emit points) and
the host-side decoder (``telemetry.decode``); the reference's
``docs/observability.md`` documents it, and the two packages' records are
equal field for field.

Record fields (all int32)::

    REC_TICK    tick the event happened on
    REC_KIND    one of the EV_* kinds below
    REC_RID     fabric-global REQ_ID (-1 when not request-scoped)
    REC_SERVER  fabric-global server id (-1 when no server is involved)
    REC_CLIENT  client id (-1 when no client is involved)
    REC_ARG     kind-specific argument (see EVENT_ARG)

The ``EV_CLONE`` kind is emitted at *every* site that increments the
``n_cloned`` counter — immediate ToR/spine clones (``stage_route``),
coordinator clone dispatches (``stage_coordinator``) and fired hedges
(``stage_hedge_timer``) — so ``count(EV_CLONE) == n_cloned`` holds for any
run whose ring buffer did not wrap.  Likewise ``count(EV_CLIENT_COMPLETE)
== n_completed`` and ``count(EV_FILTER_DROP) == n_filtered``; the Chrome
trace export and ``tests/test_torch_telemetry.py`` lean on these
identities.
"""

from __future__ import annotations

# ------------------------------------------------------ record layout ------
REC_TICK = 0
REC_KIND = 1
REC_RID = 2
REC_SERVER = 3
REC_CLIENT = 4
REC_ARG = 5
REC = 6          # fields per record

# -------------------------------------------------------- event kinds ------
EV_ARRIVAL = 1          # admitted at the fabric        arg = home rack
EV_ROUTE = 2            # ToR/spine routing decision    arg = 1 iff cloned
EV_CLONE = 3            # a clone copy placed           arg = CLONE_SRC_*
EV_COORD_ENQ = 4        # parked at the coordinator     arg = ring depth
EV_COORD_DISPATCH = 5   # coordinator drain pop         arg = 0
EV_HEDGE_ARMED = 6      # timer-wheel entry armed       arg = delay (ticks)
EV_HEDGE_CANCELLED = 7  # timer cancelled / lost        arg = 0
EV_SERVER_START = 8     # dequeued onto a worker        arg = 0
EV_SERVER_FINISH = 9    # worker completion             arg = queue depth left
EV_FILTER_DROP = 10     # redundant copy filtered       arg = filter switch
EV_CLIENT_COMPLETE = 11  # first response delivered     arg = latency (µs)
EV_CLIENT_REDUNDANT = 12  # redundant absorbed at client arg = 0

EVENT_NAMES = {
    EV_ARRIVAL: "arrival",
    EV_ROUTE: "route",
    EV_CLONE: "clone",
    EV_COORD_ENQ: "coord_enq",
    EV_COORD_DISPATCH: "coord_dispatch",
    EV_HEDGE_ARMED: "hedge_armed",
    EV_HEDGE_CANCELLED: "hedge_cancelled",
    EV_SERVER_START: "server_start",
    EV_SERVER_FINISH: "server_finish",
    EV_FILTER_DROP: "filter_drop",
    EV_CLIENT_COMPLETE: "client_complete",
    EV_CLIENT_REDUNDANT: "client_redundant",
}

# EV_CLONE arg values — where the copy came from
CLONE_SRC_LOCAL = 0      # immediate clone, both copies in the home rack
CLONE_SRC_INTERRACK = 1  # immediate clone, remote copy via the spine
CLONE_SRC_COORD = 2      # coordinator clone dispatch
CLONE_SRC_HEDGE = 3      # hedge timer fired

EVENT_ARG = {
    EV_ARRIVAL: "home_rack",
    EV_ROUTE: "cloned",
    EV_CLONE: "clone_src",
    EV_COORD_ENQ: "ring_depth",
    EV_HEDGE_ARMED: "delay_ticks",
    EV_SERVER_FINISH: "queue_depth",
    EV_FILTER_DROP: "filter_switch",
    EV_CLIENT_COMPLETE: "latency_us",
}

# -------------------------------------------- windowed series counters -----
# Metrics fields snapshotted into SeriesState.counters at every tick (last
# write of a window wins, so each row holds the end-of-window cumulative
# value); the host-side decoder differences adjacent rows into per-window
# rates.  Order is the column order of the (n_windows, len(...)) array.
SERIES_COUNTERS = (
    "n_arrivals",
    "n_cloned",
    "n_clone_drops",
    "n_filtered",
    "n_redundant",
    "n_completed",
    "n_overflow",
    "n_hedges_armed",
    "n_hedges_cancelled",
    "n_coord_queued",
)
