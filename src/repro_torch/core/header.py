"""NetClone packet header (paper §3.2, Figure 3) — the port's copy of
``repro.core.header``: the field values, and the request and response
packets of the discrete-event simulator (slotted objects carrying the
header's fields plus the bookkeeping a simulator needs).
"""

from __future__ import annotations

from dataclasses import dataclass, field

# --- CLO field values (paper §3.2) -----------------------------------------
CLO_NONE = 0   #: non-cloned request
CLO_ORIG = 1   #: cloned *original* request (always served)
CLO_CLONE = 2  #: cloned request (dropped by the server if its queue is busy)

# --- STATE field values ------------------------------------------------------
STATE_IDLE = 0  #: empty request queue — the server is *considered idle*
# any value > 0 is the piggybacked queue length (RackSched integration, §3.7)


@dataclass(slots=True)
class Request:
    """A NetClone request packet (TYPE=REQ)."""

    req_id: int = -1          # REQ_ID — assigned by the switch
    grp: int = -1             # GRP    — client-random group id → pair
    clo: int = CLO_NONE       # CLO    — 0 / 1 / 2
    idx: int = 0              # IDX    — client-random filter-table index
    dst: int = -1             # destination server id (AddrT output)
    switch_id: int = 0        # multi-rack deployments (§3.7)
    # -- simulator bookkeeping (not on the wire) --
    t_arrival: float = 0.0    # client generation time
    service: float = 0.0      # service demand in µs (shared by both copies)
    client_id: int = 0
    key: int = -1             # KV workloads: object key
    op: int = 0               # KV workloads: 0=GET, 1=SCAN, 2=WRITE


@dataclass(slots=True)
class Response:
    """A NetClone response packet (TYPE=RESP)."""

    req_id: int = -1
    sid: int = -1             # SID   — responding server id
    state: int = STATE_IDLE   # STATE — piggybacked queue length (0 == idle)
    clo: int = CLO_NONE       # CLO   — copied from the request
    idx: int = 0              # IDX   — copied from the request
    # -- simulator bookkeeping --
    t_arrival: float = 0.0
    client_id: int = 0
    request: Request | None = field(default=None, repr=False)
