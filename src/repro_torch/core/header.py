"""NetClone header field values (paper §3.2, Figure 3) — the port's copy of
``repro.core.header``'s constants."""

# --- CLO field values (paper §3.2) -----------------------------------------
CLO_NONE = 0   #: non-cloned request
CLO_ORIG = 1   #: cloned *original* request (always served)
CLO_CLONE = 2  #: cloned request (dropped by the server if its queue is busy)

# --- STATE field values ------------------------------------------------------
STATE_IDLE = 0  #: empty request queue — the server is *considered idle*
