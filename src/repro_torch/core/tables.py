"""Switch data-plane tables (paper §3.3–§3.5, Algorithm 1).

The port's copy of ``repro.core.tables`` (numpy only):

* ``GroupTable`` (GrpT) — group id → (Srv1, Srv2); ``2·C(n,2)`` ordered
  pairs keep the first candidate uniform.  Its pair order is part of the
  array engine's random stream (it indexes it by a uniform group draw);
* ``StateTable`` (StateT + ShadowT) — the piggybacked per-server queue
  length, both copies written on every response;
* ``FilterTables`` (FilterT) — ``n_tables`` hash-indexed arrays of request
  fingerprints that drop the slower response of a cloned request;
* ``fingerprint_hash`` — the multiplicative hash both engines use.

All of it is soft state: wiping it (switch failure, §3.6) never causes
permanent misbehaviour.
"""

from __future__ import annotations

import itertools

import numpy as np

# Knuth multiplicative hash constant (2^32 / phi)
HASH_MULT = 2654435761
MASK32 = 0xFFFFFFFF


def fingerprint_hash(req_id, n_slots: int):
    """Hash a request id to a filter-table slot index (Python ints or numpy
    arrays; ``n_slots`` a power of two)."""
    x = (np.asarray(req_id, dtype=np.uint64) * np.uint64(HASH_MULT)) \
        & np.uint64(MASK32)
    out = (x >> np.uint64(15)) % np.uint64(n_slots)
    if np.isscalar(req_id) or getattr(req_id, "shape", ()) == ():
        return int(out)
    return out.astype(np.int64)


class GroupTable:
    """GrpT: group id → ordered candidate server pair.

    ``2·C(n,2)`` ordered pairs (both (i, j) and (j, i)) keep the
    first-candidate distribution uniform (paper §3.3)."""

    def __init__(self, n_servers: int, server_ids=None):
        if n_servers < 2:
            raise ValueError("NetClone requires at least two servers for "
                             "redundancy")
        ids = list(server_ids) if server_ids is not None \
            else list(range(n_servers))
        if len(ids) != n_servers:
            raise ValueError("server_ids length mismatch")
        pairs = []
        for a, b in itertools.combinations(range(n_servers), 2):
            pairs.append((ids[a], ids[b]))
            pairs.append((ids[b], ids[a]))
        self.pairs = np.asarray(pairs, dtype=np.int32)  # (n_groups, 2)

    @property
    def n_groups(self) -> int:
        return int(self.pairs.shape[0])

    def lookup(self, grp: int) -> tuple[int, int]:
        s1, s2 = self.pairs[grp]
        return int(s1), int(s2)

    def remove_server(self, sid: int) -> None:
        """Control-plane update on server failure (§3.6): drop groups
        touching ``sid``.  Client group-space must shrink accordingly."""
        keep = ~np.any(self.pairs == sid, axis=1)
        if not keep.any():
            raise ValueError("removing server would leave no candidate pairs")
        self.pairs = self.pairs[keep]


class StateTable:
    """StateT (+ ShadowT): per-server piggybacked queue length.

    ``shadow`` is a real second array mirroring the hardware structure (a
    PISA pipeline reads a physical table once per pass); ``idle`` means the
    tracked queue length is zero (the paper's *considered idle*)."""

    def __init__(self, n_servers: int):
        self.state = np.zeros(n_servers, dtype=np.int32)
        self.shadow = np.zeros(n_servers, dtype=np.int32)

    def update(self, sid: int, qlen: int) -> None:
        # both copies written in the same pipeline pass (Alg. 1 lines 15-16)
        self.state[sid] = qlen
        self.shadow[sid] = qlen

    def is_idle_pair(self, s1: int, s2: int) -> bool:
        # StateT read for Srv1, ShadowT read for Srv2 (Alg. 1 line 6)
        return self.state[s1] == 0 and self.shadow[s2] == 0

    def load(self, sid: int) -> int:
        return int(self.state[sid])

    def wipe(self) -> None:
        """Switch failure: soft state is lost, not corrupted (§3.6)."""
        self.state[:] = 0
        self.shadow[:] = 0


class FilterTables:
    """FilterT: redundant-response filter (paper §3.5, Alg. 1 lines 17-25).

    The *faster* response of a cloned request inserts its REQ_ID into slot
    ``hash(req_id)`` of table ``idx``; the *slower* response finds its own
    id there, clears the slot, and is dropped.  A mismatching occupant is
    overwritten — bounded memory, tolerant of response drops, at the price
    of a rare unfiltered redundant response."""

    def __init__(self, n_tables: int = 2, n_slots: int = 2 ** 17):
        if n_slots & (n_slots - 1):
            raise ValueError("n_slots must be a power of two")
        self.tables = np.zeros((n_tables, n_slots), dtype=np.int64)
        self.n_tables = n_tables
        self.n_slots = n_slots
        # statistics (observability, not on the ASIC)
        self.n_filtered = 0
        self.n_inserted = 0
        self.n_overwrites = 0

    def process(self, req_id: int, idx: int) -> bool:
        """Process one response of a cloned request: ``True`` if it must be
        DROPPED (the redundant slower copy).  REQ_ID 0 is the empty-slot
        marker, so the sequence starts at 1."""
        slot = fingerprint_hash(req_id, self.n_slots)
        table = self.tables[idx]
        occupant = table[slot]
        if occupant == req_id:
            table[slot] = 0           # clear — slot becomes reusable
            self.n_filtered += 1
            return True
        if occupant != 0:
            self.n_overwrites += 1
        table[slot] = req_id          # insert fingerprint (overwrite allowed)
        self.n_inserted += 1
        return False

    @property
    def memory_bytes(self) -> int:
        # the prototype uses 32-bit slots (§4.1)
        return self.tables.size * 4

    def wipe(self) -> None:
        self.tables[:] = 0
