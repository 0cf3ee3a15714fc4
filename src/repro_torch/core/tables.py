"""Switch data-plane tables (paper §3.3–§3.5) — the parts the port needs.

The port's copy of ``repro.core.tables``: the group table's pair order
(``GroupTable(n).pairs``; the array engine indexes it by a uniform group
draw, so the order is part of the random stream) and the multiplicative
fingerprint hash.
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

    def __init__(self, n_servers: int):
        if n_servers < 2:
            raise ValueError("NetClone requires at least two servers for "
                             "redundancy")
        pairs = []
        for a, b in itertools.combinations(range(n_servers), 2):
            pairs.append((a, b))
            pairs.append((b, a))
        self.pairs = np.asarray(pairs, dtype=np.int32)  # (n_groups, 2)

    @property
    def n_groups(self) -> int:
        return int(self.pairs.shape[0])
