"""Response-lane batches that exercise every ordering hazard of the switch
response-path kernels, for holding a kernel against its plain version.

Besides random lanes, every batch carries the cases the lane order decides:
both copies of a request in one tick, different request ids that hash to
one slot, CLO=0 lanes, inactive lanes (``sid = n_servers``, ``clo = 0``),
several lanes of one server, and fingerprints already parked in the tables.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.tables import fingerprint_hash


def colliding_ids(n_slots: int, n_groups: int, per_group: int,
                  rng: np.random.Generator) -> np.ndarray:
    """``(n_groups, per_group)`` distinct request ids; the ids of one row
    share a filter slot."""
    cand = np.arange(1, 64 * n_slots * per_group, dtype=np.int64)
    slots = fingerprint_hash(cand, n_slots)
    order = np.argsort(slots, kind="stable")
    by_slot = np.split(cand[order], np.cumsum(np.bincount(slots))[:-1])
    full = [b for b in by_slot if len(b) >= per_group]
    pick = rng.choice(len(full), size=n_groups, replace=False)
    return np.stack([full[i][:per_group] for i in pick]).astype(np.int32)


def filter_lanes(g: int, k: int, n_tables: int, n_slots: int,
                 n_servers: int, seed: int = 0) -> dict[str, np.ndarray]:
    """One tick of response lanes for ``g`` configs: ``tables``
    ``(g, n_tables, n_slots)``, ``server_state`` ``(g, n_servers)`` and the
    ``(g, k)`` lanes ``rid, idx, clo, sid, qlen`` (all int32)."""
    rng = np.random.default_rng(seed)
    ids = colliding_ids(n_slots, 8, 4, rng)          # 8 slots × 4 ids
    rid = ids.reshape(-1)[rng.integers(0, ids.size, (g, k))]
    # half the lanes draw from a wide id range (mostly misses)
    wide = rng.random((g, k)) < 0.5
    rid = np.where(wide, rng.integers(1, 2 ** 24, (g, k)), rid)
    idx = rng.integers(0, n_tables, (g, k))
    clo = rng.integers(0, 3, (g, k))
    sid = rng.integers(0, n_servers, (g, k))
    # both copies of one request in one tick, same filter index
    for lane in range(0, k - 1, 4):
        rid[:, lane + 1] = rid[:, lane]
        idx[:, lane + 1] = idx[:, lane]
        clo[:, lane:lane + 2] = np.maximum(clo[:, lane:lane + 2], 1)
    # several lanes of one server
    sid[:, k // 2:k // 2 + 4] = sid[:, k // 2:k // 2 + 1]
    # inactive lanes arrive neutralised
    inactive = rng.random((g, k)) < 0.15
    sid = np.where(inactive, n_servers, sid)
    clo = np.where(inactive, 0, clo)
    qlen = rng.integers(0, 20, (g, k))
    tables = np.where(rng.random((g, n_tables, n_slots)) < 0.05,
                      rng.integers(1, 2 ** 24, (g, n_tables, n_slots)), 0)
    # park half the colliding ids at their slots (hits for the lanes)
    for r in ids[:, :2].reshape(-1):
        t = rng.integers(0, n_tables)
        tables[:, t, fingerprint_hash(int(r), n_slots)] = r
    server_state = rng.integers(0, 20, (g, n_servers))
    out = dict(tables=tables, server_state=server_state, rid=rid, idx=idx,
               clo=clo, sid=sid, qlen=qlen)
    return {name: np.ascontiguousarray(a, dtype=np.int32)
            for name, a in out.items()}
