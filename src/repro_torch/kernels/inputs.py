"""Response-lane batches that exercise every ordering hazard of the switch
response-path kernels, for holding a kernel against its plain version.

Besides random lanes, every batch carries the cases the lane order decides:
both copies of a request in one tick, different request ids that hash to
one slot, CLO=0 lanes, inactive lanes (``sid = n_servers``, ``clo = 0``),
several lanes of one server, and fingerprints already parked in the tables.
:func:`edge_lanes` pushes one of them to its extreme (:data:`EDGE_CASES`).
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


#: the edge-lane batches :func:`edge_lanes` makes, each with its lanes per
#: tick K: all lanes on one table entry, one id three times in a tick, id
#: 0, table indices out of range and CLO <= 0, server ids out of range, one
#: server on every lane, and K around the 32-lane passes of the kernels
EDGE_CASES = {"one_slot": 32, "rid_thrice": 32, "rid_zero": 32,
              "out_of_range": 32, "sid_out": 32, "one_server": 32,
              "k1": 1, "k31": 31, "k33": 33, "k100": 100}
#: cases outside the reference kernels' contract: their Pallas kernels
#: index out of range there (interpret mode clamps a high index and wraps a
#: negative one), where the port's leave the lane alone
OUTSIDE_REFERENCE = ("out_of_range", "sid_out")


def edge_lanes(case: str, g: int, n_tables: int, n_slots: int,
               n_servers: int, seed: int = 0) -> dict[str, np.ndarray]:
    """:func:`filter_lanes` at the case's K, then the lanes ``case`` (a key
    of :data:`EDGE_CASES`) names pushed to their edge."""
    k = EDGE_CASES[case]
    x = filter_lanes(g, k, n_tables, n_slots, n_servers, seed)
    rng = np.random.default_rng(1000 + seed)
    rid, idx, clo, sid, tables = (x[n] for n in ("rid", "idx", "clo", "sid",
                                                 "tables"))
    if case == "one_slot":
        # four ids of one slot on every lane, one table per config, all
        # active; one of the ids parked there in every other config
        ids = colliding_ids(n_slots, 1, 4, rng)[0]
        rid[:] = ids[rng.integers(0, 4, (g, k))]
        idx[:] = rng.integers(0, n_tables, (g, 1))
        clo[:] = rng.integers(1, 3, (g, k))
        sid[:] = rng.integers(0, n_servers, (g, k))
        slot = fingerprint_hash(int(ids[0]), n_slots)
        tables[::2, :, slot] = ids[1]
    elif case == "rid_thrice":
        # lanes 3, 11 and 20 carry one id to one table
        for c in range(g):
            rid[c, [11, 20]] = rid[c, 3]
            idx[c, [11, 20]] = idx[c, 3]
        clo[:, [3, 11, 20]] = np.maximum(clo[:, [3, 11, 20]], 1)
    elif case == "rid_zero":
        # id 0 on every fifth lane, active; slot 0 of half the tables
        # holds an id, of the rest nothing
        rid[:, ::5] = 0
        clo[:, ::5] = np.maximum(clo[:, ::5], 1)
        tables[:, :, 0] = np.where(rng.random((g, n_tables)) < 0.5,
                                   rng.integers(1, 2 ** 24, (g, n_tables)), 0)
    elif case == "out_of_range":
        # table indices below 0 and at or past n_tables with CLO > 0, and
        # CLO of 0 and below with an index in range
        bad = np.array([-1, -7, n_tables, n_tables + 5])
        idx[:, 0::3] = bad[rng.integers(0, 4, idx[:, 0::3].shape)]
        clo[:, 0::3] = np.maximum(clo[:, 0::3], 1)
        clo[:, 1::3] = rng.integers(-3, 1, clo[:, 1::3].shape)
    elif case == "sid_out":
        # server ids below 0 and past n_servers on a third of the lanes
        bad = np.array([-1, -100, n_servers + 1, n_servers + 3])
        sid[:, 0::3] = bad[rng.integers(0, 4, sid[:, 0::3].shape)]
    elif case == "one_server":
        sid[:] = rng.integers(0, n_servers, (g, 1))
    return {name: np.ascontiguousarray(a, dtype=np.int32)
            for name, a in x.items()}
