"""Plain PyTorch versions of the port's kernels: the switch response-path
filters (B1, B2) and flash attention (B3).

Each filter walks the response lanes in order with a Python loop, vectorised over
the config axis ``G`` — exactly the lane-sequential semantics of the CUDA
kernels beside them (and of the reference's Pallas kernels), and exact on
any device.  Like the kernels, they update ``tables`` (and
``server_state``) in place.

Shapes: ``tables (G, n_tables, n_slots)``, lanes ``(G, K)``,
``server_state (G, n_servers)``, all int32.  A lane whose ``idx`` lies
outside ``[0, n_tables)`` is left alone (drop False), as the kernels do;
the engine never produces one.
"""

from __future__ import annotations

import torch

from repro_torch.core.tables import HASH_MULT, MASK32
from repro_torch.scatter import scatter_last

# ------------------------------------------------------------- attention ----
#: above this KV length the queries are processed in chunks so the
#: (Sq × Skv) score matrix is never fully materialised (memory only: the
#: result is the same)
ATTN_CHUNK_THRESHOLD = 8192
ATTN_Q_CHUNK = 2048


def _attention_block(q, k, v, sm_scale, causal, window, row_offset, skv):
    """One query block against the full K/V with masking, as the reference's
    XLA oracle: scores in float32 from the inputs' exact values, softmax in
    float32, ``P`` rounded to q's dtype before ``P·V``, which accumulates in
    float32.  Returns float32."""
    sq = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    rows = row_offset + torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols >= rows - window
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float())


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  sm_scale: float | None = None):
    """Multi-head attention, the plain version of kernel B3 (the reference's
    ``repro.kernels.ref.attention_ref``).  q ``(B, H, Sq, D)``, k/v ``(B,
    Hkv, Skv, D)``; GQA repeats each kv head ``H / Hkv`` times.  Rows align
    at the end (``offset = Skv - Sq``, the decode convention); the output is
    in q's dtype."""
    b, h, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    if hkv != h:
        k = torch.repeat_interleave(k, h // hkv, dim=1)
        v = torch.repeat_interleave(v, h // hkv, dim=1)
    offset = skv - sq  # align ends (decode case)
    if skv <= ATTN_CHUNK_THRESHOLD or sq % ATTN_Q_CHUNK:
        out = _attention_block(q, k, v, sm_scale, causal, window, offset, skv)
        return out.to(q.dtype)
    chunks = [_attention_block(q[:, :, start:start + ATTN_Q_CHUNK], k, v,
                               sm_scale, causal, window, offset + start, skv)
              for start in range(0, sq, ATTN_Q_CHUNK)]
    return torch.cat(chunks, dim=2).to(q.dtype)


def fingerprint_slot(req_id: torch.Tensor, n_slots: int) -> torch.Tensor:
    """``(uint32(req_id) · 2654435761 mod 2^32) >> 15 mod n_slots`` as
    int64.  The 32×32-bit product is split at bit 16 so no intermediate
    leaves the int64 range."""
    x = req_id.to(torch.int64) & MASK32
    hi, lo = x >> 16, x & 0xFFFF
    prod = ((((hi * HASH_MULT) & 0xFFFF) << 16) + lo * HASH_MULT) & MASK32
    return (prod >> 15) % n_slots


def fingerprint_filter_ref(tables, req_id, idx, clo):
    """NetClone response filter (§3.5), lanes in order.  Returns
    ``(tables, drop)`` with ``tables`` updated in place.

    Which slot a lane touches, and whether it touches one at all, does not
    depend on the table, so both are computed for every lane up front; only
    the read-compare-write of each lane runs in the sequential loop."""
    g, n_tables, n_slots = tables.shape
    flat = tables.view(g, n_tables * n_slots)
    ok = (clo > 0) & (idx >= 0) & (idx < n_tables)
    pos = idx.clamp(0, n_tables - 1).to(torch.int64) * n_slots \
        + fingerprint_slot(req_id, n_slots)
    hits = []
    for p, o, r in zip(pos.split(1, dim=1), ok.split(1, dim=1),
                       req_id.split(1, dim=1)):
        occupant = torch.gather(flat, 1, p)
        hit = o & (occupant == r)
        # hit → clear the slot; miss → write the id; CLO=0 → leave it
        flat.scatter_(1, p, torch.where(o, torch.where(hit, 0, r),
                                        occupant))
        hits.append(hit)
    drop = torch.cat(hits, dim=1) if hits else torch.zeros_like(ok)
    return tables, drop


def tickfuse_ref(server_state, tables, req_id, idx, clo, sid, qlen):
    """The fused response path: per lane in order, ``StateT[sid] = qlen``
    when ``0 <= sid < n_servers``, then the filter step.  Returns
    ``(server_state, tables, drop)``, both updated in place.

    StateT and the filter tables are separate state, so the interleaving
    of their writes cannot matter: StateT ends with each server's last
    in-range lane (the last-lane-wins scatter), the tables as the filter's
    lane loop leaves them."""
    scatter_last(server_state, sid, qlen,
                 torch.ones(sid.shape, dtype=torch.bool, device=sid.device))
    _, drop = fingerprint_filter_ref(tables, req_id, idx, clo)
    return server_state, tables, drop
