"""Plain PyTorch versions of the port's kernels: the switch response-path
filters (B1, B2), flash attention (B3) and the SSD (B4) and RG-LRU (B5)
scans.

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


def attention_lse_ref(q, k, v, *, causal: bool = True,
                      window: int | None = None,
                      sm_scale: float | None = None):
    """The plain version of the log-sum-exp B3's Hopper forward writes for
    the backward: ``logsumexp`` of each row's scaled scores over the keys
    its mask keeps (as :func:`attention_ref` masks, rows aligned at the
    end), ``(B, H, Sq)`` float32."""
    b, h, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    if hkv != h:
        k = torch.repeat_interleave(k, h // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    rows = (skv - sq) + torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols >= rows - window
    return torch.logsumexp(s.masked_fill(~mask, -torch.inf), dim=-1)


def attention_bwd_ref(q, k, v, dout, *, causal: bool = True,
                      window: int | None = None,
                      sm_scale: float | None = None):
    """The plain version of B3's backward: ``(dq, dk, dv)`` by autograd
    through :func:`attention_ref` (what ``jax.grad`` of the reference's XLA
    attention computes), for the incoming gradient ``dout``."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = attention_ref(qq, kk, vv, causal=causal, window=window,
                            sm_scale=sm_scale)
        return torch.autograd.grad(out, (qq, kk, vv), dout.to(out.dtype))


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


def tickfuse_masked_ref(server_state, tables, req_id, idx, clo, sid, qlen,
                        active):
    """The plain version of B2's staged entry point: the staged engine's
    lanes (``active`` bool, ``idx`` and ``sid`` int64, the rest int32)
    neutralised as the stage neutralised them (an inactive lane gets
    ``clo = 0`` and ``sid = n_servers``; ``idx`` and ``sid`` cast to
    int32), then :func:`tickfuse_ref`."""
    n_servers = server_state.shape[1]
    return tickfuse_ref(
        server_state, tables, req_id, idx.to(torch.int32),
        torch.where(active, clo, 0).to(torch.int32),
        torch.where(active, sid, n_servers).to(torch.int32), qlen)


# ------------------------------------------------------------- SSD scan -----
def ssd_scan_naive(x, a, b_mat, c_mat, h0=None):
    """Step-by-step SSD recurrence (the test oracle), per head:

        H_t = a_t · H_{t-1} + x_t ⊗ b_t        (H_t ∈ R^{P×N}, float32)
        y_t = H_t · c_t

    x ``(B, S, H, P)``, a ``(B, S, H)``, b/c ``(B, S, H, N)``, h0 ``(B, H,
    P, N)``.  Returns ``(y in x's dtype, final state in float32)``."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    carry = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(s):
        carry = carry * a[:, t, :, None, None] + torch.einsum(
            "bhp,bhn->bhpn", x[:, t].float(), b_mat[:, t].float())
        ys.append(torch.einsum("bhpn,bhn->bhp", carry, c_mat[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), carry


def ssd_scan_ref(x, a, b_mat, c_mat, h0=None, chunk: int = 128):
    """Chunked SSD, the plain version of kernel B4 (the reference's XLA
    model path, ``repro.kernels.ref.ssd_scan_ref``): within each chunk the
    decay-masked ``(C Bᵀ) X`` product, across chunks the carried state.
    The reference combines the chunk carries with a log-depth associative
    scan; here a loop over chunks does the same sums in order.  Log-decay
    is clamped at 1e-37, as the Pallas kernel clamps it.  Same shapes and
    result as :func:`ssd_scan_naive`."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError("seq not divisible by chunk")
    nc = s // chunk
    f32 = torch.float32
    xc = x.to(f32).reshape(bsz, nc, chunk, h, p)
    ac = a.to(f32).reshape(bsz, nc, chunk, h)
    bc = b_mat.to(f32).reshape(bsz, nc, chunk, h, n)
    cc = c_mat.to(f32).reshape(bsz, nc, chunk, h, n)

    cum = torch.cumsum(torch.log(torch.clamp(ac, min=1e-37)), dim=2)
    sc = torch.einsum("bclhn,bcmhn->bchlm", cc, bc)     # (B,NC,H,L,L)
    cum_h = cum.transpose(2, 3)                         # (B,NC,H,L)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    # exp() never sees the (positive, overflowing) upper triangle
    dt_ts = torch.where(mask, cum_h[..., :, None] - cum_h[..., None, :], 0.0)
    m = torch.where(mask, torch.exp(dt_ts), 0.0)
    y = torch.einsum("bchlm,bcmhp->bclhp", sc * m, xc)  # intra-chunk
    del sc, dt_ts, m

    a_tot = torch.exp(cum[:, :, -1, :])                 # (B,NC,H)
    w = torch.exp(cum[:, :, -1:, :] - cum)              # (B,NC,L,H) <= 1
    s_c = torch.einsum("bclhp,bclhn->bchpn", xc * w[..., None], bc)
    state = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    h_prev = torch.empty_like(s_c)                      # state entering c
    for c in range(nc):
        h_prev[:, c] = state
        state = state * a_tot[:, c, :, None, None] + s_c[:, c]
    y = y + torch.einsum("bclhn,bchpn->bclhp", cc * torch.exp(cum)[..., None],
                         h_prev)                        # inter-chunk
    return y.reshape(bsz, s, h, p).to(x.dtype), state


def ssd_scan_bwd_ref(x, a, b_mat, c_mat, dy, h0=None, dstate=None,
                     chunk: int = 128):
    """The plain version of B4's backward: ``(dx, da, db, dc, dh0)`` by
    autograd through :func:`ssd_scan_ref` (what ``jax.grad`` of the
    reference's XLA scan computes) for the incoming gradients ``dy`` of y
    and ``dstate`` of the final state (``None`` is zero); ``db`` and ``dc``
    per head, ``dh0`` ``None`` without ``h0``."""
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_()
               for t in (x, a, b_mat, c_mat, h0)]
        y, state = ssd_scan_ref(*ins, chunk=chunk)
        outs, grads = [y], [dy.to(y.dtype)]
        if dstate is not None:
            outs.append(state)
            grads.append(dstate.to(state.dtype))
        want = [t for t in ins if t is not None]
        got = iter(torch.autograd.grad(outs, want, grads))
        return tuple(None if t is None else next(got) for t in ins)


# ------------------------------------------------------------- LRU scan -----
def lru_scan_naive(x, a, h0=None):
    """Step-by-step diagonal recurrence ``h_t = a_t ⊙ h_{t-1} + x_t`` in
    float32 (the test oracle).  x, a ``(B, S, D)``, h0 ``(B, D)``.  Returns
    ``(h in x's dtype, final state in float32)``."""
    bsz, s, d = x.shape
    carry = (torch.zeros((bsz, d), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    hs = []
    for t in range(s):
        carry = carry * a[:, t].float() + x[:, t].float()
        hs.append(carry)
    return torch.stack(hs, dim=1).to(x.dtype), carry


def lru_scan_ref(x, a, h0=None):
    """The diagonal recurrence in log depth, the plain version of kernel
    B5 (the reference's ``lru_scan_ref``, an associative scan): a
    Hillis-Steele doubling scan over the sequence with the combine
    ``(a_l, h_l) ∘ (a_r, h_r) = (a_l·a_r, h_l·a_r + h_r)``, h0 folded into
    the first step.  Same shapes and result as :func:`lru_scan_naive`.
    Each doubling builds new tensors rather than writing into the old
    ones, so autograd (and a checkpoint's recompute) sees every operand as
    it was read."""
    af = a.float()
    hs = x.float()
    if h0 is not None:
        hs = torch.cat([hs[:, :1] + af[:, :1] * h0.float()[:, None],
                        hs[:, 1:]], dim=1)
    shift = 1
    while shift < x.shape[1]:
        hs = torch.cat([hs[:, :shift],
                        hs[:, shift:] + af[:, shift:] * hs[:, :-shift]], dim=1)
        af = torch.cat([af[:, :shift], af[:, shift:] * af[:, :-shift]], dim=1)
        shift *= 2
    return hs.to(x.dtype), hs[:, -1].clone()
