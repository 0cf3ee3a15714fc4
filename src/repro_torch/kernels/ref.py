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


def ssd_scan_bwd_chunked_ref(x, a, b_mat, c_mat, dy, h0=None, dstate=None,
                             chunk: int = 64):
    """The chunked backward of B4 in plain torch, with the rounding points
    of its chunked kernel (``csrc/ssd_scan_bwd_chunked.cu``): ``(dx, da,
    db, dc, dh0)`` as :func:`ssd_scan_bwd_ref` returns them.  Chunks of
    ``chunk`` steps (a ragged tail padded with x = dy = b = c = 0 and decay
    1), cum in log2, per chunk the local states ``V = (X⊙w)ᵀB`` and ``U =
    (dY⊙2^cum)ᵀC``, a pass over the chunks for the state entering each
    (``H_prev``) and the gradient of the one leaving it (``G``), then the
    chunk-local products; for bf16 inputs the operands the kernel rounds
    to bf16 are rounded here (X⊙w, dY⊙2^cum, ``H_prev``, ``G``, S⊙M and
    dS⊙M), everything else stays float32.  The gradient of log a' is the
    reverse prefix sum of ``dcum`` within each chunk, and ``da`` is 0 where
    the forward clamped the decay."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    f32 = torch.float32
    if x.dtype == torch.bfloat16:
        def rnd(t):
            return t.to(torch.bfloat16).to(f32)
    else:
        def rnd(t):
            return t
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunks(t, value=0.0):
        """(B, S, H, ...) -> (B, NC, H, L, ...) in float32, padded."""
        t = t.to(f32)
        t = torch.cat([t, t.new_full((bsz, pad) + t.shape[2:], value)], 1)
        t = t.reshape((bsz, nc, chunk) + t.shape[2:])
        return t.transpose(2, 3)

    xc, dyc, bc, cc = (chunks(t) for t in (x, dy, b_mat, c_mat))
    ac = chunks(a, 1.0)                                   # (B, NC, H, L)
    cum = torch.cumsum(torch.log2(torch.clamp(ac, min=1e-37)), dim=-1)
    last = cum[..., -1:]
    w = torch.exp2(last - cum)                            # <= 1
    e = torch.exp2(cum)
    decay = torch.exp2(last)[..., None]                   # (B, NC, H, 1, 1)
    # the chunks' local states, then the pass over the chunks
    v = rnd(xc * w[..., None]).transpose(-1, -2) @ bc     # (B, NC, H, P, N)
    u = rnd(dyc * e[..., None]).transpose(-1, -2) @ cc
    state = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    h_prev = torch.empty_like(v)
    for c in range(nc):
        h_prev[:, c] = state
        state = decay[:, c] * state + v[:, c]
    g_state = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
               if dstate is None else dstate.to(f32))
    g = torch.empty_like(u)
    for c in reversed(range(nc)):
        g[:, c] = g_state
        g_state = decay[:, c] * g_state + u[:, c]
    h_prev, g = rnd(h_prev), rnd(g)
    # the chunk-local products: rows t, columns s
    below = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=x.device))
    m = torch.exp2(torch.where(below, cum[..., :, None] - cum[..., None, :],
                               -torch.inf))
    sm = (cc @ bc.transpose(-1, -2)) * m                  # S⊙M
    ds = dyc @ xc.transpose(-1, -2)
    q = sm * ds
    dsm = ds * m
    bg = bc @ g.transpose(-1, -2)                         # (…, L, P)
    dx = rnd(sm).transpose(-1, -2) @ dyc + w[..., None] * bg
    db = rnd(dsm).transpose(-1, -2) @ cc + rnd(xc * w[..., None]) @ g
    inter = e[..., None] * (dyc @ h_prev)
    dc = rnd(dsm) @ bc + inter
    r = w * (xc * bg).sum(-1)
    dcum = q.sum(-1) - q.sum(-2) + (cc * inter).sum(-1) - r
    dcum[..., -1] += r.sum(-1) + torch.exp2(last[..., 0]) * (
        g * h_prev).sum((-1, -2))
    dlog = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    da = torch.where(ac >= 1e-37, dlog / ac, 0.0)

    def back(t):
        """(B, NC, H, L, ...) -> (B, S, H, ...) in x's dtype."""
        t = t.transpose(2, 3).reshape((bsz, nc * chunk) + t.shape[2:3]
                                      + t.shape[4:])
        return t[:, :s].to(x.dtype)

    dh0 = None if h0 is None else g_state.to(h0.dtype)
    return back(dx), back(da), back(db), back(dc), dh0


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


def lru_scan_bwd_ref(x, a, dy, h0=None, dhT=None):
    """The plain version of B5's backward: the explicit reverse recurrence
    in float32 for ``h_t = a_t·h_{t-1} + x_t`` (what ``jax.vjp`` of the
    reference's ``lru_scan_ref`` computes): ``g_{S-1} = dy_{S-1} + dhT``,
    ``g_t = dy_t + a_{t+1}·g_{t+1}``, ``dx_t = g_t``, ``da_t =
    g_t·h_{t-1}`` (h from :func:`lru_scan_ref` in float32, h_{-1} = h0 or
    zeros), ``dh0 = a_0·g_0``.  x, a, dy ``(B, S, D)``; h0, dhT ``(B, D)``
    or None (zeros).  Returns ``(dx, da, dh0)``: dx and da in x's and a's
    dtype, dh0 in h0's (None without h0)."""
    bsz, s, d = x.shape
    af = a.float()
    hs = lru_scan_ref(x.float(), af, h0)[0]
    start = (torch.zeros((bsz, d), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    h_prev = torch.cat([start[:, None], hs[:, :-1]], dim=1)
    carry = (torch.zeros_like(start) if dhT is None else dhT.float())
    dyf = dy.float()
    g = torch.empty_like(hs)
    for t in reversed(range(s)):
        g[:, t] = dyf[:, t] + carry
        carry = af[:, t] * g[:, t]
    dh0 = None if h0 is None else carry.to(h0.dtype)
    return g.to(x.dtype), (g * h_prev).to(a.dtype), dh0


def _fma32(a, b, c):
    """``a·b + c`` rounded once to float32, as the kernels' ``fmaf``: the
    product is exact in float64 and the sum rounds there first (a double
    rounding that differs from ``fmaf`` only on the rarest ties)."""
    return (a.double() * b.double() + c.double()).float()


def _lru_chunks(t, chunk, sub, pad):
    """(B, S, D) -> float32 (B, NC, J, M, D): chunks of ``chunk`` steps cut
    into ``chunk // sub`` sub-chunks of ``sub``, the ragged tail at
    ``pad`` (an identity step: x = dy = 0, a = 1)."""
    bsz, s, d = t.shape
    nc = -(-s // chunk)
    t = t.float()
    if nc * chunk > s:
        t = torch.cat([t, t.new_full((bsz, nc * chunk - s, d), pad)], 1)
    return t.reshape(bsz, nc, chunk // sub, sub, d)


def _lru_prefix(a_sub, h_sub):
    """Exclusive prefixes of sub-chunk summaries ``(Π a, end state from
    zero)`` (B, NC, J, D), folded in sub-chunk order as the kernels' fold
    thread does, and the chunk's totals (B, NC, D)."""
    a_pre, h_pre = torch.empty_like(a_sub), torch.empty_like(h_sub)
    a_tot = torch.ones_like(a_sub[:, :, 0])
    h_tot = torch.zeros_like(h_sub[:, :, 0])
    for i in range(a_sub.shape[2]):
        a_pre[:, :, i], h_pre[:, :, i] = a_tot, h_tot
        h_tot = _fma32(a_sub[:, :, i], h_tot, h_sub[:, :, i])
        a_tot = a_tot * a_sub[:, :, i]
    return a_pre, h_pre, a_tot, h_tot


def _lru_summaries(xc, ac):
    """A sub-chunk's ``(Π a, end state from zero)`` step by step, as a
    thread of the kernels sums it up."""
    a_sub = torch.ones_like(xc[:, :, :, 0])
    h_sub = torch.zeros_like(a_sub)
    for u in range(xc.shape[3]):
        h_sub = _fma32(ac[:, :, :, u], h_sub, xc[:, :, :, u])
        a_sub = a_sub * ac[:, :, :, u]
    return a_sub, h_sub


def lru_scan_chunked_ref(x, a, h0=None, chunk: int = 128, sub: int = 8,
                         return_starts: bool = False):
    """B5's chunked form in plain torch, with the kernel's chunks, carry
    order and rounding points (``csrc/lru_chunked.cuh``): sub-chunks of
    ``sub`` steps summed up as ``(Π a, end state from zero)``, folded in
    order within each chunk of ``chunk`` steps (exclusive prefixes), the
    chunks joined in order from h0 (``start[c] = A[c-1]·start[c-1] +
    H[c-1]``), then every sub-chunk run again from its true start; each
    ``fmaf`` of the kernel rounded once (:func:`_fma32`), y rounded once to
    x's dtype.  Returns ``(y, final state float32)`` and, with
    ``return_starts``, the float32 chunk starts ``(B, ⌈S/chunk⌉, D)`` the
    kernel keeps for the backward."""
    bsz, s, d = x.shape
    xc = _lru_chunks(x, chunk, sub, 0.0)
    ac = _lru_chunks(a, chunk, sub, 1.0)
    a_pre, h_pre, a_tot, h_tot = _lru_prefix(*_lru_summaries(xc, ac))
    h = (torch.zeros((bsz, d), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    starts = torch.empty_like(a_tot)
    for c in range(starts.shape[1]):
        starts[:, c] = h
        h = _fma32(a_tot[:, c], h, h_tot[:, c])
    hs = _fma32(a_pre, starts[:, :, None], h_pre)
    ys = torch.empty_like(xc)
    for u in range(sub):
        hs = _fma32(ac[:, :, :, u], hs, xc[:, :, :, u])
        ys[:, :, :, u] = hs
    y = ys.reshape(bsz, -1, d)[:, :s].to(x.dtype)
    return (y, h, starts) if return_starts else (y, h)


def lru_scan_bwd_chunked_ref(x, a, dy, h0=None, dhT=None, starts=None,
                             chunk: int = 128, sub: int = 4):
    """B5's backward in its chunked form in plain torch, with the kernel's
    chunks, carry order and rounding points (``csrc/lru_scan_bwd.cu``):
    ``(dx, da, dh0)`` as :func:`lru_scan_bwd_ref` returns them.  The state
    from the chunk starts (``starts``, or :func:`lru_scan_chunked_ref`'s
    when None) through each chunk's exclusive prefixes; the carry ``q``
    (``g_t = dy_t + q``, ``q ← a_t·g_t``, dhT entering the last step)
    summed up per sub-chunk from a zero carry, folded right to left within a
    chunk and joined from the last chunk down; then each sub-chunk rebuilds
    its ``h_{t-1}`` forward and runs g back.  Its sub-chunks are ``sub``
    steps (the backward kernel's 4); rebuilt starts come from the forward's
    own sub-chunks."""
    bsz, s, d = x.shape
    if starts is None:
        starts = lru_scan_chunked_ref(x, a, h0, chunk,
                                      return_starts=True)[2]
    xc = _lru_chunks(x, chunk, sub, 0.0)
    ac = _lru_chunks(a, chunk, sub, 1.0)
    gc = _lru_chunks(dy, chunk, sub, 0.0)
    a_sub, h_sub = _lru_summaries(xc, ac)
    g_sub = torch.zeros_like(a_sub)
    for u in reversed(range(sub)):
        g_sub = ac[:, :, :, u] * (gc[:, :, :, u] + g_sub)
    # right to left: the carry entering each sub-chunk from a zero chunk
    # carry, and the product of a right of it
    p_suf, g_suf = torch.empty_like(a_sub), torch.empty_like(g_sub)
    p_tot = torch.ones_like(a_sub[:, :, 0])
    q_tot = torch.zeros_like(p_tot)
    for i in reversed(range(a_sub.shape[2])):
        p_suf[:, :, i], g_suf[:, :, i] = p_tot, q_tot
        q_tot = _fma32(a_sub[:, :, i], q_tot, g_sub[:, :, i])
        p_tot = p_tot * a_sub[:, :, i]
    a_pre, h_pre, _, _ = _lru_prefix(a_sub, h_sub)
    q = (torch.zeros((bsz, d), dtype=torch.float32, device=x.device)
         if dhT is None else dhT.float())
    q_in = torch.empty_like(p_tot)
    for c in reversed(range(q_in.shape[1])):
        q_in[:, c] = q
        q = _fma32(p_tot[:, c], q, q_tot[:, c])
    h = _fma32(a_pre, starts.float()[:, :, None], h_pre)
    qs = _fma32(p_suf, q_in[:, :, None], g_suf)
    h_prev = torch.empty_like(xc)
    for u in range(sub):
        h_prev[:, :, :, u] = h
        h = _fma32(ac[:, :, :, u], h, xc[:, :, :, u])
    dx, da = torch.empty_like(xc), torch.empty_like(xc)
    for u in reversed(range(sub)):
        g = gc[:, :, :, u] + qs
        dx[:, :, :, u] = g
        da[:, :, :, u] = g * h_prev[:, :, :, u]
        qs = ac[:, :, :, u] * g

    def back(t):
        return t.reshape(bsz, -1, d)[:, :s].to(x.dtype)
    dh0 = None if h0 is None else q.to(h0.dtype)
    return back(dx), back(da), dh0
