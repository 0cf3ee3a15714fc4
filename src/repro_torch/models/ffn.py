"""Feed-forward layers, port of ``repro.models.ffn``: the gated dense MLP
(SwiGLU/GeGLU), the plain 2-matmul MLP and the DeepSeek MoE.

The MoE layer is the reference's function, computed another way.  The
reference dispatches with one-hot einsums into ``(groups, experts,
capacity)`` buffers, which at deepseek-moe-16b's width would cost ~2e15
FLOP a layer for a 4 x 4,096-token prefill, nearly all of it on empty
slots.  Here the kept (token, k) pairs are sorted by expert, each expert's
gated FFN runs on its own rows, and each output row, weighted by its gate,
goes back to its (token, k) place; the K places of a token are summed.  The
reference's rounding points are kept: float32 router logits from the
activation-dtype operands, the gates renormalised in float32 and rounded to
the activation dtype before they weight the expert outputs, whose weighted
sum over k is rounded once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, activation, dense_init


# ------------------------------------------------------------ dense GLU ----
def init_mlp(cfg: ModelConfig, gen: torch.Generator, device,
             d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    w = cfg.weight_dtype
    p = {"wi_up": dense_init(gen, (d, f), d, w, device),
         "wo": dense_init(gen, (f, d), f, w, device)}
    if cfg.gated_ffn:
        p["wi_gate"] = dense_init(gen, (d, f), d, w, device)
    return p


def mlp_forward(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    act = activation(cfg.act)
    u = torch.einsum("bsd,df->bsf", x, p["wi_up"].to(dt))
    if cfg.gated_ffn:
        g = act(torch.einsum("bsd,df->bsf", x, p["wi_gate"].to(dt)))
        h = g * u
    else:
        h = act(u)
    return torch.einsum("bsf,fd->bsd", h, p["wo"].to(dt))


# ----------------------------------------------------------------- MoE -----
def init_moe(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    w = cfg.weight_dtype
    p = {"router": dense_init(gen, (d, e), d, torch.float32, device),
         "wi_gate": dense_init(gen, (e, d, f), d, w, device),
         "wi_up": dense_init(gen, (e, d, f), d, w, device),
         "wo": dense_init(gen, (e, f, d), f, w, device)}
    if m.n_shared:
        fs = m.d_ff_expert * m.n_shared
        p["shared"] = {"wi_gate": dense_init(gen, (d, fs), d, w, device),
                       "wi_up": dense_init(gen, (d, fs), d, w, device),
                       "wo": dense_init(gen, (fs, d), fs, w, device)}
    return p


#: tokens per capacity group, as in the reference: capacity and its cumsum
#: are computed within groups
GROUP_SIZE = 512


def capacity_groups(cfg: ModelConfig, b: int, s: int,
                    dropless: bool) -> tuple[int, int, int]:
    """(tokens a group, groups, capacity a group and expert), the
    reference's rule: groups of ``min(512, s)`` tokens, one group a
    sequence where those do not tile ``b·s``; dropless capacity is the
    group length (a token takes at most one slot of an expert)."""
    m = cfg.moe
    tg = min(GROUP_SIZE, s)
    if (b * s) % tg:
        tg = s
    g = (b * s) // tg
    if dropless:
        return tg, g, tg
    cap = max(1, min(tg, int(round(m.capacity_factor * tg * m.top_k
                                   / m.n_experts))))
    return tg, g, cap


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, ties to the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity_slots(cfg: ModelConfig, ids: torch.Tensor, b: int, s: int,
                   dropless: bool) -> tuple[torch.Tensor, int]:
    """``(pos (T, K), capacity)``: each (token, k) pair's position in its
    expert's buffer, counting the pairs before it in its group, token-major
    over (T·K); the pair is kept when ``pos < capacity``."""
    m = cfg.moe
    tg, g, cap = capacity_groups(cfg, b, s, dropless)
    flat = ids.reshape(g, tg * m.top_k)
    onehot = F.one_hot(flat, m.n_experts)                   # (G, Tg·K, E)
    pos = onehot.cumsum(dim=1).gather(-1, flat[..., None])[..., 0] - 1
    return pos.reshape(b * s, m.top_k), cap


def route(cfg: ModelConfig, p: dict, x: torch.Tensor, dropless: bool):
    """The router of :func:`moe_forward`: x (B, S, D) → ``(logits (T, E)
    float32, probs, gates (T, K) float32, expert ids (T, K), keep (T, K)
    or None when nothing is dropped)``, T = B·S in token order.  ``keep``
    holds the reference's capacity rule (:func:`capacity_slots`)."""
    b, s, d = x.shape
    # float32 logits from the activation-dtype operands (the reference's
    # preferred_element_type=float32); float32 products of bf16 values are
    # exact, so only the accumulation order differs
    logits = x.reshape(b * s, d).float() @ p["router"].to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    gates, ids = _top_k(probs, cfg.moe.top_k)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    if dropless:
        return logits, probs, gates, ids, None
    pos, cap = capacity_slots(cfg, ids, b, s, dropless)
    return logits, probs, gates, ids, pos < cap


def _plus_shared(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """``y`` plus the always-on shared experts' gated MLP on ``x``."""
    if not cfg.moe.n_shared:
        return y
    sp, dt, act = p["shared"], x.dtype, activation(cfg.act)
    gs = act(torch.einsum("bsd,df->bsf", x, sp["wi_gate"].to(dt)))
    us = torch.einsum("bsd,df->bsf", x, sp["wi_up"].to(dt))
    return y + torch.einsum("bsf,fd->bsd", gs * us, sp["wo"].to(dt))


def _aux_losses(cfg: ModelConfig, logits: torch.Tensor, probs: torch.Tensor,
                counts: torch.Tensor) -> dict:
    """The reference's auxiliary losses from the pre-drop routing:
    Switch-style load balance (``counts``: the pairs routed to each
    expert) and router z."""
    m = cfg.moe
    me = probs.mean(dim=0)
    ce = counts.float() / probs.shape[0]
    return {"moe_aux": m.n_experts * torch.sum(me * ce) * m.aux_loss_coef,
            "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
            * m.router_z_coef}


def moe_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                dropless: bool = False) -> tuple[torch.Tensor, dict]:
    """The reference's capacity-grouped MoE: x (B, S, D) → (y, aux losses
    ``{"moe_aux", "router_z"}``).  ``dropless=True`` (prefill, decode,
    eval) keeps every pair; training keeps each expert's first
    ``capacity`` pairs a group.

    Costs a layer: one host sync (the pairs an expert takes), plus one in
    capacity mode (the kept pairs), and about six launches for each expert
    that takes a pair.  On the ``meta`` device, which has no values to
    route by, :func:`moe_dense_dispatch` stands in (a dry-run lowering)."""
    if x.device.type == "meta":
        return moe_dense_dispatch(cfg, p, x, dropless)
    m = cfg.moe
    dt = x.dtype
    b, s, d = x.shape
    k, n_tok = m.top_k, b * s
    logits, probs, gates, ids, keep = route(cfg, p, x, dropless)

    flat_e = ids.reshape(-1)                        # (T·K) token-major
    pairs = (torch.arange(n_tok * k, device=x.device) if keep is None
             else keep.reshape(-1).nonzero()[:, 0])
    pairs = pairs[torch.argsort(flat_e[pairs], stable=True)]
    counts = torch.bincount(flat_e[pairs], minlength=m.n_experts).tolist()
    rows = x.reshape(n_tok, d)[pairs // k]
    out = torch.empty_like(rows)
    act = activation(cfg.act)
    start = 0
    for e, n in enumerate(counts):
        if n:
            xe = rows[start:start + n]
            h = act(xe @ p["wi_gate"][e].to(dt)) * (xe @ p["wi_up"][e].to(dt))
            out[start:start + n] = h @ p["wo"][e].to(dt)
            start += n
    # combine: gate rounded to the activation dtype times the expert row
    # (exact in float32), summed over k in float32, rounded once
    w = gates.reshape(-1)[pairs].to(dt).float()
    placed = torch.zeros((n_tok * k, d), dtype=torch.float32,
                         device=x.device)
    placed[pairs] = w[:, None] * out.float()
    y = placed.view(n_tok, k, d).sum(dim=1).to(dt).view(b, s, d)
    routed = torch.bincount(flat_e, minlength=m.n_experts)
    return _plus_shared(cfg, p, x, y), _aux_losses(cfg, logits, probs,
                                                   routed)


def moe_dense_dispatch(cfg: ModelConfig, p: dict, x: torch.Tensor,
                       dropless: bool = False) -> tuple[torch.Tensor, dict]:
    """The reference's GShard dispatch as written: one-hot ``(G, T, E, C)``
    dispatch and combine tensors, the experts run on every capacity slot.
    This is the work the reference lowers; the dry-run's lowering on the
    ``meta`` device takes it (shapes and FLOPs only: nothing here reads a
    value on the host).  The routing, shared experts and aux losses are
    :func:`moe_forward`'s; only the dispatch differs."""
    m = cfg.moe
    dt = x.dtype
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    logits, probs, gates, ids, _ = route(cfg, p, x, dropless=True)
    pos, cap = capacity_slots(cfg, ids, b, s, dropless)
    tg, g, _ = capacity_groups(cfg, b, s, dropless)
    xg = x.reshape(g, tg, d)
    ids_g, pos_g, gates_g = (t.reshape(g, tg, k) for t in (ids, pos, gates))
    keep = pos_g < cap
    dispatch = combine = None
    for kk in range(k):
        oe = F.one_hot(ids_g[..., kk], e).to(dt)
        oc = F.one_hot(pos_g[..., kk].clamp(0, cap - 1), cap).to(dt)
        term = (oe[..., :, None] * oc[..., None, :]
                * keep[..., kk, None, None].to(dt))             # (G,T,E,C)
        dispatch = term if dispatch is None else dispatch + term
        cterm = term * gates_g[..., kk, None, None].to(dt)
        combine = cterm if combine is None else combine + cterm
    x_e = torch.einsum("gtec,gtd->gecd", dispatch, xg)
    act = activation(cfg.act)
    h_g = act(torch.einsum("gecd,edf->gecf", x_e, p["wi_gate"].to(dt)))
    h_u = torch.einsum("gecd,edf->gecf", x_e, p["wi_up"].to(dt))
    y_e = torch.einsum("gecf,efd->gecd", h_g * h_u, p["wo"].to(dt))
    y = torch.einsum("gtec,gecd->gtd", combine, y_e).reshape(b, s, d)
    routed = F.one_hot(ids, e).sum(dim=(0, 1))
    return _plus_shared(cfg, p, x, y), _aux_losses(cfg, logits, probs,
                                                   routed)
