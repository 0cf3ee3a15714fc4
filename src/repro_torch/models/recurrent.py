"""Recurrent mixers, port of ``repro.models.recurrent``: mamba2 (SSD) and
RG-LRU (RecurrentGemma / Griffin).

Both keep O(1) decode state.  Sequence mixing in prefill and forward goes
through :mod:`repro_torch.kernels.ops` (``ssd_scan``: kernel B4,
``lru_scan``: kernel B5 on the card); the single-token decode steps are
plain torch, as in the reference.  The casts follow the reference's one for
one: which products run in float32 and where results are rounded to the
activation dtype.

Decode state per layer:

* mamba2  — conv buffer (d_conv−1, conv_dim) + SSD state (H, P, N) f32;
* RG-LRU  — conv buffer (d_conv−1, D_rnn) + diagonal state (D_rnn,) f32.

The decode steps return new states; nothing is updated in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, dense_init, rms_norm


# ---------------------------------------------------------------- conv1d ---
def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 prefix: torch.Tensor | None = None):
    """Depthwise causal conv in x's dtype; x (B, S, C), w (K, C), optional
    prefix (B, K-1, C) carried from a previous chunk.  Returns
    (y, new_prefix); the prefix is a copy, since a view would keep the
    whole (B, S+K-1, C) buffer alive in the layer's cache."""
    kk = w.shape[0]
    if prefix is None:
        prefix = torch.zeros((x.shape[0], kk - 1, x.shape[2]), dtype=x.dtype,
                             device=x.device)
    xp = torch.cat([prefix, x], dim=1)
    y = sum(xp[:, i: i + x.shape[1], :] * w[i][None, None, :]
            for i in range(kk))
    return y.to(x.dtype), xp[:, -(kk - 1):, :].clone()


def _silu32(z: torch.Tensor) -> torch.Tensor:
    return F.silu(z.float())


# ================================================================ mamba2 ===
class SSMState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, conv_dim)
    ssd: torch.Tensor   # (B, H, P, N) f32


def _mamba2_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.headdim, d_inner + 2 * s.d_state


def init_mamba2(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, conv_dim = _mamba2_dims(cfg)
    w = cfg.weight_dtype
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # order: [z | x | B | C | dt]
        "in_proj": dense_init(gen, (d, 2 * d_inner + 2 * s.d_state + n_heads),
                              d, w, device),
        "conv_w": dense_init(gen, (s.d_conv, conv_dim), s.d_conv, w, device),
        "conv_b": torch.zeros((conv_dim,), dtype=w, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, n_heads, **f32)),
        "dt_bias": torch.zeros((n_heads,), **f32),
        "d_skip": torch.ones((n_heads,), **f32),
        "out_norm": torch.zeros((d_inner,), dtype=w, device=device),
        "out_proj": dense_init(gen, (d_inner, d), d_inner, w, device),
    }


def _mamba2_split(cfg: ModelConfig, p: dict, x: torch.Tensor):
    s = cfg.ssm
    d_inner, n_heads, _ = _mamba2_dims(cfg)
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"].to(x.dtype))
    z, xin, b_c, dt = torch.split(
        zxbcdt, [d_inner, d_inner, 2 * s.d_state, n_heads], dim=-1)
    return z, xin, b_c, dt, d_inner, n_heads


def _mamba2_out(cfg: ModelConfig, p: dict, y: torch.Tensor, z: torch.Tensor,
                dt) -> torch.Tensor:
    """Gate by silu(z), normalise, project out (shared by both modes)."""
    y = rms_norm(y * _silu32(z).to(dt), p["out_norm"], cfg.norm_eps)
    return torch.einsum("bse,ed->bsd", y, p["out_proj"].to(dt))


def mamba2_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                   *, make_cache: bool = False
                   ) -> tuple[torch.Tensor, SSMState | None]:
    s = cfg.ssm
    bsz, sl, _ = x.shape
    z, xin, b_c, dt, d_inner, n_heads = _mamba2_split(cfg, p, x)
    conv_in = torch.cat([xin, b_c], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, p["conv_w"].to(x.dtype))
    conv_out = F.silu(conv_out + p["conv_b"].to(x.dtype))
    xin, b_mat, c_mat = torch.split(conv_out, [d_inner, s.d_state, s.d_state],
                                    dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                    # (B,S,H)
    a = torch.exp(-dt * torch.exp(p["a_log"]))                    # decay ∈(0,1)
    xh = xin.reshape(bsz, sl, n_heads, s.headdim)
    xd = (xh.float() * dt[..., None]).to(x.dtype)
    # b and c are shared by the heads: broadcast views, never copied
    bh = b_mat[:, :, None, :].expand(bsz, sl, n_heads, s.d_state)
    ch = c_mat[:, :, None, :].expand(bsz, sl, n_heads, s.d_state)
    y, ssd_state = ops.ssd_scan(xd, a.to(x.dtype), bh, ch, chunk=s.chunk,
                                impl=cfg.attn_impl)
    y = y.float() + xh.float() * p["d_skip"][..., None]
    y = y.reshape(bsz, sl, d_inner).to(x.dtype)
    out = _mamba2_out(cfg, p, y, z, x.dtype)
    cache = SSMState(conv=conv_state, ssd=ssd_state) if make_cache else None
    return out, cache


def mamba2_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  state: SSMState) -> tuple[torch.Tensor, SSMState]:
    """Single-token step: roll the conv buffer, one SSD recurrence update,
    both in float32."""
    s = cfg.ssm
    bsz = x.shape[0]
    z, xin, b_c, dt, d_inner, n_heads = _mamba2_split(cfg, p, x)
    conv_in = torch.cat([xin, b_c], dim=-1)                   # (B, 1, C)
    window = torch.cat([state.conv, conv_in], dim=1)          # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            p["conv_w"].float())
    conv_out = F.silu(conv_out + p["conv_b"].float())
    conv_out = conv_out[:, None, :].to(x.dtype)
    xin, b_mat, c_mat = torch.split(conv_out, [d_inner, s.d_state, s.d_state],
                                    dim=-1)
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])             # (B,H)
    a = torch.exp(-dtv * torch.exp(p["a_log"]))                   # (B,H)
    xh = xin[:, 0].reshape(bsz, n_heads, s.headdim).float()
    bt = b_mat[:, 0].float()                                      # (B,N)
    ct = c_mat[:, 0].float()
    h = (state.ssd * a[..., None, None]
         + torch.einsum("bhp,bn->bhpn", xh * dtv[..., None], bt))
    y = torch.einsum("bhpn,bn->bhp", h, ct) + xh * p["d_skip"][..., None]
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    out = _mamba2_out(cfg, p, y, z, x.dtype)
    return out, SSMState(conv=window[:, 1:, :], ssd=h)


def init_ssm_state(cfg: ModelConfig, batch: int, device) -> SSMState:
    s = cfg.ssm
    _, n_heads, conv_dim = _mamba2_dims(cfg)
    return SSMState(
        conv=torch.zeros((batch, s.d_conv - 1, conv_dim),
                         dtype=cfg.activation_dtype, device=device),
        ssd=torch.zeros((batch, n_heads, s.headdim, s.d_state),
                        dtype=torch.float32, device=device),
    )


# ================================================================ RG-LRU ===
class LRUState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, D_rnn)
    h: torch.Tensor     # (B, D_rnn) f32


def init_rglru(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    r = cfg.rglru
    d = cfg.d_model
    d_rnn = r.d_rnn or d
    w = cfg.weight_dtype
    return {
        "w_x": dense_init(gen, (d, d_rnn), d, w, device),
        "w_gate": dense_init(gen, (d, d_rnn), d, w, device),
        "conv_w": dense_init(gen, (r.d_conv, d_rnn), r.d_conv, w, device),
        "conv_b": torch.zeros((d_rnn,), dtype=w, device=device),
        "w_input_gate": dense_init(gen, (d_rnn, d_rnn), d_rnn, w, device),
        "w_rec_gate": dense_init(gen, (d_rnn, d_rnn), d_rnn, w, device),
        # sigmoid(2) ≈ 0.88 base decay
        "lam": torch.full((d_rnn,), 2.0, dtype=torch.float32, device=device),
        "w_out": dense_init(gen, (d_rnn, d), d_rnn, w, device),
    }


def _rglru_gates(cfg: ModelConfig, p: dict, u: torch.Tensor):
    """u (B, S, D_rnn) → (decay a, gated input), both float32."""
    r = cfg.rglru
    uf = u.float()
    rt = torch.sigmoid(torch.einsum("bse,ef->bsf", uf,
                                    p["w_rec_gate"].float()))
    it = torch.sigmoid(torch.einsum("bse,ef->bsf", uf,
                                    p["w_input_gate"].float()))
    log_a = r.c * rt * F.logsigmoid(p["lam"])            # (B,S,D_rnn) ≤ 0
    a = torch.exp(log_a)
    # Griffin's normaliser keeps the state variance bounded
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, beta * it * uf


def _gelu32(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float(), approximate="tanh")


def rglru_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  *, make_cache: bool = False
                  ) -> tuple[torch.Tensor, LRUState | None]:
    xg = torch.einsum("bsd,de->bse", x, p["w_gate"].to(x.dtype))
    u = torch.einsum("bsd,de->bse", x, p["w_x"].to(x.dtype))
    u, conv_state = _causal_conv(u, p["conv_w"].to(x.dtype))
    u = u + p["conv_b"].to(x.dtype)
    a, gated = _rglru_gates(cfg, p, u)
    h, h_t = ops.lru_scan(gated.to(x.dtype), a.to(x.dtype),
                          impl=cfg.attn_impl)
    y = h.float() * _gelu32(xg)
    out = torch.einsum("bse,ed->bsd", y.to(x.dtype), p["w_out"].to(x.dtype))
    cache = LRUState(conv=conv_state, h=h_t) if make_cache else None
    return out, cache


def rglru_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 state: LRUState) -> tuple[torch.Tensor, LRUState]:
    xg = torch.einsum("bsd,de->bse", x, p["w_gate"].to(x.dtype))
    u = torch.einsum("bsd,de->bse", x, p["w_x"].to(x.dtype))
    window = torch.cat([state.conv, u], dim=1)
    u = (torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float())
         + p["conv_b"].float())[:, None, :]
    a, gated = _rglru_gates(cfg, p, u)
    h = a[:, 0] * state.h + gated[:, 0]
    y = h[:, None, :] * _gelu32(xg)
    out = torch.einsum("bse,ed->bsd", y.to(x.dtype), p["w_out"].to(x.dtype))
    return out, LRUState(conv=window[:, 1:, :].to(state.conv.dtype), h=h)


def init_lru_state(cfg: ModelConfig, batch: int, device) -> LRUState:
    r = cfg.rglru
    d_rnn = r.d_rnn or cfg.d_model
    return LRUState(
        conv=torch.zeros((batch, r.d_conv - 1, d_rnn),
                         dtype=cfg.activation_dtype, device=device),
        h=torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
    )
