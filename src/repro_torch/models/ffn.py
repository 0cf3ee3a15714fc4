"""Feed-forward layers, port of ``repro.models.ffn``: the gated dense MLP
(SwiGLU/GeGLU) and the plain 2-matmul MLP.  MoE waits for its slice
(ROADMAP A11)."""

from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig, activation, dense_init


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
