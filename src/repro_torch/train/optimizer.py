"""AdamW with a cosine schedule and global-norm clipping, port of
``repro.train.optimizer``.

The state mirrors the parameter tree (``mu``, ``nu`` float32, ``step`` a
0-d int32 tensor).  The schedule, the bias corrections and every update
are float32 tensor arithmetic in the reference's order.  The port updates
the parameters, the moments and the gradients **in place** (the reference
returns new trees): at qwen2.5-3b's width a second copy of any of them is
12.4 GB.

Decoupled weight decay acts where the reference's ``p.ndim >= 2`` does on
the reference's tree, whose scanned layers are stacked: the caller passes
``decay=train.tree.decay_mask(cfg, params)``, which is the one place the
rule is kept; there is no default.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.sharding import collectives
from repro_torch.train.tree import leaves, tree_map


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor   # () int32


def _recip(n: int) -> float:
    """``1 / n`` rounded to float32: the reference's schedule runs jitted,
    and XLA turns a division by a constant into a product with its
    reciprocal."""
    return float(np.float32(1 / n))


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step``: linear warm-up, then cosine decay to
    ``min_lr_frac`` of ``lr``, in float32."""
    step = step.to(torch.float32)
    warm = cfg.lr * step * _recip(max(cfg.warmup_steps, 1))
    prog = torch.clamp((step - cfg.warmup_steps)
                       * _recip(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0, 1)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5
                    * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(grads: list, group=None,
                sharded: list[bool] | None = None) -> torch.Tensor:
    """The norm of all of ``grads``.  On a rank mesh (``group``, the data
    axis's), each leaf flagged in ``sharded`` is this rank's block, so its
    squared sum is summed over the ranks; the others are whole on every
    rank and count once.  The squares are added in leaf order either way
    (one rank gives the bits one process does)."""
    sq = [torch.sum(torch.square(g.float())) for g in grads]
    if group is not None:
        idx = [i for i, s in enumerate(sharded) if s]
        if idx:
            summed = collectives.all_reduce_sum(
                torch.stack([sq[i] for i in idx]), group)
            for i, v in zip(idx, summed.unbind(0)):
                sq[i] = v
    return torch.sqrt(sum(sq))


def clip_by_global_norm(grads: list, max_norm: float, group=None,
                        sharded: list[bool] | None = None) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns the norm before clipping (``group``, ``sharded``: as for
    :func:`global_norm`)."""
    norm = global_norm(grads, group, sharded)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads:
        g.mul_(scale)
    return norm


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads: list[torch.Tensor],
                 state: OptState, decay: list[bool], group=None,
                 sharded: list[bool] | None = None):
    """One AdamW step: ``grads`` (a list in
    :func:`~repro_torch.train.tree.flatten`'s order of ``params``) clipped,
    then every leaf updated, the leaves flagged in ``decay`` (same order;
    :func:`~repro_torch.train.tree.decay_mask`) with weight decay.  Updates
    ``params``, ``state.mu``/``nu`` and ``grads`` in place and returns
    ``(params, new state, {"grad_norm", "lr"})``.  On a rank mesh the
    leaves are this rank's blocks where ``sharded`` flags them, and the
    clipping norm is the whole model's (:func:`global_norm`)."""
    ps, ms, vs = leaves(params), leaves(state.mu), leaves(state.nu)
    if not len(grads) == len(decay) == len(ps):
        raise ValueError(f"{len(ps)} parameter leaves, {len(grads)} "
                         f"gradients and {len(decay)} decay flags")
    gnorm = clip_by_global_norm(grads, cfg.clip_norm, group, sharded)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    for p, g, m, v, dec in zip(ps, grads, ms, vs, decay):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if dec:  # decoupled weight decay
            delta += cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, OptState(mu=state.mu, nu=state.nu, step=step), {
        "grad_norm": gnorm, "lr": lr}
