"""The train step on one device, port of ``repro.train.step``: loss →
``backward`` → optional int8 compression → AdamW.

The reference jits the step with FSDP × TP shardings over a mesh; the
port runs eagerly on one device (the shardings are ROADMAP A13b).  The
parameters are float32 master weights (``lm.init_params(cast=False)``)
that the model casts to the activation dtype at each use; their leaves
require grad, and the step updates them, the AdamW moments and the error
feedback in place.  Weight decay and the compression scales follow the
reference's stacked tree (:mod:`repro_torch.train.tree`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import family_of
from repro_torch.models.common import ModelConfig
from repro_torch.train.compress import compress_grads, init_ef_state
from repro_torch.train.optimizer import (
    OptimizerConfig,
    OptState,
    adamw_update,
    init_opt_state,
)
from repro_torch.train.tree import decay_mask, leaves, ref_leaves


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    ef: Any  # EFState | None


def make_train_state_shapes(cfg: ModelConfig, use_compression: bool):
    """``init(seed=0, device=None) -> TrainState``: parameters drawn from
    ``seed`` on ``device`` (CUDA unless named; ``"meta"`` gives the shapes
    a restore needs), their leaves requiring grad, zero moments and
    residuals."""
    fam = family_of(cfg)

    def init(seed: int = 0, device=None) -> TrainState:
        params = fam.init_params(cfg, seed, device)
        for p in leaves(params):
            p.requires_grad_(True)
        return TrainState(params=params, opt=init_opt_state(params),
                          ef=init_ef_state(params) if use_compression
                          else None)

    return init


def batch_on(batch: dict, device) -> dict:
    """The batch's arrays as tensors on ``device`` (integers keep their
    dtype; frames stay float32)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def loss_and_grads(cfg: ModelConfig, params, batch: dict):
    """``(loss, metrics, grads)``: the family's loss on ``batch`` and the
    gradient of every parameter leaf, in
    :func:`~repro_torch.train.tree.flatten`'s order; ``None`` marks a leaf
    the loss does not reach."""
    ps = leaves(params)
    loss, metrics = family_of(cfg).loss_fn(cfg, params, batch,
                                           device=ps[0].device)
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        list(grads)


def train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
               state: TrainState, batch: dict, decay: list[bool],
               groups: list | None = None) -> tuple[TrainState, dict]:
    """One step on ``batch`` (tensors on the parameters' device): the
    reference's metrics ``loss``, ``ce``, ``aux``, ``accuracy``,
    ``grad_norm`` and ``lr`` (0-d tensors).  ``groups`` (the compression's
    scale groups) turns the int8 compression on."""
    loss, metrics, grads = loss_and_grads(cfg, state.params, batch)
    grads = [torch.zeros_like(p, dtype=torch.float32) if g is None else g
             for p, g in zip(leaves(state.params), grads)]
    ef = state.ef
    if groups is not None:
        grads, ef = compress_grads(grads, ef, groups)
    params, opt, opt_metrics = adamw_update(opt_cfg, state.params, grads,
                                            state.opt, decay)
    return (TrainState(params=params, opt=opt, ef=ef),
            {**metrics, **opt_metrics, "loss": loss})


@dataclass
class TrainStepBundle:
    step_fn: Any              # (state, batch) -> (state, metrics)
    init_state_fn: Any        # (seed) -> TrainState on the step's device


def make_train_step(cfg: ModelConfig, device=None,
                    opt_cfg: OptimizerConfig | None = None,
                    use_compression: bool = False) -> TrainStepBundle:
    """The step on ``device`` (CUDA unless named; ``"cpu"`` for the plain
    path).  ``step_fn`` takes a batch of numpy arrays or tensors and moves
    it to the device; the weight-decay leaves and compression groups are
    derived once from the parameter tree."""
    opt_cfg = opt_cfg or OptimizerConfig()
    dev = resolve_device(device)
    init = make_train_state_shapes(cfg, use_compression)
    shapes = init(0, "meta").params
    decay = decay_mask(cfg, shapes)
    groups = ([r.members for r in ref_leaves(cfg, shapes)]
              if use_compression else None)

    def step_fn(state: TrainState, batch: dict):
        return train_step(cfg, opt_cfg, state, batch_on(batch, dev), decay,
                          groups)

    return TrainStepBundle(step_fn=step_fn,
                           init_state_fn=lambda seed=0: init(seed, dev))
