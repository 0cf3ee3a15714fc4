"""The train step, port of ``repro.train.step``: loss → ``backward`` →
optional int8 compression → AdamW.

The reference jits the step with FSDP × TP shardings over a mesh; the
port runs eagerly, on one device or on a **rank mesh** (one process a
device over ``torch.distributed``, :func:`repro_torch.launch.mesh.
make_rank_mesh`) along its ``data`` axis.  There each rank holds its
contiguous block of every leaf the sharding rules shard over ``data``
(:func:`state_specs`, :func:`~repro_torch.sharding.rules.local_shard`;
the moments and the error feedback as their parameter) and takes its own
rows of the batch; the model's ``fsdp_use`` hooks all-gather each layer's
blocks at their use and reduce-scatter their gradients, the leaves whose
spec has no ``data`` have their gradients all-reduced after the
backward, and the statistics over the batch (the CE's token count, the
MoE router's means, the clipping norm, the compression scales) are
summed or maximised over the ranks.  Tensor parallelism over ``model``
is ROADMAP A9-shard-multi's TP part.  The parameters are float32 master
weights (``lm.init_params(cast=False)``) that the model casts to the
activation dtype at each use; their leaves require grad, and the step
updates them, the AdamW moments and the error feedback in place.  Weight
decay and the compression scales follow the reference's stacked tree
(:mod:`repro_torch.train.tree`).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import family_of
from repro_torch.models.common import ModelConfig
from repro_torch.sharding import collectives
from repro_torch.sharding import context as sharding_ctx
from repro_torch.sharding.rules import (
    P,
    fsdp_dim,
    local_shard,
    param_shardings,
)
from repro_torch.train.compress import (
    EFState,
    compress_grads,
    init_ef_state,
)
from repro_torch.train.optimizer import (
    OptimizerConfig,
    OptState,
    adamw_update,
    init_opt_state,
)
from repro_torch.train.tree import (
    decay_mask,
    leaves,
    ref_leaves,
    spec_list,
    tree_map,
)


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


def state_specs(state: TrainState, mesh) -> TrainState:
    """The train state's specs: params, both moments and the error feedback
    as the parameters, the step count replicated."""
    ps = param_shardings(state.params, mesh)
    return TrainState(params=ps, opt=OptState(mu=ps, nu=ps, step=P()),
                      ef=None if state.ef is None else EFState(ps))


class RankLayout(NamedTuple):
    """A train state laid out over a rank mesh: the mesh, the spec of every
    state leaf (:func:`state_specs` at the mesh's ``rules_mesh``) and the
    parameters' specs in flatten order."""

    mesh: Any
    specs: TrainState
    param_specs: list

    @classmethod
    def of(cls, shapes: TrainState, mesh) -> "RankLayout":
        """The layout of a state of ``shapes`` (whole leaves, e.g. on the
        ``meta`` device) on ``mesh``."""
        specs = state_specs(shapes, mesh.rules_mesh)
        return cls(mesh, specs, spec_list(specs.params, shapes.params))

    @property
    def sharded(self) -> list[bool]:
        """Which parameter leaves a rank holds a block of."""
        return [fsdp_dim(s) is not None for s in self.param_specs]

    def shard(self, state: TrainState) -> TrainState:
        """This rank's blocks of a whole state; a leaf that requires grad
        keeps requiring it."""
        def cut(leaf, spec):
            block = local_shard(leaf.detach(), spec, self.mesh)
            return block.requires_grad_(leaf.requires_grad)
        return tree_map(cut, state, self.specs)

    def reduce_replicated(self, grads: list) -> list:
        """The gradients of the leaves whose spec has no ``data``, summed
        over the ranks in one all-reduce (the others arrive reduce-scattered
        from their gathers)."""
        idx = [i for i, s in enumerate(self.sharded) if not s]
        if not idx:
            return grads
        flat = collectives.all_reduce_sum(
            torch.cat([grads[i].reshape(-1) for i in idx]), self.mesh.group)
        out = list(grads)
        for i, part in zip(idx, flat.split([grads[i].numel()
                                            for i in idx])):
            # a tensor of its own: a reduction over a view at another
            # alignment may vectorise, and so round, otherwise
            out[i] = part.view_as(grads[i]).clone()
        return out


def batch_on(batch: dict, device) -> dict:
    """The batch's arrays as tensors on ``device`` (integers keep their
    dtype; frames stay float32)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def loss_and_grads(cfg: ModelConfig, params, batch: dict,
                   layout: RankLayout | None = None):
    """``(loss, metrics, grads)``: the family's loss on ``batch`` and the
    gradient of every parameter leaf, in
    :func:`~repro_torch.train.tree.flatten`'s order; ``None`` marks a leaf
    the loss does not reach.  With a ``layout``, ``params`` are this rank's
    blocks and ``batch`` its rows: the loss and metrics are the whole
    batch's and the gradients this rank's blocks of the whole gradient
    (the replicated leaves' whole, summed over the ranks)."""
    ps = leaves(params)
    with (_on_ranks(layout, ps) if layout is not None
          else contextlib.nullcontext()):
        loss, metrics = family_of(cfg).loss_fn(cfg, params, batch,
                                               device=ps[0].device)
        # each gradient contiguous: a sum over a transposed one (a tied
        # embedding's, from the unembedding) adds in another order, so
        # the clipping norm would depend on how the gradient was laid out
        grads = [None if g is None else g.contiguous() for g in
                 torch.autograd.grad(loss, ps, allow_unused=True)]
    if layout is not None:
        grads = layout.reduce_replicated(
            [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)])
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        grads


@contextlib.contextmanager
def _on_ranks(layout: RankLayout, ps: list):
    with sharding_ctx.use_mesh(layout.mesh), \
            sharding_ctx.use_blocks(ps, layout.param_specs):
        yield


def train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
               state: TrainState, batch: dict, decay: list[bool],
               groups: list | None = None,
               layout: RankLayout | None = None) -> tuple[TrainState, dict]:
    """One step on ``batch`` (tensors on the parameters' device): the
    reference's metrics ``loss``, ``ce``, ``aux``, ``accuracy``,
    ``grad_norm`` and ``lr`` (0-d tensors).  ``groups`` (the compression's
    scale groups) turns the int8 compression on.  With a ``layout``, the
    state is this rank's blocks and ``batch`` its rows; the metrics are the
    whole batch's."""
    loss, metrics, grads = loss_and_grads(cfg, state.params, batch, layout)
    grads = [torch.zeros_like(p, dtype=torch.float32) if g is None else g
             for p, g in zip(leaves(state.params), grads)]
    group = None if layout is None else layout.mesh.group
    sharded = None if layout is None else layout.sharded
    ef = state.ef
    if groups is not None:
        grads, ef = compress_grads(grads, ef, groups, group)
    params, opt, opt_metrics = adamw_update(opt_cfg, state.params, grads,
                                            state.opt, decay, group, sharded)
    return (TrainState(params=params, opt=opt, ef=ef),
            {**metrics, **opt_metrics, "loss": loss})


@dataclass
class TrainStepBundle:
    step_fn: Any              # (state, batch) -> (state, metrics)
    init_state_fn: Any        # (seed) -> TrainState on the step's device
    #: the state's layout over a rank mesh (``None`` on one device)
    layout: RankLayout | None = None

    def shard_state(self, state: TrainState) -> TrainState:
        """This rank's blocks of a whole state (the state itself on one
        device)."""
        return state if self.layout is None else self.layout.shard(state)


def make_train_step(cfg: ModelConfig, device=None,
                    opt_cfg: OptimizerConfig | None = None,
                    use_compression: bool = False,
                    mesh=None) -> TrainStepBundle:
    """The step on ``device`` (CUDA unless named; ``"cpu"`` for the plain
    path).  ``step_fn`` takes a batch of numpy arrays or tensors and moves
    it to the device; the weight-decay leaves and compression groups are
    derived once from the parameter tree.  On a rank ``mesh`` (``device``
    its kind; the step runs on the mesh's device) ``init_state_fn(seed)``
    draws the whole state from ``seed`` and keeps this rank's blocks, and
    ``step_fn`` takes this rank's rows of the batch
    (``data.SyntheticLM.host_batch(i, mesh.rank, W)``)."""
    opt_cfg = opt_cfg or OptimizerConfig()
    dev = resolve_device(device)
    init = make_train_state_shapes(cfg, use_compression)
    shapes = init(0, "meta")
    decay = decay_mask(cfg, shapes.params)
    groups = ([r.members for r in ref_leaves(cfg, shapes.params)]
              if use_compression else None)
    layout = None
    if getattr(mesh, "ranks", False):
        if mesh.device.type != dev.type:
            raise ValueError(f"the rank mesh is on {mesh.device}, the step "
                             f"on {dev}")
        dev, layout = mesh.device, RankLayout.of(shapes, mesh)

    def step_fn(state: TrainState, batch: dict):
        return train_step(cfg, opt_cfg, state, batch_on(batch, dev), decay,
                          groups, layout)

    def init_state_fn(seed: int = 0) -> TrainState:
        state = init(seed, dev)
        return state if layout is None else layout.shard(state)

    return TrainStepBundle(step_fn=step_fn, init_state_fn=init_state_fn,
                           layout=layout)
