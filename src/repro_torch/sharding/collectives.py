"""Collectives over a rank mesh's ``data`` group, with their transposes.

On a rank mesh (:func:`repro_torch.launch.mesh.make_rank_mesh`) each rank
holds a contiguous block of every FSDP-sharded leaf
(:func:`repro_torch.sharding.rules.local_shard`) and its own rows of the
batch.  Two autograd contracts follow, the reference's under GSPMD:

* :func:`gather_fsdp` is ZeRO-3's use site: the forward all-gathers the
  blocks into the whole leaf, the backward reduce-scatters (sums) the
  whole leaf's gradient, each rank's partial, back into this rank's block;
* :func:`psum` sums a statistic over the ranks (a token count's sum, the
  MoE router's probabilities): what follows it is the same on every rank,
  so its backward is the identity, each rank's gradient of the replicated
  sum already the logical one (Megatron's reduce-from-parallel-region).

:func:`all_reduce_sum` and :func:`all_reduce_max` are the plain forms, for
values no gradient flows through.  At one rank every collective is a copy,
so a one-rank world computes the bits an unsharded run does.  ``calls``
counts the collectives issued, by kind.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

#: collectives issued, by kind (``all-gather``, ``reduce-scatter``,
#: ``all-reduce``)
calls: Counter = Counter()


def _gather_into(out, x, group):
    # torch 2.13 names these ``all_gather_single``/``reduce_scatter_single``
    # and deprecates the older names; earlier releases have the older only
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)


def _scatter_into(out, x, group):
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, x, group=group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of ``x`` joined in rank order along ``dim`` (a
    contiguous tensor, laid out as the whole leaf is)."""
    w = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((w * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _gather_into(out, xm, group)
    calls["all-gather"] += 1
    return out.movedim(0, dim).contiguous()


def reduce_scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the ranks of ``g``, cut along ``dim`` into blocks in
    rank order: this rank's block."""
    w = dist.get_world_size(group)
    gm = g.movedim(dim, 0).contiguous()
    out = torch.empty((gm.shape[0] // w,) + tuple(gm.shape[1:]),
                      dtype=g.dtype, device=g.device)
    _scatter_into(out, gm, group)
    calls["reduce-scatter"] += 1
    return out.movedim(0, dim).contiguous()


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    out = x.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    calls["all-reduce"] += 1
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks (a new tensor; no gradient)."""
    return _all_reduce(x, dist.ReduceOp.SUM, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks (no gradient)."""
    return _all_reduce(x, dist.ReduceOp.MAX, group)


class _GatherFSDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(w, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


def gather_fsdp(w: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole leaf from this rank's block ``w`` (cut along ``dim``):
    all-gather forward, reduce-scatter (sum) of the gradient backward."""
    return _GatherFSDP.apply(w, dim, group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: what follows is
    replicated on every rank, so the gradient passes through unchanged."""
    return _PSum.apply(x, group)
