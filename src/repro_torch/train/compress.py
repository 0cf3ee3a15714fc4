"""Gradient compression: int8 quantisation with error feedback, port of
``repro.train.compress``.

Each reference leaf is quantised with one absmax scale: the gradient plus
the carried residual, rounded (half to even) to ``[-127, 127]`` steps of
``max|x| / 127`` and dequantised; the quantisation error is the next
residual.  The arithmetic is the reference's as XLA compiles it, so the
result is the same bit for bit.  A reference leaf of a scan group's stack
holds every layer of the group, so the caller passes ``groups=[r.members
for r in train.tree.ref_leaves(cfg, params)]``, which takes one scale
across them; there is no default.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.sharding import collectives
from repro_torch.train.tree import leaves, tree_map, unflatten_like


class EFState(NamedTuple):
    residual: Any  # tree like the gradients (float32)


def init_ef_state(params) -> EFState:
    return EFState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


#: 1/127 rounded to float32: the reference's ``max / 127.0`` runs jitted,
#: and XLA turns a division by a constant into a product with its
#: reciprocal
_INV_127 = float(np.float32(1 / 127))


def _absmax(xs: list[torch.Tensor]) -> torch.Tensor:
    return torch.stack([torch.max(torch.abs(x)) for x in xs]).max()


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) * _INV_127


def _inputs(grads, rs, members) -> list[torch.Tensor]:
    return [grads[i].float() + rs[i] for i in members]


@torch.no_grad()
def group_scales(grads: list[torch.Tensor], ef: EFState,
                 groups: list[tuple[int, ...]], group=None) -> torch.Tensor:
    """Each scale group's quantisation step, ``max|g + residual| / 127``
    over its leaves.  On a rank mesh (``group``, the data axis's) a leaf
    may be this rank's block, so the maxima are taken over the ranks too
    (one all-reduce for every group; a maximum is exact, so one rank gives
    the bits one process does)."""
    rs = leaves(ef.residual)
    amax = torch.stack([_absmax(_inputs(grads, rs, m)) for m in groups])
    if group is not None:
        amax = collectives.all_reduce_max(amax, group)
    return _scale(amax)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _residual(x: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """``x − q·scale`` rounded once, as XLA's fused multiply-add gives the
    reference's ``g - gq``: in float64 both the product (7 + 24 bits) and
    the difference (at most half a step) are exact."""
    return (x.double() - q.double() * scale.double()).float()


@torch.no_grad()
def compress_grads(grads: list[torch.Tensor], ef: EFState,
                   groups: list[tuple[int, ...]], group=None
                   ) -> tuple[list[torch.Tensor], EFState]:
    """grads (+ carried residual) → int8-roundtripped grads + new residual.
    ``grads`` is a list in the residual's leaf order; ``groups`` lists the
    leaf indices that share one scale, every leaf in exactly one group;
    ``group``: a rank mesh's data group (:func:`group_scales`)."""
    rs = leaves(ef.residual)
    if sorted(i for m in groups for i in m) != list(range(len(grads))) \
            or len(rs) != len(grads):
        raise ValueError(f"groups must cover each of the {len(grads)} "
                         f"gradients once, against {len(rs)} residuals")
    scales = group_scales(grads, ef, groups, group)
    out, res = [None] * len(grads), [None] * len(grads)
    for members, scale in zip(groups, scales.unbind(0)):
        xs = _inputs(grads, rs, members)
        for i, x in zip(members, xs):
            q = _quantize(x, scale)
            out[i], res[i] = _dequantize(q, scale), _residual(x, q, scale)
    return out, EFState(residual=unflatten_like(ef.residual, res))
