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


def _scale(xs: list[torch.Tensor]) -> torch.Tensor:
    amax = torch.stack([torch.max(torch.abs(x)) for x in xs]).max()
    return torch.clamp(amax, min=1e-12) * _INV_127


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
                   groups: list[tuple[int, ...]]
                   ) -> tuple[list[torch.Tensor], EFState]:
    """grads (+ carried residual) → int8-roundtripped grads + new residual.
    ``grads`` is a list in the residual's leaf order; ``groups`` lists the
    leaf indices that share one scale, every leaf in exactly one group."""
    rs = leaves(ef.residual)
    if sorted(i for m in groups for i in m) != list(range(len(grads))) \
            or len(rs) != len(grads):
        raise ValueError(f"groups must cover each of the {len(grads)} "
                         f"gradients once, against {len(rs)} residuals")
    out, res = [None] * len(grads), [None] * len(grads)
    for members in groups:
        xs = [grads[i].float() + rs[i] for i in members]
        scale = _scale(xs)
        for i, x in zip(members, xs):
            q = _quantize(x, scale)
            out[i], res[i] = _dequantize(q, scale), _residual(x, q, scale)
    return out, EFState(residual=unflatten_like(ef.residual, res))
