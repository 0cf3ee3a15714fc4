"""Scatters with the reference's semantics, on every device.

JAX's ``x.at[i].set(v, mode="drop")`` resolves repeated indices *last lane
wins* and throws away out-of-range rows.  Torch's ``index_put_`` /
``scatter_`` leave the winner of a repeated index undefined on CUDA and
raise on out-of-range rows, so every scatter of the port goes through the
two helpers here.  Both take a leading config axis ``G``: ``target`` is
``(G, N, *F)``, ``index`` and ``valid`` are ``(G, L)``.
"""

from __future__ import annotations

import torch


def _expand_rows(index: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``(G, L)`` row indices → the ``(G, L, *F)`` index ``gather`` /
    ``scatter_`` take along dim 1."""
    tail = target.shape[2:]
    return index.reshape(index.shape + (1,) * len(tail)).expand(
        index.shape + tail)


def scatter_last(target: torch.Tensor, index: torch.Tensor,
                 values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """In place: ``target[g, index[g, l]] = values[g, l]`` for every valid
    lane, the last valid lane winning a repeated index; invalid lanes and
    lanes whose index is out of range write nothing.  Returns ``target``.

    Every lane writing one row is given the winner's value (and a lane whose
    row no valid lane writes is given the row's current value), so the one
    ``scatter_`` below is deterministic whatever order the device applies
    duplicates in.  Costs an ``L × L`` comparison per config.
    """
    n = target.shape[1]
    index = index.long()
    valid = valid & (index >= 0) & (index < n)
    idx = torch.where(valid, index, 0)
    lanes = torch.arange(idx.shape[1], device=idx.device)
    same = (idx[:, :, None] == idx[:, None, :]) & valid[:, None, :]
    writer = torch.where(same, lanes, -1).amax(dim=2)         # (G, L)
    has_writer = writer >= 0
    won = torch.gather(values, 1, _expand_rows(writer.clamp(min=0), values))
    current = torch.gather(target, 1, _expand_rows(idx, target))
    mask = has_writer.reshape(has_writer.shape
                              + (1,) * (target.dim() - 2))
    target.scatter_(1, _expand_rows(idx, target),
                    torch.where(mask, won.to(target.dtype), current))
    return target


def scatter_add_drop(target: torch.Tensor, index: torch.Tensor,
                     values, valid: torch.Tensor) -> torch.Tensor:
    """In place: ``target[g, index[g, l]] += values[g, l]`` for valid lanes
    whose index is in range (``.at[].add(mode="drop")``); additions
    commute, so repeated indices need no ordering.  ``target`` is
    ``(G, N)``."""
    n = target.shape[1]
    index = index.long()
    valid = valid & (index >= 0) & (index < n)
    idx = torch.where(valid, index, 0)
    if not isinstance(values, torch.Tensor):
        # filled on the device: a host-to-device copy of a Python number
        # would break a CUDA graph capture
        values = torch.full((), values, dtype=target.dtype,
                            device=target.device)
    add = torch.where(valid, values.to(target.dtype),
                      torch.zeros((), dtype=target.dtype,
                                  device=target.device))
    return target.scatter_add_(1, idx, add.expand(idx.shape))
