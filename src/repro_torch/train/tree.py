"""Parameter trees of the port (nested dicts, lists and named tuples of
tensors) and where their leaves sit in the reference's tree.

The reference stacks the layers of each scan group along a leading period
axis (``blocks/stack/p{j}/...`` in :mod:`repro.models.lm`, ``enc/stack``
and ``dec/stack`` in whisper); the port keeps one entry per layer
(:mod:`repro_torch.models.convert`).  Two training rules act on the
reference's leaves and so see the stacking: AdamW decays a leaf of two or
more dims, which inside a stack is every leaf of one or more per-layer
dims (a norm scale, a bias), and the int8 compression takes one absmax
scale a leaf, which inside a stack is one scale across the group's layers.
:func:`ref_leaves` groups the port's leaves as the reference's tree holds
them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def flatten(tree, path: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """``(path, leaf)`` for every tensor of ``tree`` in order: dict keys in
    insertion order, list and tuple entries by index, a named tuple's
    fields by name; ``None`` holds no leaf."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in flatten(v, path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for k, v in zip(tree._fields, tree)
                for x in flatten(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in flatten(v, path + (i,))]
    if tree is None:
        return []
    return [(path, tree)]


def leaves(tree) -> list[torch.Tensor]:
    return [leaf for _, leaf in flatten(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``),
    keeping the structure; ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def spec_list(specs, like) -> list:
    """The entries of a spec tree in :func:`flatten`'s order of ``like``,
    the tree they describe (a partition spec is a tuple, so a spec tree
    cannot be flattened alone)."""
    out: list = []
    tree_map(lambda _, spec: out.append(spec), like, specs)
    return out


def unflatten_like(tree, values: list):
    """``tree``'s structure with its leaves replaced, in :func:`flatten`'s
    order, by ``values``."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


class RefLeaf(NamedTuple):
    """One leaf of the reference's tree: the port leaves it holds (indices
    into :func:`flatten`'s order, one a layer of a stacked group) and its
    number of dims there."""

    key: tuple
    members: tuple[int, ...]
    ndim: int


def ref_leaves(cfg, params) -> list[RefLeaf]:
    """The port's parameter leaves grouped as the reference's tree holds
    them: a layer of a scan group's stack (``lm.scan_groups``; every layer
    of whisper's two stacks) shares its reference leaf with the same leaf
    of the group's other layers, one dim more than the port's; every other
    leaf is its own."""
    from repro_torch.models.convert import _layer_keys

    layer_keys = (None if cfg.arch_type == "encdec" else _layer_keys(cfg))
    groups: dict[tuple, list] = {}
    for i, (path, leaf) in enumerate(flatten(params)):
        stacked = False
        key = path
        if layer_keys is not None and path[0] == "blocks":
            group, slot, _ = layer_keys[path[1]]
            stacked = slot is not None
            key = (group, slot) + path[2:]
        elif layer_keys is None and path[0] in ("enc", "dec"):
            stacked = True
            key = (path[0], "stack") + path[2:]
        entry = groups.setdefault(key, [[], leaf.dim() + stacked])
        entry[0].append(i)
    return [RefLeaf(k, tuple(m), nd) for k, (m, nd) in groups.items()]


def decay_mask(cfg, params) -> list[bool]:
    """Which leaves (in :func:`flatten`'s order) AdamW decays: those whose
    reference leaf has two or more dims (``optimizer.py``'s ``p.ndim >=
    2``, on the reference's stacked tree)."""
    mask = [False] * len(flatten(params))
    for ref in ref_leaves(cfg, params):
        for i in ref.members:
            mask[i] = ref.ndim >= 2
    return mask
