"""Path-based sharding rules, port of ``repro.sharding.rules``: parameter,
batch and cache trees → :class:`PartitionSpec` trees.

Scheme (the reference's): 2-D sharding.  The tensor-parallel axis ``model``
shards the "width" dimension of every weight (heads / d_ff / experts /
vocab); the ``data`` axis doubles as an FSDP axis over the other large
dimension (ZeRO-3: parameters, gradients and optimizer state all sharded,
gathered a layer at a time at the use site).  Across pods the weights are
replicated over ``pod``: pure data parallelism.  Every rule is
divisibility-guarded: an axis is applied only if it divides the dimension
(qwen's 2 KV heads are *not* sharded over a 16-way ``model``), so one rule
set holds for full configs, smoke configs and every mesh.

A mesh here is anything with a ``.shape`` dict of axis sizes (the port's
:class:`repro_torch.launch.mesh.Mesh`, or a shape-only stand-in): the rules
read sizes only and never touch a device.

The reference stacks the layers of each scan group (``blocks/stack/p{j}/
...``, ``enc/stack``, ``dec/stack``) and prepends ``None`` for the stack
axis; the port keeps one entry per layer (``blocks/{i}/...``, ``enc/{i}/
...``), so the same regexes match its paths and a per-layer leaf's spec is
the reference's spec without that leading ``None``.  The divisibility guard
and the fallback act on the per-layer shape in both packages, so they
agree.  :func:`spec_for_param` and :func:`spec_for_cache` take the
reference's stacked paths as well (a ``stack`` component).
"""

from __future__ import annotations

import math
import re

import torch

FSDP_AXIS = "data"
TP_AXIS = "model"
BATCH_AXES = ("pod", "data")  # pod is absent on single-pod meshes


class PartitionSpec(tuple):
    """One entry a dim: an axis name, ``None`` (replicated) or a tuple of
    axis names; compares equal to the plain tuple of its entries."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return math.prod(_axis_size(mesh, n) for n in name)
    return mesh.shape.get(name, 1)


def _fits(mesh, dim: int, axis) -> bool:
    if axis is None:
        return True
    sz = _axis_size(mesh, axis)
    return sz > 1 and dim % sz == 0


def batch_axes(mesh):
    """The composite batch axis for this mesh ('pod' folded in if present)."""
    axes = tuple(a for a in BATCH_AXES if a in mesh.shape)
    return axes if len(axes) > 1 else axes[0]


# -- per-leaf weight rules ----------------------------------------------------
# (regex on "<parent>/<leaf>", ndim) → desired axes per dim (None = replicate);
# the *first* matching rule wins
_RULES: list[tuple[str, int, tuple]] = [
    # embeddings
    (r"embed/tokens$", 2, (TP_AXIS, FSDP_AXIS)),
    (r"embed/unembed$", 2, (FSDP_AXIS, TP_AXIS)),
    # attention (GQA): wq/wk/wv (D, H, hd), wo (H, hd, D)
    (r"attn/wq$", 3, (FSDP_AXIS, TP_AXIS, None)),
    (r"attn/wk$", 3, (FSDP_AXIS, TP_AXIS, None)),
    (r"attn/wv$", 3, (FSDP_AXIS, TP_AXIS, None)),
    (r"attn/wo$", 3, (TP_AXIS, None, FSDP_AXIS)),
    (r"attn/b[qkv]$", 2, (TP_AXIS, None)),
    # MLA
    (r"attn/w_dkv$", 2, (FSDP_AXIS, None)),
    (r"attn/w_kr$", 2, (FSDP_AXIS, None)),
    (r"attn/w_uk$", 3, (None, TP_AXIS, None)),
    (r"attn/w_uv$", 3, (None, TP_AXIS, None)),
    # cross attention (whisper)
    (r"xattn/w[qkv]$", 3, (FSDP_AXIS, TP_AXIS, None)),
    (r"xattn/wo$", 3, (TP_AXIS, None, FSDP_AXIS)),
    # dense MLP (also MoE shared expert)
    (r"(mlp|shared)/wi_gate$", 2, (FSDP_AXIS, TP_AXIS)),
    (r"(mlp|shared)/wi_up$", 2, (FSDP_AXIS, TP_AXIS)),
    (r"(mlp|shared)/wo$", 2, (TP_AXIS, FSDP_AXIS)),
    # MoE experts: (E, D, F) / (E, F, D) — expert parallelism over model
    (r"moe/router$", 2, (FSDP_AXIS, None)),
    (r"moe/wi_gate$", 3, (TP_AXIS, FSDP_AXIS, None)),
    (r"moe/wi_up$", 3, (TP_AXIS, FSDP_AXIS, None)),
    (r"moe/wo$", 3, (TP_AXIS, None, FSDP_AXIS)),
    # mamba2
    (r"mixer/in_proj$", 2, (FSDP_AXIS, TP_AXIS)),
    (r"mixer/out_proj$", 2, (TP_AXIS, FSDP_AXIS)),
    # RG-LRU
    (r"mixer/w_x$", 2, (FSDP_AXIS, TP_AXIS)),
    (r"mixer/w_gate$", 2, (FSDP_AXIS, TP_AXIS)),
    (r"mixer/w_input_gate$", 2, (FSDP_AXIS, TP_AXIS)),
    (r"mixer/w_rec_gate$", 2, (FSDP_AXIS, TP_AXIS)),
    (r"mixer/w_out$", 2, (TP_AXIS, FSDP_AXIS)),
    # whisper positions
    (r"dec_pos$", 2, (None, FSDP_AXIS)),
    (r"enc_pos$", 2, (None, FSDP_AXIS)),
]


def path_str(path) -> str:
    """A tree path as ``a/b/c``: a string as it is, else its components
    (strings, ints, or pytree keys with a ``key``, ``name`` or ``idx``)
    joined with ``/``."""
    if isinstance(path, str):
        return path
    parts = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                k = getattr(k, attr)
                break
        parts.append(str(k))
    return "/".join(parts)


def _stacked(ps: str) -> bool:
    return "/stack/" in f"/{ps}/"


def spec_for_param(path, leaf, mesh) -> PartitionSpec:
    """The spec of the parameter ``leaf`` (anything with a ``.shape``) at
    ``path``: the first rule whose regex matches the path and whose ndim
    is the leaf's, each axis kept only where it divides its dim and is not
    already used; else the largest dim of at least 1,024 over FSDP where
    that divides; else replicated."""
    ps = path_str(path)
    stacked = _stacked(ps)
    shape = tuple(leaf.shape)
    core_shape = shape[1:] if stacked else shape
    for pat, ndim, axes in _RULES:
        if len(core_shape) == ndim and re.search(pat, ps):
            chosen = tuple(ax if _fits(mesh, d, ax) else None
                           for d, ax in zip(core_shape, axes))
            # never assign the same mesh axis twice
            seen: set = set()
            final = []
            for ax in chosen:
                if ax is not None and ax in seen:
                    final.append(None)
                else:
                    final.append(ax)
                    if ax is not None:
                        seen.add(ax)
            if stacked:
                final = [None] + final
            return P(*final)
    # fallback: shard the largest dim over FSDP if it fits, else replicate
    if core_shape and max(core_shape) >= 1024:
        i = max(range(len(core_shape)), key=lambda j: (core_shape[j], -j))
        if _fits(mesh, core_shape[i], FSDP_AXIS):
            spec = [None] * len(core_shape)
            spec[i] = FSDP_AXIS
            if stacked:
                spec = [None] + spec
            return P(*spec)
    return P()


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over every leaf of nested dicts, lists and (named)
    tuples, keeping the structure; ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def param_shardings(param_tree, mesh):
    """The tree of :func:`spec_for_param` for every leaf of a parameter
    tree (the port's: nested dicts and per-layer lists of tensors, real or
    on the ``meta`` device)."""
    return _map_with_path(lambda path, leaf: spec_for_param(path, leaf, mesh),
                          param_tree)


# -- activations / inputs -----------------------------------------------------
def batch_spec(mesh, ndim: int, batch_dim: int = 0,
               batch_size: int | None = None) -> PartitionSpec:
    """Shard dim 0 (batch) over the composite batch axes when divisible."""
    ax = batch_axes(mesh)
    spec = [None] * ndim
    if batch_size is None or _fits(mesh, batch_size, ax):
        spec[batch_dim] = ax
    elif "data" in mesh.shape and batch_size is not None \
            and batch_size % mesh.shape["data"] == 0:
        spec[batch_dim] = "data"
    return P(*spec)


def data_shardings(batch_tree, mesh):
    """:func:`batch_spec` for every leaf of a batch (dim 0 the batch)."""
    return _map_with_path(
        lambda _, leaf: batch_spec(mesh, len(leaf.shape), 0, leaf.shape[0]),
        batch_tree)


def _batch_axis_for(mesh, b: int):
    ax = batch_axes(mesh)
    if _fits(mesh, b, ax):
        return ax
    if "data" in mesh.shape and b % mesh.shape["data"] == 0:
        return "data"
    return None


def _leaf_name(ps: str) -> str:
    """The field a cache leaf is: the last path component that is not a
    list index (the port's per-layer lists put one after the field)."""
    parts = [p for p in ps.split("/") if not p.isdigit()]
    return parts[-1] if parts else ""


def spec_for_cache(path, leaf, mesh) -> PartitionSpec:
    """Decode-state sharding: batch over the data axes; the width dimension
    (KV heads / latent rank / conv channels / SSD heads / LRU lanes) over
    ``model`` when divisible.  Takes the reference's stacked leaves (a
    ``stack`` path component, or whisper's 5-dim layer-stacked K/V) and the
    port's per-layer ones."""
    ps = path_str(path)
    name = _leaf_name(ps)
    shape = tuple(leaf.shape)
    stacked = _stacked(ps)
    # the reference's whisper caches stack layers without a /stack/ component
    if not stacked and name in ("k", "v", "cross_k", "cross_v") \
            and len(shape) == 5:
        stacked = True
    if stacked:
        shape = shape[1:]
    spec: list = [None] * len(shape)
    if len(shape) >= 1:
        spec[0] = _batch_axis_for(mesh, shape[0])
    tp = mesh.shape.get(TP_AXIS, 1)
    if name in ("k", "v", "cross_k", "cross_v") and len(shape) == 4:
        if shape[2] % tp == 0 and tp > 1:
            spec[2] = TP_AXIS          # (B, S, Hkv, hd) — heads
        elif shape[1] % tp == 0 and tp > 1:
            spec[1] = TP_AXIS          # few KV heads → shard the sequence
    elif name in ("k", "v") and len(shape) == 3:
        if shape[2] % tp == 0 and tp > 1:
            spec[2] = TP_AXIS          # MLA latent (B, S, R) — rank
        elif shape[1] % tp == 0 and tp > 1:
            spec[1] = TP_AXIS
    elif name in ("k_scale", "v_scale") and len(shape) == 3:
        if shape[1] % tp == 0 and tp > 1:
            spec[1] = TP_AXIS          # (B, S, Hkv) — follow the S-sharded KV
    elif name == "conv" and len(shape) == 3:
        if shape[2] % tp == 0 and tp > 1:
            spec[2] = TP_AXIS          # (B, K-1, C) — channels
    elif name == "ssd" and len(shape) == 4:
        if shape[1] % tp == 0 and tp > 1:
            spec[1] = TP_AXIS          # (B, H, P, N) — heads
    elif name == "h" and len(shape) == 2:
        if shape[1] % tp == 0 and tp > 1:
            spec[1] = TP_AXIS          # (B, D_rnn) — lanes
    if stacked:
        spec = [None] + spec
    return P(*spec)


def cache_shardings(cache_tree, mesh):
    """:func:`spec_for_cache` for every leaf of a decode cache (the port's
    per-layer list, or whisper's ``WhisperCache``)."""
    return _map_with_path(lambda path, leaf: spec_for_cache(path, leaf, mesh),
                          cache_tree)


def shard_bytes(leaf, spec, mesh) -> int:
    """Bytes of ``leaf`` (a tensor) a device holds under ``spec``: its
    bytes over the product of the sizes of the axes that shard it."""
    div = 1
    for ax in spec:
        if ax is not None:
            div *= _axis_size(mesh, ax)
    return leaf.numel() * leaf.element_size() // div


# -- a rank's blocks ----------------------------------------------------------
def fsdp_dim(spec) -> int | None:
    """The dim ``spec`` shards over ``data`` (alone or in a tuple of axes),
    or ``None``."""
    for i, ax in enumerate(spec):
        if ax == FSDP_AXIS or (isinstance(ax, tuple) and FSDP_AXIS in ax):
            return i
    return None


def local_shard(leaf, spec, mesh):
    """This rank's contiguous block of ``leaf`` (a tensor) along the dim
    ``spec`` shards over ``data``: block ``mesh.rank`` of
    ``mesh.shape["data"]`` equal blocks, a copy; the whole leaf (a copy)
    where the spec has no ``data`` or the mesh one rank."""
    dim = fsdp_dim(spec)
    w = mesh.shape.get(FSDP_AXIS, 1)
    if dim is None or w == 1:
        return leaf.clone()
    n = leaf.shape[dim]
    if n % w:
        raise ValueError(f"dim {dim} of {n} does not split into {w} blocks")
    return leaf.narrow(dim, mesh.rank * (n // w), n // w).clone()


def assemble(blocks: list, spec):
    """The inverse of :func:`local_shard`: the whole leaf from every rank's
    block, in rank order (the first block where the spec has no
    ``data``)."""
    dim = fsdp_dim(spec)
    if dim is None or len(blocks) == 1:
        return blocks[0]
    return torch.cat(blocks, dim=dim)
