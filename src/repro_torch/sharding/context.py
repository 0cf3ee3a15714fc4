"""The mesh context and the use-site sharding hooks, port of
``repro.sharding.context``.

The reference's model code pins GSPMD's decisions with sharding
constraints: ``fsdp_use`` gathers a layer's FSDP-sharded weights at their
use site (ZeRO-3), ``constrain_batch`` / ``constrain_seq`` /
``constrain_heads`` pin activations.  The port calls the same hooks at the
same sites (``models/lm.py``, ``attention.py``, ``whisper.py``).  No
partitioner runs here, so a hook does one of three things:

* **no mesh, or a mesh whose axes are all 1** (every single-device run):
  it returns its input, the same object, after one context-variable read;
* **a dry-run lowering** (:func:`recording`, which
  :mod:`repro_torch.launch.dryrun` opens over a shape-only mesh): it records
  the collective the reference's constraint implies into the lowering's
  counter (bytes a device, by kind) and passes the values through
  unchanged.  ``fsdp_use`` records an all-gather of each FSDP-sharded
  weight's gathered bytes (in ``cast``'s dtype where it casts a float32
  matrix), and, when the weight carries a gradient, the reduce-scatter of
  that gradient in the backward (plus its all-reduce over ``pod`` on a
  multi-pod mesh, where weights are replicated); ``constrain_seq`` under
  sequence parallelism an all-gather of the layer input's sequence over
  ``model`` (a reduce-scatter of its gradient in the backward);
  ``constrain_heads`` an all-to-all of the head-sharded tensor;
  ``constrain_batch`` nothing (it pins the layout the batch arrives in).
  These are the port's own model of the traffic, not a partitioner's;
* **a real mesh of more than one device**: raises ``NotImplementedError``
  (ROADMAP A9-shard-multi; :func:`repro_torch.launch.mesh.make_host_mesh`
  refuses to build one on CUDA).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from collections import Counter

import torch

from repro_torch.sharding import rules

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)
_RECORD: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_collectives", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def current_mesh():
    return _MESH.get()


class Recorder(Counter):
    """Bytes a device by collective kind (``all-gather``,
    ``reduce-scatter``, ``all-reduce``, ``all-to-all``).
    ``weights_gathered``: the parameters are held without their FSDP axis
    (a serve cell's ``serve_sharding="tp"``), so ``fsdp_use`` moves
    nothing."""

    def __init__(self, weights_gathered: bool = False):
        super().__init__()
        self.weights_gathered = weights_gathered


@contextlib.contextmanager
def recording(weights_gathered: bool = False):
    """Record the hooks' collectives into a :class:`Recorder`, as a dry-run
    lowering does."""
    counter = Recorder(weights_gathered)
    tok = _RECORD.set(counter)
    try:
        yield counter
    finally:
        _RECORD.reset(tok)


def _active():
    """``(mesh, counter)`` when a hook has work to do, else ``None``: no
    mesh or a trivial one; raises on a real mesh of several devices."""
    mesh = _MESH.get()
    if mesh is None or all(n == 1 for n in mesh.shape.values()):
        return None
    if getattr(mesh, "devices", None):
        raise NotImplementedError(
            "a mesh of more than one device runs no sharded step yet "
            "(ROADMAP.md queue A, A9-shard-multi); dry-run lowerings use a "
            "shape-only mesh")
    counter = _RECORD.get()
    return None if counter is None else (mesh, counter)


def _drop_fsdp(spec):
    def drop(ax):
        if ax == rules.FSDP_AXIS:
            return None
        if isinstance(ax, tuple):
            kept = tuple(a for a in ax if a != rules.FSDP_AXIS)
            return kept if kept else None
        return ax
    return rules.P(*[drop(ax) for ax in spec])


class _Collective(torch.autograd.Function):
    """Identity that records ``fwd`` bytes in the forward and ``bwd`` bytes
    in the backward (the constraint's transpose)."""

    @staticmethod
    def forward(ctx, x, counter, fwd, bwd):
        ctx.counter, ctx.bwd = counter, bwd
        counter.update(fwd)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.counter.update(ctx.bwd)
        return g, None, None, None


def _through(x, counter, fwd: dict, bwd: dict):
    if torch.is_grad_enabled() and x.requires_grad:
        return _Collective.apply(x, counter, fwd, bwd)
    counter.update(fwd)
    return x


def _bytes(x, itemsize: int, mesh, axes) -> int:
    """Bytes of ``x`` at ``itemsize`` a device when ``axes`` shard it."""
    return x.numel() * itemsize // math.prod(
        rules._axis_size(mesh, ax) for ax in axes if ax is not None)


def fsdp_use(layer_params, cast=None):
    """Each weight of a layer at its gathered (use-site) sharding: the same
    tree off a mesh; under a lowering, the gathers recorded (``cast``: the
    dtype a float32 weight of two or more dims would be gathered in)."""
    act = _active()
    if act is None or rules.FSDP_AXIS not in act[0].shape \
            or act[1].weights_gathered:
        return layer_params
    mesh, counter = act

    def one(path, w):
        spec = rules.spec_for_param(path, w, mesh)
        if rules.FSDP_AXIS not in spec:
            return w
        itemsize = w.element_size()
        if cast is not None and w.dim() >= 2 and w.dtype == torch.float32:
            itemsize = torch.empty((), dtype=cast).element_size()
        shard = _bytes(w, itemsize, mesh, spec)
        bwd = {"reduce-scatter": shard}
        if mesh.shape.get("pod", 1) > 1:
            bwd["all-reduce"] = shard
        return _through(w, counter, {"all-gather": _bytes(
            w, itemsize, mesh, _drop_fsdp(spec))}, bwd)

    return rules._map_with_path(one, layer_params)


def _batch_axis(mesh, b: int):
    ax = rules.batch_axes(mesh)
    if b % rules._axis_size(mesh, ax) != 0:
        if "data" in mesh.shape and b % mesh.shape["data"] == 0:
            return "data"
        return None
    return ax


def constrain_batch(x):
    """Pin dim 0 to the composite batch axes: ``x`` itself (no collective
    is implied: inputs arrive batch-sharded)."""
    _active()
    return x


def constrain_heads(x):
    """Pin (B, S, H, hd) attention tensors to head-sharding over
    ``model``; under a lowering, the reshard is an all-to-all of the
    tensor's bytes a device."""
    act = _active()
    if act is None or x.dim() != 4:
        return x
    mesh, counter = act
    tp = mesh.shape.get(rules.TP_AXIS, 1)
    if tp <= 1 or x.shape[2] % tp != 0:
        return x
    moved = {"all-to-all": _bytes(x, x.element_size(), mesh,
                                  (_batch_axis(mesh, x.shape[0]),
                                   rules.TP_AXIS))}
    return _through(x, counter, moved, moved)


def constrain_seq(x):
    """Megatron-style sequence parallelism for the residual stream (B, S,
    D) as (batch, model, —); falls back to :func:`constrain_batch` when the
    sequence does not divide the model axis.  Under a lowering, the layer's
    input is gathered over ``model`` (its gradient reduce-scattered)."""
    act = _active()
    if act is None:
        return x
    mesh, counter = act
    tp = mesh.shape.get(rules.TP_AXIS, 1)
    if x.dim() != 3 or tp <= 1 or x.shape[1] % tp != 0:
        return constrain_batch(x)
    full = _bytes(x, x.element_size(), mesh, (_batch_axis(mesh, x.shape[0]),))
    return _through(x, counter, {"all-gather": full},
                    {"reduce-scatter": full // tp})
