"""The step of any (arch × shape × mesh) cell, port of
``repro.launch.steps``.

``build_cell(cfg, shape, mesh)`` returns a :class:`CellBundle`: the step
function, its arguments as ``meta`` stand-ins (:mod:`repro_torch.launch.
specs`), the rules' partition specs of each argument (``in_specs``) and the
arguments it donates.  ``bundle.lowered()`` is the cell's dry-run record
(:func:`lower`: the step run on the ``meta`` device under a FLOP counter
and the sharding hooks' recorder); ``bundle.run(...)`` runs the step on
the mesh's device, a host mesh's card or CPU:

* train: :mod:`repro_torch.train.step`'s step, ``bundle.init_state(seed)``
  its state on that device;
* prefill: the family's ``prefill`` (whisper's takes the frames);
* decode: the family's ``decode_step``, writing the cache it is given in
  place (recurrent states too), as the reference donates it.
"""

from __future__ import annotations

import functools
import math
from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import specs as specs_mod
from repro_torch.models import family_of
from repro_torch.models.common import ModelConfig
from repro_torch.sharding import (
    batch_spec,
    cache_shardings,
    data_shardings,
    param_shardings,
    use_mesh,
)
from repro_torch.sharding import context as sharding_ctx
from repro_torch.sharding.rules import P, shard_bytes
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import (
    TrainState,
    make_train_state_shapes,
    make_train_step,
    state_specs,
)
from repro_torch.train.tree import flatten

META = specs_mod.META


@dataclass
class CellBundle:
    kind: str
    cfg: ModelConfig
    mesh: Any
    #: ``make(cfg, device) -> step``: the step for ``cfg`` on ``device``
    make: Callable
    args: tuple          # meta stand-ins to lower with
    in_specs: tuple      # a partition-spec tree per argument
    #: ``(outputs) -> spec tree`` of the step's outputs
    out_specs: Callable
    donate: tuple = ()
    #: the parameters are held gathered (``serve_sharding="tp"``)
    weights_gathered: bool = False

    @functools.cached_property
    def step(self):
        return self.make(self.cfg, self.mesh.device)

    def init_state(self, seed: int = 0) -> TrainState:
        """A train cell's state from ``seed`` on the mesh's device."""
        if self.kind != "train":
            raise ValueError(f"a {self.kind} cell has no train state")
        return self.step.init_state_fn(seed)

    def run(self, *args):
        """The step on the mesh's device, under the mesh."""
        with use_mesh(self.mesh):
            if self.kind == "train":
                return self.step.step_fn(*args)
            return self.step(*args)

    def lowered(self) -> dict:
        return lower(self)


def _at(tree, path):
    for k in path:
        tree = getattr(tree, k) if isinstance(k, str) and \
            hasattr(tree, "_fields") else tree[k]
    return tree


def tree_bytes(tree, specs, mesh) -> int:
    """Bytes a device holds of every tensor of ``tree`` under the spec tree
    ``specs``."""
    return sum(shard_bytes(leaf, _at(specs, path), mesh)
               for path, leaf in flatten(tree))


def lower(bundle: CellBundle) -> dict:
    """The cell's dry-run record: its step run once on ``meta`` stand-ins
    with ``attn_impl="xla"`` (the plain XLA-path functions the reference's
    lowering compiles; the kernels have no ``meta`` path), under
    ``FlopCounterMode`` and the hooks' recorder.  ``memory``: bytes a
    device of the arguments, outputs and donated (aliased) outputs, exact
    from the specs; ``temp_bytes`` and ``code_bytes`` are not modelled
    (``None``).  ``cost``: the FLOPs of the whole step (``flops_global``,
    every layer counted: eager execution unrolls nothing away) and that
    count over the mesh's devices (``flops``); bytes accessed are not
    modelled.  ``collectives``: bytes a device by kind, as the hooks
    record them (:mod:`repro_torch.sharding.context`)."""
    mesh = bundle.mesh
    cfg = bundle.cfg.replace(attn_impl="xla")
    step = bundle.make(cfg, META)
    if bundle.kind == "train":
        step = step.step_fn
    with use_mesh(mesh), \
            sharding_ctx.recording(bundle.weights_gathered) as coll, \
            FlopCounterMode(display=False) as fc:
        out = step(*bundle.args)
    flops = int(fc.get_total_flops())
    arg_bytes = sum(tree_bytes(a, s, mesh)
                    for a, s in zip(bundle.args, bundle.in_specs))
    out_specs = bundle.out_specs(out)
    out_bytes = tree_bytes(out, out_specs, mesh)
    alias = sum(tree_bytes(bundle.args[i], bundle.in_specs[i], mesh)
                for i in bundle.donate)
    n_dev = math.prod(mesh.shape.values())
    return {
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": None, "alias_bytes": alias,
                   "code_bytes": None},
        "cost": {"flops": flops / n_dev, "flops_global": flops,
                 "bytes": None},
        "collectives": {k: float(v) for k, v in sorted(Counter(coll).items())},
    }


def build_train_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
                     use_compression: bool = False,
                     opt_cfg: OptimizerConfig | None = None) -> CellBundle:
    opt_cfg = opt_cfg or OptimizerConfig()
    ins = specs_mod.input_specs(cfg, shape)
    state = make_train_state_shapes(cfg, use_compression)(0, META)
    st_specs = state_specs(state, mesh)

    def make(c, device):
        on_ranks = (getattr(mesh, "ranks", False)
                    and torch.device(device).type != "meta")
        return make_train_step(c, device, opt_cfg, use_compression,
                               mesh=mesh if on_ranks else None)

    def out_specs(out):
        new_state, metrics = out
        return (st_specs, {k: P() for k in metrics})

    return CellBundle(kind="train", cfg=cfg, mesh=mesh, make=make,
                      args=(state, ins),
                      in_specs=(st_specs, data_shardings(ins, mesh)),
                      donate=(0,), out_specs=out_specs)


def _maybe_tp_only(pspecs, serve_sharding: str):
    """serve_sharding="tp": drop the FSDP axis from parameter specs —
    serving weights live gathered (TP-sharded, data-replicated), so decode
    steps pay no per-step weight all-gathers."""
    if serve_sharding != "tp":
        return pspecs
    return _map_spec(sharding_ctx._drop_fsdp, pspecs)


def _map_spec(fn, specs):
    if isinstance(specs, P):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_spec(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_spec(fn, v) for v in specs]
    return specs


def _serve_outputs(mesh, gb: int):
    def out_specs(out):
        logits, cache = out
        return (batch_spec(mesh, 3, 0, gb), cache_shardings(cache, mesh))
    return out_specs


def build_prefill_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
                       serve_sharding: str = "fsdp") -> CellBundle:
    ins = specs_mod.input_specs(cfg, shape)
    pshapes = specs_mod.param_specs(cfg)
    pspecs = _maybe_tp_only(param_shardings(pshapes, mesh), serve_sharding)

    def make(c, device):
        fam = family_of(c)
        if c.arch_type == "encdec":
            def prefill_fn(params, batch):
                return fam.prefill(c, params, batch["frames"],
                                   batch["tokens"], shape.seq_len,
                                   device=device)
        else:
            def prefill_fn(params, batch):
                return fam.prefill(c, params, batch["tokens"],
                                   shape.seq_len, device=device)
        return prefill_fn

    return CellBundle(kind="prefill", cfg=cfg, mesh=mesh, make=make,
                      args=(pshapes, ins),
                      in_specs=(pspecs, data_shardings(ins, mesh)),
                      out_specs=_serve_outputs(mesh, shape.global_batch),
                      weights_gathered=serve_sharding == "tp")


def _write_back(cache, new):
    """Copy each leaf of ``new`` that is not already ``cache``'s own into
    it (the decode step replaces recurrent states), and return ``cache``."""
    for (_, old), (_, leaf) in zip(flatten(cache), flatten(new)):
        if leaf is not old:
            old.copy_(leaf)
    return cache


def build_decode_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
                      serve_sharding: str = "fsdp") -> CellBundle:
    ins = specs_mod.input_specs(cfg, shape)
    pshapes = specs_mod.param_specs(cfg)
    pspecs = _maybe_tp_only(param_shardings(pshapes, mesh), serve_sharding)
    gb = shape.global_batch

    def make(c, device):
        fam = family_of(c)

        def decode_fn(params, tokens, pos, cache):
            logits, new = fam.decode_step(c, params, tokens, pos, cache,
                                          device=device)
            return logits, _write_back(cache, new)  # donated: in place
        return decode_fn

    return CellBundle(kind="decode", cfg=cfg, mesh=mesh, make=make,
                      args=(pshapes, ins["tokens"], ins["pos"], ins["cache"]),
                      in_specs=(pspecs, batch_spec(mesh, 2, 0, gb),
                                batch_spec(mesh, 1, 0, gb),
                                cache_shardings(ins["cache"], mesh)),
                      donate=(3,), out_specs=_serve_outputs(mesh, gb),
                      weights_gathered=serve_sharding == "tp")


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               serve_sharding: str = "fsdp", **kw) -> CellBundle:
    if shape.kind == "train":
        return build_train_cell(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_cell(cfg, shape, mesh,
                                  serve_sharding=serve_sharding)
    return build_decode_cell(cfg, shape, mesh, serve_sharding=serve_sharding)
