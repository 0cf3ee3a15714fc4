"""Carry parameters and decode caches across between the reference's
pytree layout and the port's.

The reference stacks the layers of each scan group along a leading period
axis (``blocks/stack/p{j}/...``, plus unstacked ``pro_{i}`` and
``epi_{i}``; :func:`repro_torch.models.lm.scan_groups`); the port keeps one
entry per layer.  Leaf names are the same on both sides (the MoE layers'
``moe/{router,wi_gate,wi_up,wo,shared/...}`` and MLA's ``attn/{wq,w_dkv,
...}`` included), and so are the caches' fields: ``KVCache`` for attention
and MLA layers (MLA's holds the latent and the rope key), ``SSMState`` for
mamba2 and ``LRUState`` for RG-LRU layers.  Whisper's two stacks
(``enc/stack``, ``dec/stack``) become the lists ``enc`` and ``dec``, and
its ``WhisperCache``'s stacked leaves per-layer lists.  The reference's
trees come in with numpy leaves (``jax.device_get`` or ``np.asarray`` on
each leaf); the port's tensors come out on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import KVCache
from repro_torch.models.lm import layer_specs, scan_groups
from repro_torch.models.recurrent import LRUState, SSMState
from repro_torch.models.whisper import WhisperCache

#: the port's cache type of each mixer
_CACHE_TYPE = {"attn": KVCache, "attn_local": KVCache, "mla": KVCache,
               "ssm": SSMState, "rec": LRUState}


def _layer_keys(cfg) -> list[tuple[str, str | None, int | None]]:
    """Where layer ``i`` sits in the reference's tree: ``(group key, period
    slot, period index)`` — ``("pro_0", None, None)`` or ``("stack", "p1",
    7)``."""
    g = scan_groups(cfg)
    keys = [(f"pro_{i}", None, None) for i in range(len(g.prologue))]
    for t in range(g.n_periods):
        keys += [("stack", f"p{j}", t) for j in range(len(g.period))]
    keys += [(f"epi_{i}", None, None) for i in range(len(g.epilogue))]
    return keys


def _map(tree, fn):
    """``fn`` on every leaf of nested dicts and tuples (``KVCache``s keep
    their type); ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_map(v, fn) for v in tree))
    if tree is None:
        return None
    return fn(tree)


def _tensor(x) -> torch.Tensor:
    """A CPU tensor of ``x``'s values and dtype; numpy has no bfloat16 of
    its own, so an ``ml_dtypes`` bfloat16 array goes through float32
    (exact both ways)."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _layers(cfg, tree: dict) -> list:
    """The reference's per-layer subtrees of ``tree``, in layer order, as
    port tensors: a stacked group's leaves indexed at the layer's period."""
    out = []
    for key, slot, t in _layer_keys(cfg):
        sub = tree[key] if slot is None else tree[key][slot]
        if t is not None:
            sub = _map(sub, lambda x, t=t: np.asarray(x)[t])
        out.append(_map(sub, _tensor))
    return out


def _unstack(tree, n: int) -> list:
    """The ``n`` per-layer port subtrees of a stacked numpy subtree."""
    return [_map(tree, lambda x, t=t: _tensor(np.asarray(x)[t]))
            for t in range(n)]


def params_from_numpy(cfg, tree: dict) -> dict:
    """The port's parameters (CPU tensors, the reference's dtypes) from the
    reference's ``init_params`` pytree with numpy leaves (``lm``'s, or
    ``whisper``'s for an ``encdec`` config)."""
    if cfg.arch_type == "encdec":
        out = {k: _map(tree[k], _tensor)
               for k in ("embed", "dec_pos", "enc_pos", "final_norm",
                         "enc_final_norm")}
        out["enc"] = _unstack(tree["enc"]["stack"], cfg.encoder.n_layers)
        out["dec"] = _unstack(tree["dec"]["stack"], cfg.n_layers)
        return out
    return {"embed": _map(tree["embed"], _tensor),
            "final_norm": _map(tree["final_norm"], _tensor),
            "blocks": _layers(cfg, tree["blocks"])}


def cache_from_numpy(cfg, tree):
    """The port's caches (CPU tensors) from the reference's cache pytree
    with numpy leaves: per-layer ``KVCache``, ``SSMState`` and ``LRUState``
    from ``lm``'s, or a :class:`~repro_torch.models.whisper.WhisperCache`
    of per-layer lists from ``whisper``'s."""
    if cfg.arch_type == "encdec":
        n = cfg.n_layers
        fields = [[None] * n if f is None else _unstack(f, n)
                  for f in tree.self_kv]
        return WhisperCache(
            self_kv=[KVCache(*layer) for layer in zip(*fields)],
            cross_k=_unstack(tree.cross_k, n),
            cross_v=_unstack(tree.cross_v, n))
    return [_CACHE_TYPE[mixer](*c)
            for (mixer, _), c in zip(layer_specs(cfg), _layers(cfg, tree))]


def _numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _stack(rows: list):
    """A namedtuple of stacked numpy fields from per-layer namedtuples."""
    return type(rows[0])(*(None if f[0] is None else np.stack(f)
                           for f in zip(*rows)))


def cache_to_numpy(cfg, cache):
    """The reference's cache layout, with numpy leaves, from the port's
    caches: stacked groups gain their leading period axis (whisper's
    ``WhisperCache`` its leading layer axis), and bfloat16 leaves come out
    as float32 (exact)."""
    if cfg.arch_type == "encdec":
        return WhisperCache(
            self_kv=_stack([_map(c, _numpy) for c in cache.self_kv]),
            cross_k=np.stack([_numpy(t) for t in cache.cross_k]),
            cross_v=np.stack([_numpy(t) for t in cache.cross_v]))
    out: dict = {}
    stacked: dict = {}
    for c, (key, slot, _) in zip(cache, _layer_keys(cfg)):
        c = _map(c, _numpy)
        if slot is None:
            out[key] = c
        else:
            stacked.setdefault(slot, []).append(c)
    if stacked:
        out["stack"] = {slot: _stack(rows) for slot, rows in stacked.items()}
    return out
