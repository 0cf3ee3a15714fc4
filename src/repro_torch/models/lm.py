"""Decoder-only language model, port of ``repro.models.lm``: the ``attn``,
``attn_local`` and ``mla`` mixers with a gated or plain dense FFN or the
MoE FFN, the mamba2 ``ssm`` mixer (no FFN) and the RG-LRU ``rec`` mixer.
Whisper's encoder-decoder is :mod:`repro_torch.models.whisper`.

The reference compiles the layer list into scan groups (prologue, a
``lax.scan`` over stacked periods, epilogue); eager PyTorch has nothing to
gain from a scan, so here the layers are a plain list, ``params["blocks"]
[i]`` and ``cache[i]`` for layer ``i``.  :func:`scan_groups` stays, because
it names where each layer sits in the reference's pytree
(:mod:`repro_torch.models.convert`).  :func:`loss_fn` is the reference's
causal LM loss: the chunked, vocab-parallel cross-entropy plus the MoE
layers' auxiliary losses.  With ``cfg.remat != "none"`` (the reference's
default ``"full"``), each layer of a ``train``-mode pass whose input carries a
gradient runs under ``torch.utils.checkpoint``: only its input is kept,
and the backward recomputes it.

Modes: ``train``/``eval`` (full forward), ``prefill`` (returns per-layer
caches), ``decode`` (one token against the caches; attention caches are
updated in place, recurrent states replaced).  Every entry point runs on
the CUDA device unless the caller passes ``device="cpu"``; the parameters
must already be on that device.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (
    ModelConfig,
    apply_norm,
    embed_tokens,
    init_embed,
    init_norm,
    unembed,
)
from repro_torch.sharding import context as sharding_ctx

LayerSpec = tuple[str, str]  # (mixer, ffn)

# ============================================================ layer specs ===
def layer_specs(cfg: ModelConfig) -> tuple[LayerSpec, ...]:
    specs = []
    for i, mixer in enumerate(cfg.layer_kinds):
        if mixer == "ssm":
            ffn = "none"
        elif cfg.moe is not None and i >= cfg.moe.first_dense_layers:
            ffn = "moe"
        else:
            ffn = "glu"
        specs.append((mixer, ffn))
    return tuple(specs)


class ScanGroups(NamedTuple):
    prologue: tuple[LayerSpec, ...]
    period: tuple[LayerSpec, ...]   # specs of one scanned super-layer
    n_periods: int
    epilogue: tuple[LayerSpec, ...]


def scan_groups(cfg: ModelConfig) -> ScanGroups:
    """The reference's grouping of the layer list (its pytree layout)."""
    specs = layer_specs(cfg)
    n = len(specs)
    n_pro = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    period_len = len(cfg.pattern) if cfg.pattern else 1
    if not cfg.scan_layers:
        return ScanGroups(specs, (), 0, ())
    n_main = ((n - n_pro) // period_len) * period_len
    n_periods = n_main // period_len
    period = specs[n_pro: n_pro + period_len] if n_periods else ()
    return ScanGroups(prologue=specs[:n_pro], period=tuple(period),
                      n_periods=n_periods,
                      epilogue=specs[n_pro + n_main:])


# ================================================================= init =====
def _init_layer(cfg: ModelConfig, spec: LayerSpec, gen, device) -> dict:
    mixer, ffn = spec
    p: dict[str, Any] = {"pre_norm": init_norm(cfg, device)}
    if mixer in ("attn", "attn_local"):
        p["attn"] = attn.init_attention(cfg, gen, device)
    elif mixer == "mla":
        p["attn"] = attn.init_mla(cfg, gen, device)
    elif mixer == "ssm":
        p["mixer"] = rec_mod.init_mamba2(cfg, gen, device)
    elif mixer == "rec":
        p["mixer"] = rec_mod.init_rglru(cfg, gen, device)
    else:
        raise ValueError(f"unknown mixer {mixer}")
    if ffn != "none":
        p["post_norm"] = init_norm(cfg, device)
    if ffn == "glu":
        # MoE models' dense layers (deepseek's layer 0) have their own width
        d_ff = cfg.moe.d_ff_dense if cfg.moe is not None else cfg.d_ff
        p["mlp"] = ffn_mod.init_mlp(cfg, gen, device, d_ff=d_ff)
    elif ffn == "moe":
        p["moe"] = ffn_mod.init_moe(cfg, gen, device)
    return p


def generator(seed: int | torch.Generator, device: torch.device):
    """The generator a seed names on ``device`` (``None`` on ``meta``)."""
    if isinstance(seed, torch.Generator):
        return seed
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(int(seed))


def init_params(cfg: ModelConfig, seed: int | torch.Generator = 0,
                device=None, *, cast: bool = False) -> dict:
    """Random parameters: ``{"embed", "final_norm", "blocks": [layer, ...]}``
    drawn from ``seed`` (or the given generator) on ``device`` (CUDA unless
    named; ``"meta"`` gives shapes only).  ``cast=True`` gives
    :func:`cast_params` of the same tree, each layer cast as soon as it is
    drawn, so the float32 tree never exists whole (deepseek-moe-16b's is
    65.5 GB)."""
    dev = resolve_device(device)
    gen = generator(seed, dev)
    keep = (lambda t: cast_params(cfg, t)) if cast else (lambda t: t)
    return {"embed": keep(init_embed(cfg, gen, dev)),
            "final_norm": init_norm(cfg, dev),
            "blocks": [keep(_init_layer(cfg, spec, gen, dev))
                       for spec in layer_specs(cfg)]}


#: matrices the reference reads at float32 somewhere (mamba2's and the
#: RG-LRU's conv weights in decode, the RG-LRU's gate matrices always);
#: :func:`cast_params` leaves them as they are
FLOAT32_LEAVES = frozenset({"conv_w", "w_rec_gate", "w_input_gate"})


def cast_params(cfg: ModelConfig, params):
    """A copy of ``params`` (the whole tree or a subtree, such as one
    layer) with every matrix and bias (each leaf of two or more dims) in
    the activation dtype, except :data:`FLOAT32_LEAVES`: the reference also
    reads those in float32, where a rounded copy would change the numbers.
    The norm scales and the other vectors stay as they are.  The model
    casts weights to the activation dtype at each use, as the reference
    does, so the copy gives the float32 tree's numbers; it only spares the
    casts (and the weight reads they cost) on every step."""
    def cast(tree, name=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v) for v in tree]
        if tree.dim() < 2 or name in FLOAT32_LEAVES:
            return tree
        return tree.to(cfg.activation_dtype)
    return cast(params)


# ================================================================ caches =====
def _init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                      s_max: int, device):
    mixer, _ = spec
    if mixer == "ssm":
        return rec_mod.init_ssm_state(cfg, batch, device)
    if mixer == "rec":
        return rec_mod.init_lru_state(cfg, batch, device)
    if mixer == "mla":
        return attn.init_mla_cache(cfg, batch, s_max, device)
    # local attention only ever needs window+1 positions
    if mixer == "attn_local" and cfg.window is not None:
        s_max = min(s_max, cfg.window + 1)
    return attn.init_kv_cache(cfg, batch, s_max, device)


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device=None) -> list:
    dev = resolve_device(device)
    return [_init_layer_cache(cfg, spec, batch, s_max, dev)
            for spec in layer_specs(cfg)]


# ================================================================ forward ====
def _window_of(cfg: ModelConfig, mixer: str) -> int | None:
    return cfg.window if mixer == "attn_local" else None


def _apply_layer(cfg: ModelConfig, spec: LayerSpec, p: dict, x, positions,
                 cache, mode: str, pos):
    """One layer: returns (x, its new cache, its MoE aux loss or None)."""
    mixer, ffn = spec
    # ZeRO-3's use site (the reference's hooks; the same objects off a mesh)
    p = sharding_ctx.fsdp_use(
        p, cast=cfg.activation_dtype if cfg.cast_weights_on_gather else None)
    if cfg.sequence_parallel and mode == "train":
        x = sharding_ctx.constrain_seq(x)
    else:
        x = sharding_ctx.constrain_batch(x)
    h = apply_norm(cfg, p["pre_norm"], x)
    make_cache = mode == "prefill"
    if mixer == "ssm":
        if mode == "decode":
            y, new_cache = rec_mod.mamba2_decode(cfg, p["mixer"], h, cache)
        else:
            y, new_cache = rec_mod.mamba2_forward(cfg, p["mixer"], h,
                                                  make_cache=make_cache)
    elif mixer == "rec":
        if mode == "decode":
            y, new_cache = rec_mod.rglru_decode(cfg, p["mixer"], h, cache)
        else:
            y, new_cache = rec_mod.rglru_forward(cfg, p["mixer"], h,
                                                 make_cache=make_cache)
    elif mixer == "mla":
        if mode == "decode":
            y, new_cache = attn.mla_decode(cfg, p["attn"], h, pos, cache)
        else:
            y, new_cache = attn.mla_forward(cfg, p["attn"], h, positions,
                                            make_cache=make_cache)
    elif mode == "decode":
        y, new_cache = attn.attention_decode(
            cfg, p["attn"], h, pos, cache, window=_window_of(cfg, mixer))
    else:
        y, new_cache = attn.attention_forward(
            cfg, p["attn"], h, positions, window=_window_of(cfg, mixer),
            make_cache=make_cache)
    x = x + y
    aux = None
    if ffn == "glu":
        x = x + ffn_mod.mlp_forward(cfg, p["mlp"],
                                    apply_norm(cfg, p["post_norm"], x))
    elif ffn == "moe":
        y2, moe_aux = ffn_mod.moe_forward(
            cfg, p["moe"], apply_norm(cfg, p["post_norm"], x),
            dropless=(mode != "train"))
        x = x + y2
        aux = moe_aux["moe_aux"] + moe_aux["router_z"]
    return x, new_cache, aux


def remat_layers(cfg: ModelConfig, mode: str, x: torch.Tensor) -> bool:
    """Whether a pass checkpoints its layers: ``train`` mode on an input
    that carries a gradient, with ``cfg.remat`` other than ``"none"``; an
    inference pass runs its layers as they are."""
    return mode == "train" and cfg.remat != "none" and x.requires_grad


def backbone(cfg: ModelConfig, params: dict, x: torch.Tensor,
             positions: torch.Tensor, cache: list | None = None,
             mode: str = "train", pos: torch.Tensor | None = None):
    """Shared trunk: embeddings already applied; returns (x, caches, aux).
    ``aux`` sums the MoE layers' auxiliary losses (load balance and router
    z), in layer order; zero without MoE layers."""
    new_cache = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat_layers(cfg, mode, x)
    for i, spec in enumerate(layer_specs(cfg)):
        if remat:
            x, nc, a = checkpoint(_apply_layer, cfg, spec,
                                  params["blocks"][i], x, positions, None,
                                  mode, pos, use_reentrant=False)
            new_cache.append(nc)
            if a is not None:
                aux = aux + a
            continue
        x, nc, a = _apply_layer(cfg, spec, params["blocks"][i], x, positions,
                                None if cache is None else cache[i], mode,
                                pos)
        new_cache.append(nc)
        if a is not None:
            aux = aux + a
    x = apply_norm(cfg, params["final_norm"], x)
    keep = mode not in ("train", "eval")
    return x, (new_cache if keep else None), aux


def _emb(params: dict, cfg: ModelConfig, out: bool = False) -> dict:
    """The embed table's leaf that the input embedding reads (``out``: that
    the unembedding reads) at its gathered use-site sharding (ZeRO-3's use
    point; ``params["embed"]``'s own tensor off a mesh).  Only that leaf
    goes through the hook: the reference gathers the whole table, and its
    lowering drops the gather of the leaf a pass does not read."""
    cast = cfg.activation_dtype if cfg.cast_weights_on_gather else None
    emb = params["embed"]
    name = "unembed" if out and "unembed" in emb else "tokens"
    return sharding_ctx.fsdp_use({"embed": {name: emb[name]}},
                                 cast=cast)["embed"]


def _inputs(params: dict, device, *tensors):
    """Resolve the run's device, check the parameters live there, and move
    the integer inputs onto it."""
    dev = resolve_device(device)
    have = params["embed"]["tokens"].device
    if have.type != dev.type:
        raise ValueError(f"parameters are on {have}, the run on {dev}; "
                         "init or move them onto the run's device")
    return [torch.as_tensor(t, device=have) for t in tensors]


def ce_analytic_cost(cfg: ModelConfig, n_tokens: int, train: bool) -> dict:
    """Exact analytic FLOPs/bytes of the reference's chunked CE (its
    ``lm.ce_analytic_cost``, pure arithmetic), which the roofline
    (:mod:`repro_torch.analysis.roofline`) uses to correct the dry-run's
    count-the-loop-body-once accounting of the loss scan."""
    d, v = cfg.d_model, cfg.vocab_size
    passes = 3.0 if train else 1.0        # fwd + (dx, dW) matmuls in bwd
    flops = passes * 2.0 * n_tokens * d * v
    # logits materialised once fwd (+ once recomputed, + softmax read) in f32
    bytes_ = (4.0 if train else 2.0) * n_tokens * v * 4.0
    return {"flops": flops, "bytes": bytes_}


# ================================================================ entry ======
def forward(cfg: ModelConfig, params: dict, tokens, positions=None,
            eval_mode: bool = False, *, device=None):
    """Full forward: tokens (B, S) → logits (B, S, V) + aux loss.
    ``eval_mode=True`` routes MoE layers dropless (as prefill and decode
    do); training mode keeps the capacity-bounded routing."""
    (tokens,) = _inputs(params, device, tokens)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, s)
    x = embed_tokens(cfg, _emb(params, cfg), tokens)
    x, _, aux = backbone(cfg, params, x, positions,
                         mode="eval" if eval_mode else "train")
    return unembed(cfg, _emb(params, cfg, out=True), x), aux


#: sequence-chunk length of the cross-entropy: the (B, chunk, V) float32
#: logits are the only vocab-sized activation, recomputed in the backward
LOSS_CHUNK = 512


def _ce_chunk(cfg: ModelConfig, embed_params: dict, x: torch.Tensor,
              labels: torch.Tensor):
    """One chunk's (sum of NLL over valid labels, valid count, hits).  The
    target logit comes from a masked reduce over the vocab axis, as the
    reference's vocab-parallel CE takes it; ``argmax`` picks the first
    index on ties, as ``jnp.argmax`` does."""
    logits = unembed(cfg, embed_params, x).float()
    valid = labels >= 0
    lab = torch.where(valid, labels, 0)
    lse = torch.logsumexp(logits, dim=-1)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    tgt = torch.where(iota == lab[..., None], logits, 0.0).sum(dim=-1)
    nll = lse - tgt
    hit = (torch.argmax(logits, dim=-1) == lab) & valid
    return (torch.where(valid, nll, 0.0).sum(), valid.sum(dtype=torch.int32),
            hit.sum(dtype=torch.int32))


def _chunked_ce(cfg: ModelConfig, embed_params: dict, x: torch.Tensor,
                labels: torch.Tensor):
    """Cross-entropy without the (B, S, V) logits: the final hidden states
    go through :data:`LOSS_CHUNK`-token chunks (the whole sequence when
    ``S`` does not divide), each chunk's float32 logits recomputed in the
    backward (``torch.utils.checkpoint``).  Returns ``(sum_nll, n_valid,
    n_correct)``."""
    s = x.shape[1]
    chunk = min(LOSS_CHUNK, s)
    if s % chunk:
        chunk = s
    sum_nll = torch.zeros((), dtype=torch.float32, device=x.device)
    n_valid = torch.zeros((), dtype=torch.int32, device=x.device)
    n_hit = torch.zeros((), dtype=torch.int32, device=x.device)
    for c0 in range(0, s, chunk):
        xc, lc = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if xc.requires_grad:
            nll, nv, nh = checkpoint(_ce_chunk, cfg, embed_params, xc, lc,
                                     use_reentrant=False)
        else:
            nll, nv, nh = _ce_chunk(cfg, embed_params, xc, lc)
        sum_nll, n_valid, n_hit = sum_nll + nll, n_valid + nv, n_hit + nh
    return sum_nll, n_valid, n_hit


def ce_metrics(sum_nll, n_valid, n_hit, aux):
    """``(loss, {"ce", "aux", "accuracy"})`` from the chunked CE's sums and
    the auxiliary loss, as the reference's ``loss_fn`` forms them."""
    n_valid = torch.clamp(n_valid, min=1)
    ce = sum_nll / n_valid
    return ce + aux, {"ce": ce, "aux": aux, "accuracy": n_hit / n_valid}


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *, device=None):
    """Causal LM loss; ``batch = {"tokens": (B, S), "labels": (B, S)}``
    with ``-1`` labels as padding.  Returns ``(ce + aux, {"ce", "aux",
    "accuracy"})``, float32 0-d tensors; MoE layers route with capacity
    (``dropless=False``), as in the reference's training."""
    tokens, labels = _inputs(params, device, batch["tokens"],
                             batch["labels"])
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    x = embed_tokens(cfg, _emb(params, cfg), tokens)
    x, _, aux = backbone(cfg, params, x, positions, mode="train")
    x = sharding_ctx.constrain_batch(x)   # CE chunks re-split the seq dim
    return ce_metrics(*_chunked_ce(cfg, _emb(params, cfg, out=True), x,
                                  labels), aux)


def prefill(cfg: ModelConfig, params: dict, tokens, s_max: int | None = None,
            *, device=None):
    """Prefill: returns (logits of the last position (B, 1, V), caches
    padded to ``s_max``)."""
    (tokens,) = _inputs(params, device, tokens)
    b, s = tokens.shape
    s_max = s_max or s
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    x = embed_tokens(cfg, _emb(params, cfg), tokens)
    x, caches, _ = backbone(cfg, params, x, positions, mode="prefill")
    logits = unembed(cfg, _emb(params, cfg, out=True), x[:, -1:, :])
    if s_max > s:
        caches = _pad_caches(cfg, caches, s, s_max)
    return logits, caches


def _pad_caches(cfg: ModelConfig, caches: list, s: int, s_max: int) -> list:
    """Zero-pad the attention caches' sequence axis (axis 1 of every
    ``KVCache`` leaf whose length there is ``s``) to ``s_max``; this also
    pads a ring cache whose length happens to be ``s``, as the reference
    does.  Recurrent states stay untouched, as the reference's comment says
    they do: its rule pads any leaf with ``s`` on that axis, so it also
    pads an SSD state when ``s`` equals the head count or a conv buffer
    when ``s`` equals ``d_conv - 1``, and its next decode step raises
    (ROADMAP C3)."""
    def pad(leaf):
        if leaf is not None and leaf.dim() >= 3 and leaf.shape[1] == s:
            widths = [0, 0] * (leaf.dim() - 2) + [0, s_max - s]
            return F.pad(leaf, widths)
        return leaf
    return [KVCache(*(pad(leaf) for leaf in c)) if isinstance(c, KVCache)
            else c for c in caches]


def decode_step(cfg: ModelConfig, params: dict, tokens, pos, cache: list,
                *, device=None):
    """One decode step: tokens (B, 1), pos (B,) → (logits (B, 1, V), cache).
    The attention caches are updated in place, the recurrent states
    replaced; the new list is returned."""
    tokens, pos = _inputs(params, device, tokens, pos)
    x = embed_tokens(cfg, _emb(params, cfg), tokens)
    x, new_cache, _ = backbone(cfg, params, x, pos[:, None], cache=cache,
                               mode="decode", pos=pos)
    return unembed(cfg, _emb(params, cfg, out=True), x), new_cache
