"""Whisper-style encoder-decoder, port of ``repro.models.whisper`` (the
audio backbone; the conv frontend is a stub, as in the reference).

Inputs are precomputed frame embeddings ``(B, n_frames, d_model)``.  The
backbone is the reference's: LayerNorm, plain GELU MLPs, learned absolute
positions, bidirectional encoder self-attention, causal decoder
self-attention plus cross-attention, tied token embeddings.  The encoder
self-attention and the cross-attention go through
:func:`repro_torch.kernels.ops.attention` with ``impl=cfg.attn_impl``, so
on the card they run on kernel B3: non-causal over the frames, and at
``Sq = 1`` against the frames in every decode step.

The reference scans both stacks over stacked parameters; here each is a
plain list, ``params["enc"][i]`` and ``params["dec"][i]``, as the port's
:mod:`repro_torch.models.lm` keeps its layers.  The decode cache is a
:class:`WhisperCache` of per-layer lists: each decoder layer's causal KV
cache (written in place by :func:`decode_step`) and the cross-attention
K/V computed once from the encoder output at prefill.  :func:`loss_fn`
is the reference's: the teacher-forced decoder through the shared chunked
cross-entropy (:func:`repro_torch.models.lm._chunked_ce`), with each
encoder and decoder layer checkpointed in training as ``lm``'s are.  Every
entry point runs on the CUDA device unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    ModelConfig,
    _randn,
    apply_norm,
    dense_init,
    init_norm,
)
from repro_torch.models.ffn import init_mlp, mlp_forward
from repro_torch.models.lm import _chunked_ce, _inputs, ce_metrics, \
    generator, remat_layers
from repro_torch.sharding import context as sharding_ctx


class WhisperCache(NamedTuple):
    self_kv: list   # attn.KVCache per decoder layer, (B, S_max, H, hd) leaves
    cross_k: list   # (B, F, H, hd) per decoder layer
    cross_v: list


# ---------------------------------------------------------------- params ----
def _init_cross(cfg: ModelConfig, gen, device) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    w = cfg.weight_dtype
    return {"wq": dense_init(gen, (d, h, hd), d, w, device),
            "wk": dense_init(gen, (d, h, hd), d, w, device),
            "wv": dense_init(gen, (d, h, hd), d, w, device),
            "wo": dense_init(gen, (h, hd, d), h * hd, w, device)}


def _init_enc_layer(cfg: ModelConfig, gen, device) -> dict:
    return {"pre_norm": init_norm(cfg, device),
            "attn": attn.init_attention(cfg, gen, device),
            "post_norm": init_norm(cfg, device),
            "mlp": init_mlp(cfg, gen, device)}


def _init_dec_layer(cfg: ModelConfig, gen, device) -> dict:
    return {"pre_norm": init_norm(cfg, device),
            "attn": attn.init_attention(cfg, gen, device),
            "xattn_norm": init_norm(cfg, device),
            "xattn": _init_cross(cfg, gen, device),
            "post_norm": init_norm(cfg, device),
            "mlp": init_mlp(cfg, gen, device)}


def init_params(cfg: ModelConfig, seed: int | torch.Generator = 0,
                device=None) -> dict:
    """Random parameters: ``{"embed": {"tokens"}, "dec_pos", "enc_pos",
    "final_norm", "enc_final_norm", "enc": [layer, ...], "dec": [layer,
    ...]}`` from ``seed`` (or the given generator) on ``device`` (CUDA
    unless named; ``"meta"`` gives shapes only)."""
    enc = cfg.encoder
    dev = resolve_device(device)
    gen = generator(seed, dev)
    w = cfg.weight_dtype
    d = cfg.d_model
    return {
        "embed": {"tokens": (_randn((cfg.vocab_size, d), gen, dev)
                             * 0.02).to(w)},
        "dec_pos": (_randn((cfg.max_seq_len, d), gen, dev) * 0.01).to(w),
        "enc_pos": (_randn((enc.n_frames, d), gen, dev) * 0.01).to(w),
        "final_norm": init_norm(cfg, dev),
        "enc_final_norm": init_norm(cfg, dev),
        "enc": [_init_enc_layer(cfg, gen, dev) for _ in range(enc.n_layers)],
        "dec": [_init_dec_layer(cfg, gen, dev) for _ in range(cfg.n_layers)],
    }


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


# --------------------------------------------------------------- encoder ----
def _enc_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, positions):
    p = sharding_ctx.fsdp_use(
        p, cast=cfg.activation_dtype if cfg.cast_weights_on_gather else None)
    x = (sharding_ctx.constrain_seq(x) if cfg.sequence_parallel
         else sharding_ctx.constrain_batch(x))
    h = apply_norm(cfg, p["pre_norm"], x)
    y, _ = attn.attention_forward(cfg, p["attn"], h, positions, causal=False)
    x = x + y
    h = apply_norm(cfg, p["post_norm"], x)
    return x + mlp_forward(cfg, p["mlp"], h)


def _encode(cfg: ModelConfig, params: dict, frames: torch.Tensor,
            mode: str = "eval"):
    b, f, _ = frames.shape
    dt = cfg.activation_dtype
    pos_tab = sharding_ctx.fsdp_use({"enc_pos": params["enc_pos"]})["enc_pos"]
    x = frames.to(dt) + pos_tab[None, :f].to(dt)
    positions = _positions(b, f, x.device)
    remat = remat_layers(cfg, mode, x)
    for p in params["enc"]:
        if remat:
            x = checkpoint(_enc_layer, cfg, p, x, positions,
                           use_reentrant=False,
                           context_fn=sharding_ctx.remat_context)
        else:
            x = _enc_layer(cfg, p, x, positions)
    return apply_norm(cfg, params["enc_final_norm"], x)


def encode(cfg: ModelConfig, params: dict, frames, *,
           device=None) -> torch.Tensor:
    """frames (B, F, d_model) precomputed embeddings (the stub frontend) →
    the encoder's output (B, F, d_model)."""
    (frames,) = _inputs(params, device, frames)
    return _encode(cfg, params, frames)


def _cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     enc_k: torch.Tensor, enc_v: torch.Tensor):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    o = ops.attention(q.transpose(1, 2), enc_k.transpose(1, 2),
                      enc_v.transpose(1, 2), causal=False,
                      impl=cfg.attn_impl).transpose(1, 2)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(dt))


def _enc_kv(cfg: ModelConfig, p: dict, enc_out: torch.Tensor):
    dt = enc_out.dtype
    k = torch.einsum("bfd,dhk->bfhk", enc_out, p["wk"].to(dt))
    v = torch.einsum("bfd,dhk->bfhk", enc_out, p["wv"].to(dt))
    return k, v


# --------------------------------------------------------------- decoder ----
def _embed_dec(cfg: ModelConfig, params: dict, tokens, positions):
    dt = cfg.activation_dtype
    emb = sharding_ctx.fsdp_use({"embed": params["embed"],
                                 "dec_pos": params["dec_pos"]})
    x = emb["embed"]["tokens"].to(dt)[tokens]
    return x + emb["dec_pos"].to(dt)[positions]


def _dec_layer(cfg: ModelConfig, p: dict, x, positions, enc_out, mode: str,
               pos, cache, s_max=None):
    """One decoder layer in train/prefill/decode mode; returns (x, its
    cache: ``(self KVCache, (cross_k, cross_v))`` or None in train)."""
    p = sharding_ctx.fsdp_use(
        p, cast=cfg.activation_dtype if cfg.cast_weights_on_gather else None)
    if mode == "train" and cfg.sequence_parallel:
        x = sharding_ctx.constrain_seq(x)
    elif mode != "decode":
        x = sharding_ctx.constrain_batch(x)
    h = apply_norm(cfg, p["pre_norm"], x)
    new_cache = None
    if mode == "decode":
        self_kv, (ck, cv) = cache
        y, self_kv = attn.attention_decode(cfg, p["attn"], h, pos, self_kv)
        x = x + y
        h = apply_norm(cfg, p["xattn_norm"], x)
        x = x + _cross_attention(cfg, p["xattn"], h, ck, cv)
        new_cache = (self_kv, (ck, cv))
    else:
        y, kv = attn.attention_forward(cfg, p["attn"], h, positions,
                                       causal=True,
                                       make_cache=(mode == "prefill"))
        x = x + y
        h = apply_norm(cfg, p["xattn_norm"], x)
        ek, ev = _enc_kv(cfg, p["xattn"], enc_out)
        x = x + _cross_attention(cfg, p["xattn"], h, ek, ev)
        if mode == "prefill":
            pad = (0, 0, 0, 0, 0, s_max - kv.k.shape[1])
            kv = attn.KVCache(k=F.pad(kv.k, pad), v=F.pad(kv.v, pad))
            new_cache = (kv, (ek, ev))
    h = apply_norm(cfg, p["post_norm"], x)
    return x + mlp_forward(cfg, p["mlp"], h), new_cache


def _logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,vd->bsv", x,
                        params["embed"]["tokens"].to(x.dtype))


def _trunk(cfg: ModelConfig, params: dict, frames, tokens) -> torch.Tensor:
    """Teacher-forced decoder trunk → final hidden states (B, S, D)."""
    enc_out = _encode(cfg, params, frames, mode="train")
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = _embed_dec(cfg, params, tokens, positions)
    remat = remat_layers(cfg, "train", x)
    for p in params["dec"]:
        if remat:
            x, _ = checkpoint(_dec_layer, cfg, p, x, positions, enc_out,
                              "train", None, None, use_reentrant=False,
                              context_fn=sharding_ctx.remat_context)
        else:
            x, _ = _dec_layer(cfg, p, x, positions, enc_out, "train", None,
                              None)
    return apply_norm(cfg, params["final_norm"], x)


def decode_train(cfg: ModelConfig, params: dict, frames, tokens, *,
                 device=None) -> torch.Tensor:
    """Teacher-forced decoder over the encoder output → logits (B, S, V)."""
    frames, tokens = _inputs(params, device, frames, tokens)
    return _logits(params, _trunk(cfg, params, frames, tokens))


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *, device=None):
    """The teacher-forced decoder's cross-entropy; ``batch = {"frames": (B,
    F, d_model), "tokens": (B, S), "labels": (B, S)}`` with ``-1`` labels
    as padding.  Returns ``(ce, {"ce", "aux": 0, "accuracy"})``."""
    frames, tokens, labels = _inputs(params, device, batch["frames"],
                                     batch["tokens"], batch["labels"])
    x = _trunk(cfg, params, frames, tokens)
    x = sharding_ctx.constrain_batch(x)
    emb = sharding_ctx.fsdp_use({"embed": params["embed"]})["embed"]
    sums = _chunked_ce(cfg, emb, x, labels)
    return ce_metrics(*sums, torch.zeros((), dtype=torch.float32,
                                         device=x.device))


def prefill(cfg: ModelConfig, params: dict, frames, tokens, s_max: int, *,
            device=None):
    """Encoder plus the teacher-forced prompt: returns (logits of the last
    position (B, 1, V), a :class:`WhisperCache` whose self caches are
    padded to ``s_max``)."""
    frames, tokens = _inputs(params, device, frames, tokens)
    enc_out = _encode(cfg, params, frames)
    b, s = tokens.shape
    if s_max < s:
        raise ValueError(f"s_max {s_max} is shorter than the prompt ({s})")
    positions = _positions(b, s, tokens.device)
    x = _embed_dec(cfg, params, tokens, positions)
    kvs, cks, cvs = [], [], []
    for p in params["dec"]:
        x, (kv, (ck, cv)) = _dec_layer(cfg, p, x, positions, enc_out,
                                       "prefill", None, None, s_max=s_max)
        kvs.append(kv)
        cks.append(ck)
        cvs.append(cv)
    x = apply_norm(cfg, params["final_norm"], x)
    return _logits(params, x[:, -1:]), WhisperCache(kvs, cks, cvs)


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device=None) -> WhisperCache:
    dev = resolve_device(device)
    shape = (batch, cfg.encoder.n_frames, cfg.n_heads, cfg.head_dim)
    act = dict(dtype=cfg.activation_dtype, device=dev)
    return WhisperCache(
        self_kv=[attn.init_kv_cache(cfg, batch, s_max, dev)
                 for _ in range(cfg.n_layers)],
        cross_k=[torch.zeros(shape, **act) for _ in range(cfg.n_layers)],
        cross_v=[torch.zeros(shape, **act) for _ in range(cfg.n_layers)])


def decode_step(cfg: ModelConfig, params: dict, tokens, pos,
                cache: WhisperCache, *, device=None):
    """One decoder token against the cached self and cross K/V: tokens (B,
    1), pos (B,) → (logits (B, 1, V), the cache, its self caches updated
    in place)."""
    tokens, pos = _inputs(params, device, tokens, pos)
    x = _embed_dec(cfg, params, tokens, pos[:, None])
    kvs = []
    for p, kv, ck, cv in zip(params["dec"], cache.self_kv, cache.cross_k,
                             cache.cross_v):
        x, (kv, _) = _dec_layer(cfg, p, x, None, None, "decode", pos,
                                (kv, (ck, cv)))
        kvs.append(kv)
    x = apply_norm(cfg, params["final_norm"], x)
    return _logits(params, x), WhisperCache(kvs, cache.cross_k,
                                            cache.cross_v)
