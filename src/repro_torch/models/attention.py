"""Attention mixers, port of ``repro.models.attention``: MHA/GQA/MQA, global
and sliding-window, and DeepSeek-V2's multi-head latent attention (MLA).

Two execution modes, as in the reference:

* ``train/prefill`` — full-sequence attention via :mod:`repro_torch.kernels.
  ops` (kernel B3 on the card); prefill also returns the populated KV cache;
* ``decode``        — one query token against a padded cache with an explicit
  position mask, in plain torch (an einsum outside any kernel in the
  reference too).

The reference's ``sharding_ctx`` calls are no-ops off a mesh and are
dropped.  Unlike the reference, whose jitted decode donates its cache,
:func:`attention_decode` writes the new token into the cache **in place**
and returns it; so does :func:`mla_decode`.

MLA caches the compressed latent (``kv_lora_rank`` plus the rope dims, 512 +
64 at deepseek-v2-lite's width) instead of expanded K/V, and decodes with
the absorbed-matmul form against it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import (
    MLAConfig,
    ModelConfig,
    apply_rope,
    dense_init,
    rms_norm,
    rope_angles,
)
from repro_torch.sharding import context as sharding_ctx


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, Hkv, D)   [MLA: (B, S_max, R) latent]
    v: torch.Tensor  # (B, S_max, Hkv, D)   [MLA: (B, S_max, dr) rope key]
    # int8-quantised caches (kv_cache_dtype="int8") carry per-(token, head)
    # absmax scales; None for full-precision caches
    k_scale: torch.Tensor | None = None  # (B, S_max, Hkv) f32
    v_scale: torch.Tensor | None = None


def _quantize_kv(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H, D) → int8 values + (B, S, H) absmax scales."""
    tf = t.float()
    scale = torch.amax(torch.abs(tf), dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


# ================================================================ GQA ======
def init_attention(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w = cfg.weight_dtype
    p = {
        "wq": dense_init(gen, (d, h, hd), d, w, device),
        "wk": dense_init(gen, (d, hkv, hd), d, w, device),
        "wv": dense_init(gen, (d, hkv, hd), d, w, device),
        "wo": dense_init(gen, (h, hd, d), h * hd, w, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=w, device=device)
        p["bk"] = torch.zeros((hkv, hd), dtype=w, device=device)
        p["bv"] = torch.zeros((hkv, hd), dtype=w, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=w, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=w, device=device)
    return p


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def attention_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      positions: torch.Tensor, *, window: int | None = None,
                      causal: bool = True, make_cache: bool = False
                      ) -> tuple[torch.Tensor, KVCache | None]:
    """Train / prefill path: x (B, S, D), positions (B, S)."""
    q, k, v = _qkv(cfg, p, x, positions)
    if cfg.pin_attention_heads:
        q = sharding_ctx.constrain_heads(q)
        k = sharding_ctx.constrain_heads(k)
        v = sharding_ctx.constrain_heads(v)
    o = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=causal, window=window,
                      impl=cfg.attn_impl).transpose(1, 2)   # (B, S, H, hd)
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    cache = None
    if make_cache:
        if window is not None:
            # ring layout: slot = position % (window+1); decode continues it
            ring = window + 1
            s = k.shape[1]
            if s <= ring:
                pad = (0, 0, 0, 0, 0, ring - s)
                cache = KVCache(k=torch.nn.functional.pad(k, pad),
                                v=torch.nn.functional.pad(v, pad))
            else:
                slots = torch.arange(s - ring, s, device=k.device) % ring
                kr = torch.zeros((k.shape[0], ring, *k.shape[2:]),
                                 dtype=k.dtype, device=k.device)
                vr = torch.zeros_like(kr)
                kr[:, slots] = k[:, -ring:]
                vr[:, slots] = v[:, -ring:]
                cache = KVCache(k=kr, v=vr)
        elif cfg.kv_cache_dtype == "int8":
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            cache = KVCache(k=kq, v=vq, k_scale=ks, v_scale=vs)
        else:
            cache = KVCache(k=k, v=v)
    return y, cache


def attention_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     pos: torch.Tensor, cache: KVCache, *,
                     window: int | None = None
                     ) -> tuple[torch.Tensor, KVCache]:
    """One decode step: x (B, 1, D), pos (B,) the new token's index.  Writes
    the new KV at ``pos`` (in place) and attends to the prefix.

    Global attention writes slot ``pos`` of a full-length cache; local
    (windowed) attention uses a ring buffer of ``window+1`` slots — slot
    ``pos % ring``.  The slot is clamped into the cache, as the reference's
    ``dynamic_update_slice`` clamps its start index.
    """
    q, k_new, v_new = _qkv(cfg, p, x, pos[:, None])
    b = x.shape[0]
    s_max = cache.k.shape[1]
    ring = window is not None and s_max == window + 1
    slot = (pos % s_max if ring else pos).long().clamp(0, s_max - 1)
    rows = torch.arange(b, device=x.device)
    quantized = cache.k.dtype == torch.int8
    if quantized:
        kq_new, ks_new = _quantize_kv(k_new)
        vq_new, vs_new = _quantize_kv(v_new)
        cache.k[rows, slot] = kq_new[:, 0]
        cache.v[rows, slot] = vq_new[:, 0]
        cache.k_scale[rows, slot] = ks_new[:, 0].to(cache.k_scale.dtype)
        cache.v_scale[rows, slot] = vs_new[:, 0].to(cache.v_scale.dtype)
    else:
        cache.k[rows, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[rows, slot] = v_new[:, 0].to(cache.v.dtype)
    k, v = cache.k, cache.v
    # scores over the padded cache with an explicit validity mask, float32
    # from the storage dtype's exact values (the reference's f32
    # accumulation); int8 caches fold the absmax scales around the einsums
    scale = cfg.head_dim ** -0.5
    group = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, cfg.n_kv_heads, group, cfg.head_dim)
    kk = k.to(x.dtype) if quantized else k
    s = torch.einsum("bhgk,bthk->bhgt", qg.float(), kk.float()) * scale
    if quantized:
        s = s * cache.k_scale.transpose(1, 2)[:, :, None, :]  # (B,Hkv,1,S)
    t = torch.arange(s_max, device=x.device)[None, None, None, :]
    p4 = pos.long()[:, None, None, None]
    if ring:
        # absolute position held by each slot; unwritten slots map below 0
        delta = torch.remainder(p4 - t, s_max)
        valid = (p4 - delta) >= 0
    else:
        valid = t <= p4
        if window is not None:
            valid &= t >= (p4 - window)
    s = torch.where(valid, s, -1e30)
    pr = torch.softmax(s, dim=-1)
    if quantized:
        pr = pr * cache.v_scale.transpose(1, 2)[:, :, None, :]
    pr = pr.to(x.dtype)
    vv = v.to(x.dtype) if quantized else v
    o = torch.einsum("bhgt,bthk->bhgk", pr.float(), vv.float())
    o = o.reshape(b, 1, cfg.n_heads, cfg.head_dim).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return y, cache


def init_kv_cache(cfg: ModelConfig, batch: int, s_max: int,
                  device) -> KVCache:
    shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        i8 = dict(dtype=torch.int8, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        return KVCache(k=torch.zeros(shape, **i8), v=torch.zeros(shape, **i8),
                       k_scale=torch.zeros(shape[:3], **f32),
                       v_scale=torch.zeros(shape[:3], **f32))
    act = dict(dtype=cfg.activation_dtype, device=device)
    return KVCache(k=torch.zeros(shape, **act), v=torch.zeros(shape, **act))


# ================================================================ MLA ======
def init_mla(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    w = cfg.weight_dtype
    qdim = m.qk_nope_dim + m.qk_rope_dim
    r = m.kv_lora_rank
    return {
        "wq": dense_init(gen, (d, h, qdim), d, w, device),
        "w_dkv": dense_init(gen, (d, r), d, w, device),
        "w_kr": dense_init(gen, (d, m.qk_rope_dim), d, w, device),
        "w_uk": dense_init(gen, (r, h, m.qk_nope_dim), r, w, device),
        "w_uv": dense_init(gen, (r, h, m.v_head_dim), r, w, device),
        "wo": dense_init(gen, (h, m.v_head_dim, d), h * m.v_head_dim, w,
                         device),
        "kv_norm": torch.zeros((r,), dtype=w, device=device),
    }


def _mla_q(cfg: ModelConfig, p: dict, x: torch.Tensor,
           positions: torch.Tensor):
    m = cfg.mla
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    cos, sin = rope_angles(positions, m.qk_rope_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_latent(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor):
    """The cached latent ``c_kv`` (B, S, R), zero-centred-RMS-normed, and
    the shared rope key (B, S, dr)."""
    m = cfg.mla
    c_kv = torch.einsum("bsd,dr->bsr", x, p["w_dkv"].to(x.dtype))
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = torch.einsum("bsd,dr->bsr", x, p["w_kr"].to(x.dtype))
    cos, sin = rope_angles(positions, m.qk_rope_dim, cfg.rope_theta)
    return c_kv, apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]


def mla_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor, *, make_cache: bool = False
                ) -> tuple[torch.Tensor, KVCache | None]:
    """Train / prefill: the latent expanded to per-head K/V.  The attention
    is the plain :func:`~repro_torch.kernels.ref.attention_ref`
    (``impl="xla"``) because the reference pins it so: q/k heads of 192
    dims and v heads of 128 are no shape its flash kernel takes, so MLA
    never reaches kernel B3 in either package."""
    m = cfg.mla
    dt = x.dtype
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    c_kv, k_rope = _mla_latent(cfg, p, x, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"].to(dt))
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uv"].to(dt))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], m.qk_rope_dim)], dim=-1)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    o = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=True, sm_scale=scale,
                      impl="xla").transpose(1, 2)
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(dt))
    return y, (KVCache(k=c_kv, v=k_rope) if make_cache else None)


def mla_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, pos: torch.Tensor,
               cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """Absorbed decode: x (B, 1, D) scores against the latent cache directly
    (``W_uk`` folded into the query, ``W_uv`` applied after the weighted
    sum).  Writes the new latent and rope key at ``pos`` in place (clamped
    into the cache, as ``dynamic_update_slice`` clamps); the two score
    products and the latent sum accumulate in float32 from the
    activation-dtype values, as the reference's do."""
    m = cfg.mla
    dt = x.dtype
    b = x.shape[0]
    q_nope, q_rope = _mla_q(cfg, p, x, pos[:, None])
    c_new, kr_new = _mla_latent(cfg, p, x, pos[:, None])
    s_max = cache.k.shape[1]
    slot = pos.long().clamp(0, s_max - 1)
    rows = torch.arange(b, device=x.device)
    cache.k[rows, slot] = c_new[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = kr_new[:, 0].to(cache.v.dtype)
    c_kv, k_rope = cache.k, cache.v
    q_eff = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"].to(dt))
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    s = (torch.einsum("bshr,btr->bhst", q_eff.float(), c_kv.float())
         + torch.einsum("bshr,btr->bhst", q_rope.float(),
                        k_rope.float())) * scale
    t = torch.arange(s_max, device=x.device)[None, None, None, :]
    s = torch.where(t <= pos.long()[:, None, None, None], s, -1e30)
    pr = torch.softmax(s, dim=-1).to(dt)
    o_lat = torch.einsum("bhst,btr->bshr", pr.float(), c_kv.float())
    o = torch.einsum("bshr,rhk->bshk", o_lat.to(dt), p["w_uv"].to(dt))
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(dt))
    return y, cache


def init_mla_cache(cfg: ModelConfig, batch: int, s_max: int,
                   device) -> KVCache:
    """The latent cache; ``kv_cache_dtype`` does not apply to MLA (the
    reference ignores it too)."""
    m = cfg.mla
    act = dict(dtype=cfg.activation_dtype, device=device)
    return KVCache(k=torch.zeros((batch, s_max, m.kv_lora_rank), **act),
                   v=torch.zeros((batch, s_max, m.qk_rope_dim), **act))
