"""Shared model substrate, port of ``repro.models.common``: the unified
config, norms, activations, RoPE, embeddings and the init helper.

Parameters are plain nested dicts of tensors, as in the reference, so the
reference's names carry across one to one (:mod:`repro_torch.models.
convert`).  Random init draws from an explicit ``torch.Generator``; its
numbers differ from ``jax.random``'s, so tests carry weights across instead
of re-drawing them.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


# ============================================================== configs =====
@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 64
    top_k: int = 6
    n_shared: int = 2
    d_ff_expert: int = 1408
    first_dense_layers: int = 1       # deepseek: layer 0 keeps a dense FFN
    d_ff_dense: int = 10944           # width of those dense layers
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int | None = None    # V2-Lite projects q directly


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    headdim: int = 64
    d_conv: int = 4
    chunk: int = 128


@dataclass(frozen=True)
class RGLRUConfig:
    d_rnn: int = 0                    # 0 → d_model
    d_conv: int = 4
    c: float = 8.0                    # RG-LRU decay sharpness
    window: int = 2048                # local-attention window of attn blocks


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style audio encoder; the conv frontend is a stub — inputs are
    precomputed frame embeddings of shape (B, n_frames, d_model)."""

    n_layers: int = 4
    n_frames: int = 1500


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"          # dense | moe | ssm | hybrid | encdec
    n_layers: int = 4
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    d_ff: int = 2048
    vocab_size: int = 32000
    act: str = "silu"                 # gate activation: silu (SwiGLU) | gelu (GeGLU)
    qkv_bias: bool = False
    qk_norm: bool = False             # chameleon stabilisation
    use_rope: bool = True             # whisper uses learned absolute positions
    gated_ffn: bool = True            # False → plain 2-matmul MLP (whisper)
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scale_embed: bool = False         # gemma multiplies embeds by sqrt(d)
    logit_softcap: float | None = None
    max_seq_len: int = 8192
    # layer pattern for hybrids; None → all "attn" (or all "ssm" for arch ssm)
    pattern: tuple[str, ...] | None = None
    window: int | None = None         # sliding window for "attn_local" layers
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    encoder: EncoderConfig | None = None
    # numerics / compilation
    dtype: str = "bfloat16"           # activation dtype
    param_dtype: str = "float32"
    scan_layers: bool = True
    remat: str = "full"               # none | full — activation checkpointing
    sequence_parallel: bool = True    # shard the residual stream's seq dim
    cast_weights_on_gather: bool = False  # bf16 FSDP all-gathers (§Perf)
    pin_attention_heads: bool = False     # explicit H@model reshard (§Perf)
    kv_cache_dtype: str = "bfloat16"      # "int8" → quantised decode cache
    attn_impl: str = "auto"           # auto | xla | pallas

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer mixer kind string, length n_layers.

        Kinds: ``attn`` (global), ``attn_local`` (windowed), ``mla``,
        ``ssm``, ``rec`` (RG-LRU).  FFN kind is implied: MoE configs use MoE
        FFNs except the first ``first_dense_layers``; ssm/rec layers carry
        their own mixing and (for rec) a dense FFN.
        """
        if self.pattern is not None:
            reps = -(-self.n_layers // len(self.pattern))
            return tuple((self.pattern * reps)[: self.n_layers])
        if self.arch_type == "ssm":
            return ("ssm",) * self.n_layers
        if self.mla is not None:
            return ("mla",) * self.n_layers
        return ("attn",) * self.n_layers

    @property
    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def weight_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def n_params(self) -> int:
        """Parameter count, from the parameter dict built on the ``meta``
        device (shapes only, nothing allocated)."""
        from repro_torch.models.lm import init_params  # lazy, avoids cycle

        params = init_params(self, 0, device="meta")
        return sum(t.numel() for t in _leaves(params))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


# ============================================================ primitives ====
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["scale"], cfg.norm_eps)
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


def init_norm(cfg: ModelConfig, device) -> dict:
    w = dict(dtype=cfg.weight_dtype, device=device)
    if cfg.norm == "rmsnorm":
        return {"scale": torch.zeros((cfg.d_model,), **w)}
    return {"scale": torch.ones((cfg.d_model,), **w),
            "bias": torch.zeros((cfg.d_model,), **w)}


def activation(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------- RoPE ------
def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (B, S) → cos/sin (B, S, dim/2), in float32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) with cos/sin (B, S, D/2) — rotate-half convention,
    computed in float32 and returned in x's dtype."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- embeddings ---
def init_embed(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    emb = _randn((cfg.vocab_size, cfg.d_model), gen, device) * 0.02
    p = {"tokens": emb.to(cfg.weight_dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                  cfg.d_model, cfg.weight_dtype, device)
    return p


def embed_tokens(cfg: ModelConfig, p: dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = p["tokens"].to(cfg.activation_dtype)[tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model),
                             dtype=cfg.activation_dtype, device=x.device)
    return x


def unembed(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, p["tokens"].to(x.dtype))
    else:
        logits = torch.einsum("bsd,dv->bsv", x, p["unembed"].to(x.dtype))
    if cfg.logit_softcap:
        cap = cfg.logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


# ------------------------------------------------------------ init helper ---
def _randn(shape, gen: torch.Generator, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=device)


def dense_init(gen: torch.Generator, shape, in_axis_size: int, dtype,
               device) -> torch.Tensor:
    """Truncated-normal fan-in init (matches common LM practice): a standard
    normal cut at ±2 by inverting the CDF of a uniform draw, times
    ``in_axis_size ** -0.5``."""
    std = in_axis_size ** -0.5
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    lo, hi = (1 + math.erf(-2.0 / math.sqrt(2))) / 2, \
        (1 + math.erf(2.0 / math.sqrt(2))) / 2
    u = torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo
    z = torch.erfinv(2 * u - 1) * math.sqrt(2)
    return (z.clamp(-2.0, 2.0) * std).to(dtype)
