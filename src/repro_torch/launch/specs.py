"""Shape-only stand-ins for every model input, port of
``repro.launch.specs``: ``meta`` tensors, no device allocation.

``input_specs(cfg, shape)`` returns the tree the corresponding step takes:

* train   → {"tokens": (GB, S) int32, "labels": (GB, S) int32} (+ whisper
  frames (GB, n_frames, d_model) in the activation dtype)
* prefill → {"tokens": (GB, S) int32} (+ frames)
* decode  → {"tokens": (GB, 1) int32, "pos": (GB,) int32, "cache": <the
  family's cache>}

Parameters and caches come from the family's ``init_params`` and
``init_cache`` on the ``meta`` device: the code that builds the real ones,
so the shapes cannot drift from the runtime.
"""

from __future__ import annotations

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import family_of
from repro_torch.models.common import ModelConfig

META = torch.device("meta")


def param_specs(cfg: ModelConfig):
    return family_of(cfg).init_params(cfg, 0, META)


def cache_specs(cfg: ModelConfig, batch: int, s_max: int):
    return family_of(cfg).init_cache(cfg, batch, s_max, META)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    gb, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": _meta((gb, s), i32)}
        if shape.kind == "train":
            specs["labels"] = _meta((gb, s), i32)
        if cfg.arch_type == "encdec":
            specs["frames"] = _meta((gb, cfg.encoder.n_frames, cfg.d_model),
                                    cfg.activation_dtype)
        return specs
    # decode: one new token against an s-long cache
    return {"tokens": _meta((gb, 1), i32), "pos": _meta((gb,), i32),
            "cache": cache_specs(cfg, gb, s)}
