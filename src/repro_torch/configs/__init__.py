"""Architecture registry, port of ``repro.configs``: ``--arch <id>`` →
:class:`~repro_torch.models.ModelConfig`.

The config modules are the reference's pure dataclasses, copied; the port
builds and runs every arch.  ``netclone_cluster`` (the DES testbed's
cluster constants) is not a model config and is not in the registry.
"""

from __future__ import annotations

from repro_torch.configs import (
    chameleon_34b,
    codeqwen15_7b,
    deepseek_moe_16b,
    deepseek_v2_lite,
    gemma_7b,
    mamba2_370m,
    phi3_mini,
    qwen25_3b,
    recurrentgemma_9b,
    whisper_tiny,
)
from repro_torch.configs.shapes import SHAPES, SMOKE_SHAPES, ShapeSpec
from repro_torch.models import ModelConfig

_MODULES = {
    m.ARCH_ID: m
    for m in (
        gemma_7b,
        qwen25_3b,
        codeqwen15_7b,
        phi3_mini,
        whisper_tiny,
        deepseek_v2_lite,
        deepseek_moe_16b,
        chameleon_34b,
        mamba2_370m,
        recurrentgemma_9b,
    )
}

ARCHS: tuple[str, ...] = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")
    mod = _MODULES[arch]
    return (mod.smoke_config if smoke else mod.config)(**overrides)


def supported_shapes(arch: str) -> tuple[str, ...]:
    return _MODULES[arch].SUPPORTED_SHAPES


def all_cells(include_skipped: bool = False):
    """Every (arch, shape) cell of the assignment (40 total).

    Yields (arch, shape_name, supported)."""
    for arch in ARCHS:
        sup = supported_shapes(arch)
        for shape in SHAPES:
            if shape in sup or include_skipped:
                yield arch, shape, shape in sup


__all__ = [
    "ARCHS",
    "SHAPES",
    "SMOKE_SHAPES",
    "ShapeSpec",
    "get_config",
    "supported_shapes",
    "all_cells",
]
