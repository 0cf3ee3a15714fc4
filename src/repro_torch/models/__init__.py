"""Model stack, port of ``repro.models``: the unified config, the dense
decoder (GQA/MQA attention, gated or plain MLP) and the recurrent mixers
(mamba2, RG-LRU).  MLA, MoE and whisper's encoder-decoder are still to be
ported (ROADMAP A11)."""

from repro_torch.models.common import (
    EncoderConfig,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    RGLRUConfig,
    SSMConfig,
)
from repro_torch.models.registry import Family, family_of

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "RGLRUConfig",
    "EncoderConfig",
    "Family",
    "family_of",
]
