"""Model stack, port of ``repro.models``: the unified config, the decoder
(GQA/MQA attention and MLA, gated or plain MLP and the MoE FFN), the
recurrent mixers (mamba2, RG-LRU) and whisper's encoder-decoder."""

from repro_torch.models.common import (
    EncoderConfig,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    RGLRUConfig,
    SSMConfig,
)
from repro_torch.models import whisper
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
    "whisper",
]
