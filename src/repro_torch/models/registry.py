"""Uniform model-family interface, port of ``repro.models.registry``.

``family_of(cfg)`` returns the decoder-only LM family; the encoder-decoder
family (whisper) is not ported yet and raises.  The reference's
``loss_fn`` member waits for the training slice (ROADMAP A13).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import lm
from repro_torch.models.common import ModelConfig


class Family(NamedTuple):
    init_params: Callable      # (cfg, seed, device) -> params
    prefill: Callable          # (cfg, params, tokens, s_max) -> (logits, cache)
    decode_step: Callable      # (cfg, params, tokens, pos, cache) -> (logits, cache)
    init_cache: Callable       # (cfg, batch, s_max, device) -> cache


_LM = Family(init_params=lm.init_params, prefill=lm.prefill,
             decode_step=lm.decode_step, init_cache=lm.init_cache)


def family_of(cfg: ModelConfig) -> Family:
    lm.check_supported(cfg)
    return _LM
