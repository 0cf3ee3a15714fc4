"""Uniform model-family interface, port of ``repro.models.registry``.

``family_of(cfg)`` returns a :class:`Family` whose members hide the
decoder-only vs encoder-decoder split from the launcher, the trainer
and the serving runtime.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import lm, whisper
from repro_torch.models.common import ModelConfig


class Family(NamedTuple):
    init_params: Callable      # (cfg, seed, device) -> params
    loss_fn: Callable          # (cfg, params, batch) -> (loss, metrics)
    prefill: Callable          # (cfg, params, <inputs>) -> (logits, cache)
    decode_step: Callable      # (cfg, params, tokens, pos, cache) -> (logits, cache)
    init_cache: Callable       # (cfg, batch, s_max, device) -> cache


_LM = Family(init_params=lm.init_params, loss_fn=lm.loss_fn,
             prefill=lm.prefill,
             decode_step=lm.decode_step, init_cache=lm.init_cache)

_ENCDEC = Family(init_params=whisper.init_params, loss_fn=whisper.loss_fn,
                 prefill=whisper.prefill,
                 decode_step=whisper.decode_step,
                 init_cache=whisper.init_cache)


def family_of(cfg: ModelConfig) -> Family:
    return _ENCDEC if cfg.arch_type == "encdec" else _LM
