"""The four canonical input shapes every architecture is exercised with.

``train_*``  lowers ``train_step``; ``prefill_*`` lowers the prefill serve
step; ``decode_*``/``long_*`` lower ``serve_step`` — one new token against a
KV cache of ``seq_len``.  ``long_500k`` requires sub-quadratic attention and
is only run for SSM/hybrid architectures (the skip is recorded in DESIGN.md
§Arch-applicability and in the roofline table).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch          # one new token per sequence
        return self.global_batch * self.seq_len


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

#: reduced shapes for CPU smoke tests (same kinds, tiny extents)
SMOKE_SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 64, 2),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 64, 2),
    "decode_32k": ShapeSpec("decode_32k", "decode", 64, 2),
    "long_500k": ShapeSpec("long_500k", "decode", 128, 1),
}
