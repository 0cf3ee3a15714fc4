"""phi3-mini-3.8b — dense decoder, RoPE + SwiGLU, MHA.

[arXiv:2404.14219]  32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.
"""

from repro_torch.models import ModelConfig

ARCH_ID = "phi3-mini-3.8b"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32_064,
        act="silu",
        tie_embeddings=False,
        rope_theta=10_000.0,
        norm="rmsnorm",
        max_seq_len=131_072,
    ).replace(**overrides)


def smoke_config(**overrides) -> ModelConfig:
    return config(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, max_seq_len=256, dtype="float32",
    ).replace(**overrides)
