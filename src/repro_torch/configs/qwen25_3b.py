"""qwen2.5-3b — dense decoder, GQA kv=2, QKV bias.

[hf Qwen/Qwen2.5-3B]  36L d_model=2048 16H (kv=2) d_ff=11008 vocab=151936.
"""

from repro_torch.models import ModelConfig

ARCH_ID = "qwen2.5-3b"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=36,
        d_model=2048,
        n_heads=16,
        n_kv_heads=2,
        head_dim=128,
        d_ff=11008,
        vocab_size=151_936,
        act="silu",
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        norm="rmsnorm",
        max_seq_len=32_768,
    ).replace(**overrides)


def smoke_config(**overrides) -> ModelConfig:
    return config(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, max_seq_len=256, dtype="float32",
    ).replace(**overrides)
