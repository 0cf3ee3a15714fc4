"""gemma-7b — dense decoder, GeGLU, head_dim 256, MHA (kv=16).

[arXiv:2403.08295; hf google/gemma-7b]  28L d_model=3072 16H d_ff=24576
vocab=256000, tied embeddings scaled by sqrt(d_model).
"""

from repro_torch.models import ModelConfig

ARCH_ID = "gemma-7b"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")  # full attention → no long_500k


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256_000,
        act="gelu",                # GeGLU
        tie_embeddings=True,
        scale_embed=True,
        rope_theta=10_000.0,
        norm="rmsnorm",
        max_seq_len=32_768,
    ).replace(**overrides)


def smoke_config(**overrides) -> ModelConfig:
    return config(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=512, max_seq_len=256, dtype="float32",
    ).replace(**overrides)
