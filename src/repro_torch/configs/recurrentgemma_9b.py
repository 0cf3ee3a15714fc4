"""recurrentgemma-9b — Griffin hybrid: RG-LRU + local attention, 1:2.

[arXiv:2402.19427]  38L d_model=4096 16H MQA (kv=1) d_ff=12288 vocab=256000,
repeating (rec, rec, local-attn) pattern, window 2048, GeGLU, tied scaled
embeddings.  Windowed attention + diagonal state → runs long_500k.
"""

from repro_torch.models import ModelConfig, RGLRUConfig

ARCH_ID = "recurrentgemma-9b"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256_000,
        act="gelu",
        tie_embeddings=True,
        scale_embed=True,
        rope_theta=10_000.0,
        norm="rmsnorm",
        max_seq_len=1_048_576,
        pattern=("rec", "rec", "attn_local"),
        window=2048,
        rglru=RGLRUConfig(d_rnn=4096, d_conv=4, c=8.0, window=2048),
    ).replace(**overrides)


def smoke_config(**overrides) -> ModelConfig:
    return config(
        n_layers=5, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
        d_ff=128, vocab_size=512, max_seq_len=256, window=32,
        dtype="float32",
        rglru=RGLRUConfig(d_rnn=64, d_conv=4, c=8.0, window=32),
    ).replace(**overrides)
