"""codeqwen1.5-7b — dense decoder, qwen1.5 arch (MHA, QKV bias).

[hf Qwen/CodeQwen1.5-7B]  32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416.
"""

from repro_torch.models import ModelConfig

ARCH_ID = "codeqwen1.5-7b"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,
        d_ff=13440,
        vocab_size=92_416,
        act="silu",
        qkv_bias=True,
        tie_embeddings=False,
        rope_theta=1_000_000.0,
        norm="rmsnorm",
        max_seq_len=65_536,
    ).replace(**overrides)


def smoke_config(**overrides) -> ModelConfig:
    return config(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, max_seq_len=256, dtype="float32",
    ).replace(**overrides)
