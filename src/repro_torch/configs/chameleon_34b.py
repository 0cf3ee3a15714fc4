"""chameleon-34b — early-fusion VLM decoder (VQ image tokens in-vocab).

[arXiv:2405.09818]  48L d_model=8192 64H (kv=8) d_ff=22016 vocab=65536,
qk-norm for stability.  The VQ-VAE image tokenizer is a STUB per the
assignment: image patches arrive as ordinary token ids inside the 65536
vocab, so the backbone is a plain (large) dense decoder.
"""

from repro_torch.models import ModelConfig

ARCH_ID = "chameleon-34b"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=65_536,
        act="silu",
        qk_norm=True,
        tie_embeddings=False,
        rope_theta=10_000.0,
        norm="rmsnorm",
        max_seq_len=32_768,
    ).replace(**overrides)


def smoke_config(**overrides) -> ModelConfig:
    return config(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=128, vocab_size=512, max_seq_len=256, dtype="float32",
    ).replace(**overrides)
