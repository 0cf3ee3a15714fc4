"""whisper-tiny — encoder-decoder audio backbone; conv frontend stubbed.

[arXiv:2212.04356]  4 enc + 4 dec layers, d_model=384 6H d_ff=1536
vocab=51865, LayerNorm, plain GELU MLPs, learned positions, 1500 frames.

The modality frontend (log-mel + 2×conv) is a STUB per the assignment:
``input_specs`` provides precomputed frame embeddings (B, 1500, 384).
The decoder position table is extended past real Whisper's 448 to honour the
assigned shape set (noted as a deviation in DESIGN.md).
"""

from repro_torch.models import EncoderConfig, ModelConfig

ARCH_ID = "whisper-tiny"
# enc-dec: decode shapes exercise the decoder; full attention → no long_500k
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="encdec",
        n_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51_865,
        act="gelu",
        gated_ffn=False,
        use_rope=False,
        qkv_bias=True,
        tie_embeddings=True,
        norm="layernorm",
        max_seq_len=32_768,
        encoder=EncoderConfig(n_layers=4, n_frames=1500),
        scan_layers=False,          # 4 layers — unrolled
    ).replace(**overrides)


def smoke_config(**overrides) -> ModelConfig:
    return config(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=512, max_seq_len=256, dtype="float32",
        encoder=EncoderConfig(n_layers=2, n_frames=32),
    ).replace(**overrides)
