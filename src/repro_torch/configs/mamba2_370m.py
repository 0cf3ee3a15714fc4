"""mamba2-370m — attention-free SSM (state-space duality).

[arXiv:2405.21060]  48L d_model=1024, d_state=128, expand=2, headdim=64,
vocab=50280.  Constant-memory decode state → runs the long_500k shape.
"""

from repro_torch.models import ModelConfig, SSMConfig

ARCH_ID = "mamba2-370m"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=0,
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50_280,
        tie_embeddings=True,
        norm="rmsnorm",
        max_seq_len=1_048_576,
        ssm=SSMConfig(d_state=128, expand=2, headdim=64, d_conv=4, chunk=128),
    ).replace(**overrides)


def smoke_config(**overrides) -> ModelConfig:
    return config(
        n_layers=2, d_model=64, vocab_size=512, max_seq_len=256,
        dtype="float32",
        ssm=SSMConfig(d_state=16, expand=2, headdim=16, d_conv=4, chunk=32),
    ).replace(**overrides)
