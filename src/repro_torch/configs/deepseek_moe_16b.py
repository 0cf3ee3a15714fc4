"""deepseek-moe-16b — fine-grained MoE with standard GQA attention.

[arXiv:2401.06066; hf deepseek-ai/deepseek-moe-16b-base]  28L d_model=2048
16H (kv=16), MoE: 2 shared + 64 routed top-6, expert d_ff=1408, layer 0
dense (d_ff=10944), vocab=102400.
"""

from repro_torch.models import MoEConfig, ModelConfig

ARCH_ID = "deepseek-moe-16b"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=102_400,
        act="silu",
        tie_embeddings=False,
        rope_theta=10_000.0,
        norm="rmsnorm",
        max_seq_len=16_384,
        moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
                      first_dense_layers=1, d_ff_dense=10944),
    ).replace(**overrides)


def smoke_config(**overrides) -> ModelConfig:
    return config(
        n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        vocab_size=512, max_seq_len=256, dtype="float32",
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32,
                      first_dense_layers=1, d_ff_dense=128),
    ).replace(**overrides)
