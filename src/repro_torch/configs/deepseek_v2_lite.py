"""deepseek-v2-lite-16b — MoE with Multi-head Latent Attention.

[arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2-Lite]  27L d_model=2048 16H,
MLA kv_lora_rank=512 (qk 128+64 rope, v 128), MoE: 2 shared + 64 routed
top-6, expert d_ff=1408, layer 0 dense (d_ff=10944), vocab=102400.

Note: the assignment line carries a "2 shared+160 routed" parenthetical which
matches DeepSeek-V2 *full*, not Lite; we follow the primary spec ("MoE 64e
top-6") and the HF Lite config (64 routed).  Recorded in DESIGN.md.
"""

from repro_torch.models import MLAConfig, MoEConfig, ModelConfig

ARCH_ID = "deepseek-v2-lite-16b"
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        n_layers=27,
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
        max_seq_len=32_768,
        mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
                      first_dense_layers=1, d_ff_dense=10944),
    ).replace(**overrides)


def smoke_config(**overrides) -> ModelConfig:
    return config(
        n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        vocab_size=512, max_seq_len=256, dtype="float32",
        mla=MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                      v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32,
                      first_dense_layers=1, d_ff_dense=128),
    ).replace(**overrides)
