"""granite-moe-1b-a400m [moe] [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32 experts top-8.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        mlp_pattern=("moe",),
        moe_experts=32,
        moe_top_k=8,
        tie_embeddings=True,
        long_context="skip",  # pure full attention
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab_size=256,
        mlp_pattern=("moe",),
        moe_experts=4,
        moe_top_k=2,
        moe_capacity_factor=8.0,
        tie_embeddings=True,
        q_block=32,
        scan_chunk=16,
    )
