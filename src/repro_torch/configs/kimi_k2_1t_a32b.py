"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table) [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384 experts top-8.
Per the assignment the attention is GQA (the real K2 uses MLA); every layer is
MoE (the real K2's first dense layer / shared expert are elided) — noted in
DESIGN.md §8.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=2048,
        vocab_size=163840,
        mlp_pattern=("moe",),
        moe_experts=384,
        moe_top_k=8,
        q_block=128,  # bounds the f32 score-block transient at 64 heads
        long_context="skip",  # pure full attention
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab_size=256,
        mlp_pattern=("moe",),
        moe_experts=8,
        moe_top_k=2,
        moe_capacity_factor=8.0,
        q_block=32,
        scan_chunk=16,
    )
