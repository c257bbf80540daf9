"""mistral-large-123b [dense] [hf:mistralai/Mistral-Large-Instruct-2407].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b",
        family="dense",
        n_layers=88,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=32768,
        q_block=128,  # bounds the f32 score-block transient at 96 heads
        long_context="skip",  # pure full attention
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=128,
        vocab_size=256,
        q_block=32,
        scan_chunk=16,
    )
