"""smollm-360m [dense] llama-arch small [hf:HuggingFaceTB/SmolLM-360M].

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        n_layers=32,
        d_model=960,
        n_heads=15,
        n_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=49152,
        tie_embeddings=True,
        long_context="skip",  # pure full attention
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m-smoke",
        family="dense",
        n_layers=2,
        d_model=60,
        n_heads=3,
        n_kv_heads=1,
        head_dim=20,
        d_ff=128,
        vocab_size=256,
        tie_embeddings=True,
        q_block=32,
        scan_chunk=16,
    )
