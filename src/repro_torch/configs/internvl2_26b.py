"""internvl2-26b [vlm]: InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.  The vision frontend
is a STUB per the assignment: input_specs() provides precomputed patch
embeddings (B, 256, d_model) prepended to the token stream.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92553,
        frontend="vision",
        frontend_len=256,
        q_block=256,
        long_context="skip",  # pure full attention (DESIGN.md §4)
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        frontend="vision",
        frontend_len=8,
        q_block=32,
        scan_chunk=16,
    )
