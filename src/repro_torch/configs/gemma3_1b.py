"""gemma3-1b [dense] [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, 5:1 local:global
sliding-window pattern, 128k-class context.  head_dim=256 (gemma3 heads are
wider than d_model / n_heads).  ``long_context="ckm"``: the 1-in-6 global
layers use the CKM-compressed KV path for long_500k (DESIGN.md §4); local
layers are sub-quadratic by construction (ring window).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab_size=262144,
        mixer_pattern=("local", "local", "local", "local", "local", "attn"),
        mlp_pattern=("dense",) * 6,
        window=512,
        tie_embeddings=True,
        rope_theta=1e6,
        long_context="ckm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b-smoke",
        family="dense",
        n_layers=8,  # 1 full period + 2 remainder layers (exercises "rest")
        d_model=48,
        n_heads=2,
        n_kv_heads=1,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        mixer_pattern=("local", "local", "local", "local", "local", "attn"),
        mlp_pattern=("dense",) * 6,
        window=16,
        tie_embeddings=True,
        q_block=32,
        scan_chunk=16,
        long_context="ckm",
    )
