"""jamba-v0.1-52b [hybrid] Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16 experts top-2.
Period-8 block: 1 attention layer per 7 Mamba layers (attn at index 3), MoE
MLP on every second layer.  ``long_context="ckm"``: the 4 attention layers use
CKM-compressed KV for long_500k; Mamba layers carry O(1) state.
"""

from repro_torch.configs.base import ModelConfig

_MIXER = ("mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba", "mamba")
_MLP = ("dense", "moe", "dense", "moe", "dense", "moe", "dense", "moe")


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        mixer_pattern=_MIXER,
        mlp_pattern=_MLP,
        moe_experts=16,
        moe_top_k=2,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        long_context="ckm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke",
        family="hybrid",
        n_layers=8,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        mixer_pattern=_MIXER,
        mlp_pattern=_MLP,
        moe_experts=4,
        moe_top_k=2,
        moe_capacity_factor=8.0,
        ssm_state=4,
        ssm_conv=4,
        ssm_expand=2,
        q_block=32,
        scan_chunk=16,
        long_context="ckm",
    )
