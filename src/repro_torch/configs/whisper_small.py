"""whisper-small [audio] enc-dec, conv frontend (stub) [arXiv:2212.04356].

12L (per stack) d_model=768 12H d_ff=3072 vocab=51865.  The conv/mel frontend
is a STUB: input_specs() provides precomputed frame embeddings (B, 1500, d)
fed to the encoder.  RoPE replaces whisper's absolute embeddings (DESIGN.md
§8).  Enc-dec decodes against cross-attention; long_500k skipped (full
attention decoder).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        encoder_layers=12,
        frontend="audio",
        frontend_len=1500,
        tie_embeddings=True,
        long_context="skip",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        encoder_layers=2,
        frontend="audio",
        frontend_len=12,
        tie_embeddings=True,
        q_block=32,
        scan_chunk=16,
    )
