"""xlstm-125m [ssm] sLSTM + mLSTM blocks [arXiv:2405.04517].

12L d_model=768 4H d_ff=0 vocab=50304.  d_ff=0 -> no separate MLP: the
recurrent blocks carry their own up/down projections.  Alternating
mLSTM / sLSTM (1:1).  Sub-quadratic by construction -> runs long_500k.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        mixer_pattern=("mlstm", "slstm"),
        mlp_pattern=("none", "none"),
        mlstm_heads=4,
        ssm_expand=2,
        tie_embeddings=True,
        long_context="run",  # O(1) recurrent state
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m-smoke",
        family="ssm",
        n_layers=4,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        d_ff=0,
        vocab_size=256,
        mixer_pattern=("mlstm", "slstm"),
        mlp_pattern=("none", "none"),
        mlstm_heads=2,
        ssm_expand=2,
        tie_embeddings=True,
        q_block=32,
        scan_chunk=16,
        long_context="run",
    )
