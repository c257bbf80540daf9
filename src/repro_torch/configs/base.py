"""Model / run configuration dataclasses + the ``--arch`` registry
(counterpart of ``repro.configs.base``, of which ``ModelConfig``,
``ShapeConfig`` and ``SHAPES`` are copies).  Every architecture of
``ARCHS`` has its module here.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # Layer pattern: one period, repeated n_layers // len(pattern) times, the
    # remainder after the groups (models/transformer.py keeps that order).
    # mixer kinds: attn|local|mamba|mlstm|slstm;
    # mlp kinds: dense|moe|none.
    mixer_pattern: tuple[str, ...] = ("attn",)
    mlp_pattern: tuple[str, ...] = ("dense",)
    window: int = 1024  # sliding window for "local" mixers
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    # SSM / recurrent
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    mlstm_heads: int = 4
    # Encoder-decoder (whisper): encoder is an attn-only non-causal stack.
    encoder_layers: int = 0
    # Modality frontend STUB: input_specs() provides precomputed embeddings.
    frontend: Literal["vision", "audio", None] = None
    frontend_len: int = 0
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    q_block: int = 512  # query chunk in lazy-mask attention
    # Attention score storage dtype between the QK^T dot and the softmax
    # fusion.  "f32" is the conservative default; "bf16" halves the dominant
    # HBM term of every train cell (softmax statistics stay f32).
    score_dtype: str = "f32"
    scan_chunk: int = 256  # chunk for recurrent mixers
    # long_500k policy (DESIGN.md §4): subquadratic archs run it; pure
    # full-attention archs skip.  "ckm" = CKM-compressed KV on global layers.
    long_context: Literal["run", "skip", "ckm"] = "skip"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def period(self) -> int:
        assert len(self.mixer_pattern) == len(self.mlp_pattern)
        return len(self.mixer_pattern)

    def layer_kinds(self) -> list[tuple[str, str]]:
        """Per-layer (mixer, mlp) for all n_layers."""
        p = self.period
        return [
            (self.mixer_pattern[i % p], self.mlp_pattern[i % p])
            for i in range(self.n_layers)
        ]

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, hd = self.d_model, self.head_dim_
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for mixer, mlp in self.layer_kinds():
            total += d  # norm1
            if mixer in ("attn", "local"):
                total += d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
            elif mixer == "mamba":
                di = self.ssm_expand * d
                dr = max(d // 16, 1)
                total += (
                    d * 2 * di + self.ssm_conv * di + di
                    + di * (dr + 2 * self.ssm_state) + dr * di + di
                    + di * self.ssm_state + di + di * d
                )
            elif mixer == "mlstm":
                di = self.ssm_expand * d
                total += d * di + 3 * di * di + d * 2 * self.mlstm_heads + d * di + di * d
            elif mixer == "slstm":
                # W (d,4d) + block-diagonal R (H, d/H, 4d/H) + bias
                total += d * 4 * d + d * 4 * d // self.n_heads + 4 * d
            if mlp == "dense":
                total += d + 3 * d * self.d_ff
            elif mlp == "moe":
                total += d + d * self.moe_experts + 3 * d * self.d_ff * self.moe_experts
        if self.encoder_layers:
            total += self.encoder_layers * (
                2 * d + d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
                + 3 * d * self.d_ff
            )
            # decoder cross-attention blocks
            total += self.n_layers * (d + d * hd * (self.n_heads * 2 + self.n_kv_heads * 2))
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.moe_experts == 0:
            return self.param_count()
        full_moe = self.param_count()
        n_moe_layers = sum(1 for _, m in self.layer_kinds() if m == "moe")
        expert_params = 3 * self.d_model * self.d_ff
        inactive = n_moe_layers * (self.moe_experts - self.moe_top_k) * expert_params
        return full_moe - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode", "long_decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "long_decode"),
}

ARCHS = [
    "internvl2-26b",
    "mistral-large-123b",
    "gemma3-1b",
    "smollm-360m",
    "llama3.2-1b",
    "kimi-k2-1t-a32b",
    "granite-moe-1b-a400m",
    "xlstm-125m",
    "whisper-small",
    "jamba-v0.1-52b",
]


def _module(arch: str):
    mod_name = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(arch: str) -> ModelConfig:
    """Load ``src/repro_torch/configs/<arch>.py`` (dashes/dots -> underscores)."""
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
