"""Model configurations (counterpart of ``repro.configs``): ``base.ModelConfig``,
``ShapeConfig``, ``SHAPES``, ``ARCHS`` and the ``--arch`` registry
``get_config`` / ``get_smoke_config``.  The port holds the dense family's
files (``llama3_2_1b``, ``gemma3_1b``, ``smollm_360m``,
``mistral_large_123b``); the other families' architectures raise
``NotImplementedError`` until their models are ported."""

from repro_torch.configs.base import (
    ARCHS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    get_smoke_config,
)

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "get_config", "get_smoke_config"]
