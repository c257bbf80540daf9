"""Model configurations (counterpart of ``repro.configs``): ``base.ModelConfig``,
``ShapeConfig``, ``SHAPES``, ``ARCHS`` and the ``--arch`` registry
``get_config`` / ``get_smoke_config``, with a module for each of the ten
architectures."""

from repro_torch.configs.base import (
    ARCHS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    get_smoke_config,
)

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "get_config", "get_smoke_config"]
