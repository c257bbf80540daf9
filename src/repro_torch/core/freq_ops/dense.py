"""The ``"dense"`` frequency operator — the paper's materialised Ω (counterpart
of ``repro.core.freq_ops.dense``)."""

from __future__ import annotations

import torch

from repro_torch import device as dev_mod
from repro_torch.core import frequencies as freq_mod
from repro_torch.core.freq_ops.base import FrequencyOperator, register_freq_op


class DenseOperator(FrequencyOperator):
    """Ω held as a materialised float32 ``(n, m)`` matrix (column frequencies)."""

    name = "dense"

    def __init__(self, w: torch.Tensor, spec=None):
        if w.ndim != 2:
            raise ValueError(f"dense operator needs an (n, m) matrix, got {tuple(w.shape)}")
        self.w = w
        self._spec = spec

    @property
    def n(self) -> int:
        return self.w.shape[0]

    @property
    def m(self) -> int:
        return self.w.shape[1]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w

    def adjoint(self, v: torch.Tensor) -> torch.Tensor:
        return v @ self.w.T

    def materialize(self) -> torch.Tensor:
        return self.w

    def col_norms(self) -> torch.Tensor:
        return torch.linalg.vector_norm(self.w, dim=0)

    def col_sq_norms(self) -> torch.Tensor:
        return torch.sum(self.w * self.w, dim=0)

    def to(self, device: torch.device) -> "DenseOperator":
        return self if self.w.device == device else DenseOperator(self.w.to(device), self._spec)


@register_freq_op("dense")
def build_dense(
    gen: torch.Generator,
    m: int,
    n: int,
    sigma2,
    *,
    dist: str = "adapted_radius",
    device=dev_mod.DEFAULT,
) -> DenseOperator:
    """Draw the paper's dense Ω (``frequencies.draw_frequencies``)."""
    return DenseOperator(freq_mod.draw_frequencies(gen, m, n, sigma2, dist, device))
