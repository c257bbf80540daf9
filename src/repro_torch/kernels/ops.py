"""Device dispatch for the kernels (counterpart of ``repro.kernels.ops``).

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the kernel's plain PyTorch version.  Nothing else chooses
between them, and no ``try`` falls back from one to the other.  Unlike the
reference there is no padding here: the kernels mask their ragged edges.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import assign_argmin as _assign
from repro_torch.kernels import fourier_sketch as _sketch


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def fourier_sketch_sums(
    x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw fused sums ``(sum b cos(xW) (m,), sum b sin(xW) (m,))`` — the
    engine's batch statistics: no ``1/N``, no stacked-real packaging."""
    if _on_cuda(x):
        return _sketch.fourier_sketch_sums(x, w, beta)
    return _sketch.fourier_sketch_sums_plain(x, w, beta)


def assign_argmin(
    x: torch.Tensor, c: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment: ``(labels (N,) int32, min d^2 (N,) f32)``."""
    if _on_cuda(x):
        return _assign.assign_argmin(x, c)
    return _assign.assign_argmin_plain(x, c)
