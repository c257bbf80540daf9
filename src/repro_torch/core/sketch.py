"""The sketching operator ``Sk`` / ``A`` (paper §3.1) — counterpart of
``repro.core.sketch`` (float path).

The sketch of weighted points ``(Y, beta)`` at frequencies ``W`` is

    Sk(Y, beta)_j = sum_l beta_l * exp(-i w_j^T y_l)          (complex, length m)

held in the *stacked-real* form

    z = [ sum_l beta_l cos(Y W) ,  -sum_l beta_l sin(Y W) ]   (real, length 2m)

which preserves the l2 norm.  Every atom ``A delta_c`` has modulus 1 per
frequency, hence norm ``sqrt(m)``.  ``w`` is a ``FrequencyOperator`` or a raw
``(n, m)`` tensor (wrapped in a dense operator).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import freq_ops as fo

__all__ = [
    "sketch",
    "to_complex",
    "from_complex",
    "atom",
    "atoms",
    "atom_norm",
    "data_bounds",
]


def _stacked(cos_part: torch.Tensor, sin_part: torch.Tensor) -> torch.Tensor:
    return torch.cat([cos_part, -sin_part], dim=-1)


def to_complex(z: torch.Tensor) -> torch.Tensor:
    """Stacked-real (…, 2m) -> complex (…, m)."""
    m = z.shape[-1] // 2
    return torch.complex(z[..., :m], z[..., m:])


def from_complex(zc: torch.Tensor) -> torch.Tensor:
    """Complex (…, m) -> stacked-real (…, 2m)."""
    return torch.cat([zc.real, zc.imag], dim=-1)


def sketch(
    x: torch.Tensor,
    w,
    weights: torch.Tensor | None = None,
    chunk: int = 8192,
) -> torch.Tensor:
    """Sketch of points ``x: (N, n)`` at the operator ``w`` -> stacked-real (2m,).

    ``weights`` default to uniform ``1/N``.  Chunked over N with float32
    accumulators, so the ``(N, m)`` projection never materialises; any
    operator works through ``op.apply``.  (The engine's batch sums go through
    the fused kernel instead: ``kernels.ops.fourier_sketch_sums``.)
    """
    op = fo.as_operator(w)
    x = torch.as_tensor(x, dtype=torch.float32)
    n_pts = x.shape[0]
    if weights is None:
        weights = torch.full((n_pts,), 1.0 / n_pts, dtype=torch.float32, device=x.device)
    else:
        weights = torch.as_tensor(weights, dtype=torch.float32)
    cos_acc = torch.zeros((op.m,), dtype=torch.float32, device=x.device)
    sin_acc = torch.zeros_like(cos_acc)
    for start in range(0, n_pts, chunk):
        proj = op.apply(x[start : start + chunk]).to(torch.float32)  # (chunk, m)
        b = weights[start : start + chunk]
        cos_acc = cos_acc + b @ torch.cos(proj)
        sin_acc = sin_acc + b @ torch.sin(proj)
    return _stacked(cos_acc, sin_acc)


def atom(c: torch.Tensor, w) -> torch.Tensor:
    """``A delta_c`` for a single centroid ``c: (n,)`` -> stacked-real ``(2m,)``."""
    proj = fo.as_operator(w).apply(c).to(torch.float32)  # (m,)
    return _stacked(torch.cos(proj), torch.sin(proj))


def atoms(cs: torch.Tensor, w) -> torch.Tensor:
    """``A delta_c`` for centroids ``cs: (S, n)`` -> ``(S, 2m)``."""
    proj = fo.as_operator(w).apply(cs).to(torch.float32)  # (S, m)
    return _stacked(torch.cos(proj), torch.sin(proj))


def atom_norm(m: int) -> float:
    """||A delta_c||_2 — constant: every frequency sample has modulus 1."""
    return math.sqrt(m)


def data_bounds(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-coordinate bounds ``l <= x_i <= u`` — same single pass as the sketch."""
    return torch.amin(x, dim=0), torch.amax(x, dim=0)
