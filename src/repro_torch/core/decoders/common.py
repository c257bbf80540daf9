"""Shared decoder machinery: projected Adam + the sketch-domain objective
(counterpart of ``repro.core.decoders.common``)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import freq_ops as fo
from repro_torch.core import sketch as sk

Params = tuple[torch.Tensor, ...]


def ensure_operator(w, caller: str = "decoder helper") -> fo.FrequencyOperator:
    """Operator pass-through; raw tensors raise (wrap with ``as_operator``)."""
    if not isinstance(w, fo.FrequencyOperator):
        raise TypeError(
            f"{caller} requires a core.freq_ops.FrequencyOperator; wrap a raw "
            "(n, m) tensor with freq_ops.as_operator(w)"
        )
    return w


def adam(
    loss_fn: Callable[[Params], torch.Tensor],
    params: Params,
    steps: int,
    lr: float,
    project: Callable[[Params], Params],
) -> Params:
    """Minimise ``loss_fn`` over a tuple of tensors with projected Adam.

    Gradients come from ``torch.autograd.grad`` on fresh leaves each step; the
    moment updates and the projection run without autograd.
    """
    b1, b2, eps = 0.9, 0.999, 1e-8
    one = np.float32(1.0)
    p = tuple(t.detach() for t in params)
    m = tuple(torch.zeros_like(t) for t in p)
    v = tuple(torch.zeros_like(t) for t in p)
    for i in range(1, steps + 1):
        leaves = tuple(q.detach().requires_grad_(True) for q in p)
        grads = torch.autograd.grad(loss_fn(leaves), leaves)
        with torch.no_grad():
            # Bias corrections in float32 at t = i + 1, as the reference
            # computes them (its scan feeds i = 1..steps and adds one).
            t = np.float32(i + 1)
            mhat_scale = float(one / (one - np.float32(b1) ** t))
            vhat_scale = float(one / (one - np.float32(b2) ** t))
            m = tuple(b1 * m_ + (1 - b1) * g for m_, g in zip(m, grads))
            v = tuple(b2 * v_ + (1 - b2) * g * g for v_, g in zip(v, grads))
            p = tuple(
                p_ - lr * (m_ * mhat_scale) / (torch.sqrt(v_ * vhat_scale) + eps)
                for p_, m_, v_ in zip(p, m, v)
            )
            p = project(p)
    return tuple(t.detach() for t in p)


def residual_cost(
    z: torch.Tensor, centroids: torch.Tensor, alpha: torch.Tensor, w
) -> torch.Tensor:
    """The shared selection objective: ``||z - sum_k alpha_k A delta_{c_k}||^2``."""
    op = ensure_operator(w, "residual_cost")
    r = z - alpha @ sk.atoms(centroids, op)
    return torch.sum(r * r)


def median(v: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values when the length is
    even (``torch.median`` returns the lower one)."""
    s = torch.sort(v.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def resolution_radius(w, scale: float) -> torch.Tensor:
    """The sketch's spatial resolution: ``scale / median ||omega_j||``."""
    op = ensure_operator(w, "resolution_radius")
    return scale / median(op.col_norms())
