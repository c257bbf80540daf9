"""Carry the reference's values into the port.

This system has no model weights: what both packages must share to compute
the same thing is the frequency matrix and the sketch state (and, for Lloyd,
the starting centroids).  Each function takes the reference's value as a
numpy array (``np.asarray`` of a JAX array) and returns the port's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.core.engine import SketchEngineState
from repro_torch.core.freq_ops import DenseOperator


def _f32(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(dev)


def operator_from_numpy(w: np.ndarray, device=dev_mod.DEFAULT) -> DenseOperator:
    """A reference ``(n, m)`` frequency matrix -> the port's dense operator."""
    w = np.asarray(w)
    if w.ndim != 2:
        raise ValueError(f"expected an (n, m) frequency matrix, got shape {w.shape}")
    return DenseOperator(_f32(w, dev_mod.resolve(device)))


def state_from_numpy(
    cos_acc, sin_acc, weight_sum, lower, upper, count, device=dev_mod.DEFAULT
) -> SketchEngineState:
    """The fields of a reference ``SketchEngineState`` -> the port's state."""
    dev = dev_mod.resolve(device)
    state = SketchEngineState(
        *(_f32(a, dev) for a in (cos_acc, sin_acc, weight_sum, lower, upper, count))
    )
    m, n = state.cos_acc.shape, state.lower.shape
    if state.sin_acc.shape != m or state.upper.shape != n or state.weight_sum.ndim or state.count.ndim:
        raise ValueError(
            "inconsistent state shapes: "
            + ", ".join(f"{f}={tuple(getattr(state, f).shape)}" for f in state._fields)
        )
    return state


def centroids_from_numpy(c: np.ndarray, device=dev_mod.DEFAULT) -> torch.Tensor:
    """Reference ``(K, n)`` centroids -> a float32 tensor on ``device``."""
    c = np.asarray(c)
    if c.ndim != 2:
        raise ValueError(f"expected (K, n) centroids, got shape {c.shape}")
    return _f32(c, dev_mod.resolve(device))
