"""The frequency-operator contract + registry (counterpart of
``repro.core.freq_ops.base``).

    op.apply(x)      # (..., n) -> (..., m)   Ωᵀx — the projection
    op.adjoint(v)    # (..., m) -> (..., n)   Ωv  — decoder gradients
    op.materialize() # (n, m)                 the dense matrix, on demand
    op.col_norms()   # (m,)                   ||ω_j|| (resolution radii)

Operators register a factory function under a name; ``CKMConfig.freq_op`` selects one.
The reference's ``FreqOpSpec`` (an O(1) rebuild recipe holding JAX threefry
key words) has no counterpart yet: a torch operator is rebuilt from its seed
through the torch generator, never from the reference's key words.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import device as dev_mod

__all__ = [
    "FrequencyOperator",
    "FREQ_OPS",
    "register_freq_op",
    "get_freq_op",
    "available_freq_ops",
    "make_operator",
    "as_operator",
]


class FrequencyOperator:
    """Abstract linear frequency operator Ω: apply/adjoint/materialize."""

    name: str = "?"

    @property
    def n(self) -> int:
        raise NotImplementedError

    @property
    def m(self) -> int:
        raise NotImplementedError

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """``(..., n) -> (..., m)``: the projection ``Ωᵀx`` (sketch phases)."""
        raise NotImplementedError

    def adjoint(self, v: torch.Tensor) -> torch.Tensor:
        """``(..., m) -> (..., n)``: ``Ωv`` — decoder cost/score gradients."""
        raise NotImplementedError

    def materialize(self) -> torch.Tensor:
        """The dense ``(n, m)`` matrix."""
        raise NotImplementedError

    def col_norms(self) -> torch.Tensor:
        """``(m,)`` frequency magnitudes ``||ω_j||`` (resolution radii)."""
        raise NotImplementedError

    def col_sq_norms(self) -> torch.Tensor:
        """``(m,)`` squared magnitudes."""
        return self.col_norms() ** 2

    def to(self, device: torch.device) -> "FrequencyOperator":
        """The same operator with its tensors on ``device``."""
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{type(self).__name__}(n={self.n}, m={self.m})"


# name -> factory(gen, m, n, sigma2, *, dist, device) -> FrequencyOperator
FREQ_OPS: dict[str, Callable] = {}


def register_freq_op(name: str) -> Callable:
    """Decorator: register an operator *factory* under ``name`` (unique)."""

    def deco(factory: Callable) -> Callable:
        if name in FREQ_OPS:
            raise ValueError(f"frequency operator {name!r} already registered")
        FREQ_OPS[name] = factory
        return factory

    return deco


def get_freq_op(name: str) -> Callable:
    """Look up a registered factory; raises with the available names."""
    try:
        return FREQ_OPS[name]
    except KeyError:
        raise KeyError(
            f"unknown frequency operator {name!r}; available: {sorted(FREQ_OPS)}"
        ) from None


def available_freq_ops() -> list[str]:
    """Sorted names of all registered frequency operators."""
    return sorted(FREQ_OPS)


def make_operator(
    name: str,
    gen: torch.Generator,
    m: int,
    n: int,
    sigma2,
    *,
    dist: str = "adapted_radius",
    device=dev_mod.DEFAULT,
) -> FrequencyOperator:
    """Build a registered operator for ``m`` frequencies in R^n at ``sigma2``."""
    return get_freq_op(name)(gen, m, n, sigma2, dist=dist, device=device)


def as_operator(w) -> FrequencyOperator:
    """Pass operators through; wrap a raw ``(n, m)`` tensor in a dense operator
    (on the tensor's own device)."""
    if isinstance(w, FrequencyOperator):
        return w
    from repro_torch.core.freq_ops.dense import DenseOperator

    return DenseOperator(torch.as_tensor(w, dtype=torch.float32))
