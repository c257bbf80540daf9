"""The frequency-operator contract + registry (counterpart of
``repro.core.freq_ops.base``).

    op.apply(x)      # (..., n) -> (..., m)   Ωᵀx — the projection
    op.adjoint(v)    # (..., m) -> (..., n)   Ωv  — decoder gradients
    op.materialize() # (n, m)                 the dense matrix, on demand
    op.col_norms()   # (m,)                   ||ω_j|| (resolution radii)
    op.spec()        # FreqOpSpec             seed + hyperparameters, O(1)

Operators register a factory function under a name; ``CKMConfig.freq_op`` selects one.

``FreqOpSpec`` is the port's O(1) rebuild recipe: the reference's spec with
the port's own integer seed in place of the JAX threefry key words.
:func:`seeded_operator` draws an operator from a seed on a freshly seeded
CPU ``torch.Generator`` and then moves it to its device, so a spec rebuilds
the same bits on any machine (a CUDA generator's stream differs from the
CPU's); :func:`from_spec` rebuilds one.  Operators built either way record
their spec; any other operator's ``spec()`` raises, as the reference's does
for a wrapped raw matrix.  A port spec does not rebuild the reference's
operator: the two frameworks draw different numbers from one seed.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import device as dev_mod

__all__ = [
    "FreqOpSpec",
    "FrequencyOperator",
    "FREQ_OPS",
    "register_freq_op",
    "get_freq_op",
    "available_freq_ops",
    "make_operator",
    "seeded_operator",
    "from_spec",
    "as_operator",
    "spec_wire_bytes",
    "StackedOperator",
]


class FreqOpSpec(NamedTuple):
    """Plain-scalar description from which an operator rebuilds exactly:
    ``seed`` is the integer its CPU generator was seeded with."""

    name: str
    seed: int
    m: int
    n: int
    sigma2: float
    dist: str = "adapted_radius"
    dtype: str = "float32"


def spec_wire_bytes(spec: FreqOpSpec) -> int:
    """Serialized size of a spec: its strings, an 8-byte seed, ``m``, ``n``
    and a length/tag word (8 bytes each) and the float64 ``sigma2``."""
    return (
        len(spec.name.encode())
        + len(spec.dist.encode())
        + len(spec.dtype.encode())
        + 8  # seed
        + 3 * 8  # m, n + a length/tag word
        + 8  # sigma2
    )


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

    def state_bytes(self) -> int:
        """Bytes of the operator's tensors (what shipping it by value costs)."""
        return sum(v.numel() * v.element_size() for v in vars(self).values()
                   if isinstance(v, torch.Tensor))

    def spec(self) -> FreqOpSpec:
        """The O(1) rebuild recipe; raises for an operator not built from a
        seed (:func:`seeded_operator`, :func:`from_spec`)."""
        spec = getattr(self, "_spec", None)
        if spec is None:
            raise ValueError(
                f"this {self.name} operator has no spec; build it with "
                "freq_ops.seeded_operator(...) to get one"
            )
        return spec

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


def seeded_operator(
    name: str,
    seed: int,
    m: int,
    n: int,
    sigma2,
    *,
    dist: str = "adapted_radius",
    device=dev_mod.DEFAULT,
) -> FrequencyOperator:
    """Build a registered operator from an integer ``seed``: drawn on a CPU
    generator seeded with it, then moved to ``device``.  The operator
    records its :class:`FreqOpSpec`."""
    dev = dev_mod.resolve(device)
    spec = FreqOpSpec(name, int(seed), int(m), int(n), float(sigma2), dist)
    gen = torch.Generator(device="cpu").manual_seed(spec.seed)
    op = make_operator(name, gen, spec.m, spec.n, spec.sigma2, dist=dist, device="cpu")
    op._spec = spec
    return op.to(dev)


def from_spec(spec: FreqOpSpec, device=dev_mod.DEFAULT) -> FrequencyOperator:
    """Rebuild an operator exactly from its spec (same seed, same leaves)."""
    if spec.dtype != "float32":
        raise ValueError(f"the port draws float32 operators, not {spec.dtype}")
    return seeded_operator(spec.name, spec.seed, spec.m, spec.n, spec.sigma2,
                           dist=spec.dist, device=device)


class StackedOperator(NamedTuple):
    """T operators of one family and ``(n, m)``, their tensors stacked along
    a leading tenant axis (``leaves``: ``(w,)`` for the dense family,
    ``(diags, radii, rho)`` for the structured one).  The fleet engine's
    carrier for its kernels; :meth:`tenant` gives one tenant's operator,
    built on views of the stacked tensors."""

    name: str
    n: int
    m: int
    leaves: tuple[torch.Tensor, ...]

    @property
    def tenants(self) -> int:
        return self.leaves[0].shape[0]

    def take(self, ids: torch.Tensor) -> "StackedOperator":
        """The operators of tenants ``ids``, in that order (a gather)."""
        return self._replace(leaves=tuple(leaf[ids] for leaf in self.leaves))

    def tenant(self, t: int, spec: FreqOpSpec | None = None) -> FrequencyOperator:
        leaves = tuple(leaf[t] for leaf in self.leaves)
        if self.name == "dense":
            from repro_torch.core.freq_ops.dense import DenseOperator

            return DenseOperator(*leaves, spec=spec)
        from repro_torch.core.freq_ops.structured import StructuredOperator

        return StructuredOperator(*leaves, self.n, self.m, spec=spec)


def as_operator(w) -> FrequencyOperator:
    """Pass operators through; wrap a raw ``(n, m)`` tensor in a dense operator
    (on the tensor's own device)."""
    if isinstance(w, FrequencyOperator):
        return w
    from repro_torch.core.freq_ops.dense import DenseOperator

    return DenseOperator(torch.as_tensor(w, dtype=torch.float32))
