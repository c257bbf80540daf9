"""The decoder registry (counterpart of ``repro.core.decoders.registry``).

A decoder turns a finalized sketch into centroids:

    decode(gen, z, w, lower, upper, cfg, x_init=None)
        -> (centroids (K, n), alphas (K,), cost scalar)

where ``gen`` is the ``torch.Generator`` the decoder draws from (the
reference's PRNG key), ``z`` the stacked-real ``(2m,)`` sketch, ``w`` the
frequency operator, ``(lower, upper)`` the box bounds harvested by the engine
and ``cfg`` a ``ckm.CKMConfig``-shaped object.  ``cost`` is the sketch-domain
objective ``||z - A(C) alpha||^2``, the same for every decoder, so replicate
selection compares like with like.  This slice registers ``"clompr"``.
"""

from __future__ import annotations

from typing import Callable, Protocol

import torch


class Decoder(Protocol):
    """A sketch decoder: ``(gen, z, w, lower, upper, cfg[, x_init])`` ->
    ``(centroids, alphas, cost)``."""

    def __call__(
        self,
        gen: torch.Generator,
        z: torch.Tensor,
        w,
        lower: torch.Tensor,
        upper: torch.Tensor,
        cfg,
        x_init: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]: ...


DECODERS: dict[str, Decoder] = {}


def register_decoder(name: str) -> Callable[[Decoder], Decoder]:
    """Decorator: register ``fn`` under ``name`` (unique, lowercase)."""

    def deco(fn: Decoder) -> Decoder:
        if name in DECODERS:
            raise ValueError(f"decoder {name!r} already registered")
        DECODERS[name] = fn
        return fn

    return deco


def get_decoder(name: str) -> Decoder:
    """Look up a registered decoder; raises with the available names."""
    try:
        return DECODERS[name]
    except KeyError:
        raise KeyError(
            f"unknown decoder {name!r}; available: {sorted(DECODERS)}"
        ) from None


def available_decoders() -> list[str]:
    """Sorted names of all registered decoders."""
    return sorted(DECODERS)
