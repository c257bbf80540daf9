"""Carry the reference's values into the port.

What both packages must share to compute the same thing is the frequency
operator (a dense matrix, or the structured operator's signs and radii), the
quantizer's dither, the sketch state (float or quantized) and, for Lloyd,
the starting centroids; for the LM, its parameters and its decode cache.
Each function takes the reference's value as a numpy array (``np.asarray``
of a JAX array; a tree of them for the LM) and returns the port's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch import device as dev_mod
from repro_torch.core import quantize as qz
from repro_torch.core.engine import (
    DecayedQuantizedSketchEngineState,
    DecayedSketchEngineState,
    QuantizedSketchEngineState,
    SketchEngineState,
)
from repro_torch.core.freq_ops import DenseOperator, StackedOperator, StructuredOperator

_STATE_TYPES = (SketchEngineState, QuantizedSketchEngineState, DecayedSketchEngineState,
                DecayedQuantizedSketchEngineState)


def _f32(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(dev)


def operator_from_numpy(w: np.ndarray, device=dev_mod.DEFAULT) -> DenseOperator:
    """A reference ``(n, m)`` frequency matrix -> the port's dense operator."""
    w = np.asarray(w)
    if w.ndim != 2:
        raise ValueError(f"expected an (n, m) frequency matrix, got shape {w.shape}")
    return DenseOperator(_f32(w, dev_mod.resolve(device)))


def structured_operator_from_numpy(
    diags, radii, rho, n: int, m: int, device=dev_mod.DEFAULT
) -> StructuredOperator:
    """A reference ``StructuredOperator``'s ``diags (nblocks, 3, d)``,
    ``radii`` and ``rho (nblocks, d)`` -> the port's operator."""
    dev = dev_mod.resolve(device)
    return StructuredOperator(_f32(diags, dev), _f32(radii, dev), _f32(rho, dev), int(n), int(m))


def quantizer_from_numpy(bits: int, dither, device=dev_mod.DEFAULT) -> qz.SketchQuantizer:
    """A reference ``SketchQuantizer``'s bits and ``(m,)`` dither -> the port's."""
    dither = np.asarray(dither)
    if dither.ndim != 1:
        raise ValueError(f"expected an (m,) dither, got shape {dither.shape}")
    if not 1 <= int(bits) <= 16:
        raise ValueError(f"bits must be in 1..16, got {bits}")
    return qz.SketchQuantizer(int(bits), _f32(dither, dev_mod.resolve(device)))


def _check_state(state) -> None:
    acc, n = state[0].shape, state.lower.shape
    if (
        state[1].shape != acc or state.upper.shape != n or len(acc) != 1 or len(n) != 1
        or state.weight_sum.ndim or state.count.ndim
    ):
        raise ValueError(
            "inconsistent state shapes: "
            + ", ".join(f"{f}={tuple(getattr(state, f).shape)}" for f in state._fields)
        )


def state_from_numpy(
    cos_acc, sin_acc, weight_sum, lower, upper, count, device=dev_mod.DEFAULT
) -> SketchEngineState:
    """The fields of a reference ``SketchEngineState`` -> the port's state."""
    dev = dev_mod.resolve(device)
    state = SketchEngineState(
        *(_f32(a, dev) for a in (cos_acc, sin_acc, weight_sum, lower, upper, count))
    )
    _check_state(state)
    return state


def quantized_state_from_numpy(
    qcos_acc, qsin_acc, weight_sum, lower, upper, count, device=dev_mod.DEFAULT
) -> QuantizedSketchEngineState:
    """The fields of a reference ``QuantizedSketchEngineState`` -> the port's
    (int32 accumulators, float32 rest)."""
    dev = dev_mod.resolve(device)

    def i32(a):
        return torch.from_numpy(np.array(a, dtype=np.int32, copy=True)).to(dev)

    state = QuantizedSketchEngineState(
        i32(qcos_acc), i32(qsin_acc), *(_f32(a, dev) for a in (weight_sum, lower, upper, count))
    )
    _check_state(state)
    return state


def centroids_from_numpy(c: np.ndarray, device=dev_mod.DEFAULT) -> torch.Tensor:
    """Reference ``(K, n)`` centroids -> a float32 tensor on ``device``."""
    c = np.asarray(c)
    if c.ndim != 2:
        raise ValueError(f"expected (K, n) centroids, got shape {c.shape}")
    return _f32(c, dev_mod.resolve(device))


def fleet_state_from_numpy(state, device=dev_mod.DEFAULT):
    """A reference fleet's stacked state (any of its four flavours: a named
    tuple whose fields are array-likes with a leading tenant axis) -> the
    port's stacked state of the same flavour (int32 code sums, float32
    rest)."""
    fields = tuple(state._fields)
    cls = next((c for c in _STATE_TYPES if c._fields == fields), None)
    if cls is None:
        raise ValueError(f"no port state has the fields {fields}")
    dev = dev_mod.resolve(device)
    leaves = [np.asarray(getattr(state, f)) for f in fields]
    tenants = leaves[0].shape[0] if leaves[0].ndim else None
    if tenants is None or any(a.ndim < 1 or a.shape[0] != tenants for a in leaves):
        raise ValueError(
            "fleet state leaves must share a leading tenant axis: "
            + ", ".join(f"{f}={a.shape}" for f, a in zip(fields, leaves))
        )
    return cls(*(
        torch.from_numpy(np.array(a, dtype=np.int32 if f.startswith("q") else np.float32,
                                  copy=True)).to(dev)
        for f, a in zip(fields, leaves)
    ))


def stacked_operator_from_numpy(
    name: str, leaves, n: int, m: int, device=dev_mod.DEFAULT
) -> StackedOperator:
    """T reference operators, as their stacked numpy leaves -> the port's
    stacked operator: ``"dense"`` takes ``(w (T, n, m),)``, ``"structured"``
    ``(diags (T, nblocks, 3, d), radii (T, nblocks, d), rho (T, nblocks,
    d))``.  ``FleetEngine`` takes it as its operators."""
    dev = dev_mod.resolve(device)
    stacked = StackedOperator(name, int(n), int(m), tuple(_f32(a, dev) for a in leaves))
    if name not in ("dense", "structured") or len(stacked.leaves) != (1 if name == "dense" else 3):
        raise ValueError(f"expected the leaves of 'dense' or 'structured' operators, got {name!r} "
                         f"with {len(stacked.leaves)} leaves")
    stacked.tenant(0)  # the family's own shape checks
    return stacked


def _lm_tree(tree: dict, cfg, dev: torch.device) -> dict:
    """A reference LM tree (parameters or cache: ``groups`` leaves stacked on
    a leading group axis, ``rest`` unstacked) -> the port's (``groups`` a
    list of one dict a group), every leaf a tensor of its numpy dtype."""

    def leaves(t, pick=lambda a: a):
        return tree_map(lambda a: torch.from_numpy(np.array(pick(np.asarray(a)))).to(dev), t)

    n_groups = cfg.n_layers // cfg.period
    out = {k: leaves(v) for k, v in tree.items() if k != "groups"}
    out["groups"] = [leaves(tree["groups"], lambda a, g=g: a[g]) for g in range(n_groups)]
    return out


def lm_params_from_numpy(tree: dict, cfg, device=dev_mod.DEFAULT) -> dict:
    """The reference's ``init_lm`` tree as numpy -> the port's parameters:
    each ``groups`` leaf unstacked along its group axis, the ``rest`` layers
    in their order.  A tied model (``cfg.tie_embeddings``) has no head: its
    logits come from the embedding table."""
    if cfg.tie_embeddings == ("lm_head" in tree):
        raise ValueError(f"tie_embeddings={cfg.tie_embeddings} but the tree "
                         f"{'has' if 'lm_head' in tree else 'lacks'} an lm_head")
    return _lm_tree(tree, cfg, dev_mod.resolve(device))


def lm_cache_from_numpy(tree: dict, cfg, device=dev_mod.DEFAULT) -> dict:
    """The reference's decode cache (``init_cache`` or ``prefill``'s) as
    numpy -> the port's, unstacked as ``lm_params_from_numpy`` does."""
    return _lm_tree(tree, cfg, dev_mod.resolve(device))
