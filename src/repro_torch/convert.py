"""Carry the reference's values into the port.

What both packages must share to compute the same thing is the frequency
operator (a dense matrix, or the structured operator's signs and radii), the
quantizer's dither, the sketch state (float or quantized) and, for Lloyd,
the starting centroids; for the LM, its parameters and its decode cache;
for training, the optimizer's state and the train state.
Each function takes the reference's value as a numpy array (``np.asarray``
of a JAX array; a tree of them for the LM) and returns the port's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch import device as dev_mod
from repro_torch.core import quantize as qz
from repro_torch.core.distributed_sketch import SketchState
from repro_torch.core.engine import (
    DecayedQuantizedSketchEngineState,
    DecayedSketchEngineState,
    QuantizedSketchEngineState,
    SketchEngineState,
)
from repro_torch.core.freq_ops import DenseOperator, StackedOperator, StructuredOperator
from repro_torch.optim import optimizers as optim

_STATE_TYPES = (SketchEngineState, QuantizedSketchEngineState, DecayedSketchEngineState,
                DecayedQuantizedSketchEngineState)


def _f32(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(dev)


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A copy of ``a`` in its own dtype.  numpy has no bfloat16 of its own
    (JAX's is an extension type torch cannot read), so a bfloat16 array
    goes through float32, which holds each of its values exactly."""
    if a.dtype.name == "bfloat16":
        return _f32(a, dev).to(torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


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
    a leading group axis, ``rest`` unstacked; an encoder's layers stacked in
    ``encoder["groups"]``) -> the port's (each ``groups`` a list of one dict
    a group or encoder layer), every leaf a tensor of its numpy dtype."""

    def leaves(t, pick=lambda a: a):
        return tree_map(lambda a: _tensor(pick(np.asarray(a)), dev), t)

    def unstacked(t, n):
        return [leaves(t, lambda a, g=g: a[g]) for g in range(n)]

    out = {k: leaves(v) for k, v in tree.items() if k not in ("groups", "encoder")}
    out["groups"] = unstacked(tree["groups"], cfg.n_layers // cfg.period)
    if "encoder" in tree:
        out["encoder"] = {"groups": unstacked(tree["encoder"]["groups"], cfg.encoder_layers),
                          "final_norm": leaves(tree["encoder"]["final_norm"])}
    return out


def lm_params_from_numpy(tree: dict, cfg, device=dev_mod.DEFAULT, mesh=None) -> dict:
    """The reference's ``init_lm`` tree as numpy -> the port's parameters:
    each ``groups`` leaf unstacked along its group axis, the ``rest`` layers
    in their order.  A tied model (``cfg.tie_embeddings``) has no head: its
    logits come from the embedding table.  With ``mesh`` (a ``DeviceMesh``)
    this rank's blocks as ``parallel.sharding.param_specs`` places them (the
    MoE's experts, Mamba's channels and the FSDP dimensions cut), on the
    mesh's device."""
    if cfg.tie_embeddings == ("lm_head" in tree):
        raise ValueError(f"tie_embeddings={cfg.tie_embeddings} but the tree "
                         f"{'has' if 'lm_head' in tree else 'lacks'} an lm_head")
    if mesh is None:
        return _lm_tree(tree, cfg, dev_mod.resolve(device))
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import sharding as sh

    sp = C.as_spmd(mesh)
    full = _lm_tree(tree, cfg, torch.device("cpu"))
    return _to(sh.shard_tree(full, sh.param_specs(full, cfg, sp), sp), sp.device)


def lm_cache_from_numpy(tree: dict, cfg, device=dev_mod.DEFAULT, mesh=None, shape=None) -> dict:
    """The reference's decode cache (``init_cache`` or ``prefill``'s) as
    numpy -> the port's, unstacked as ``lm_params_from_numpy`` does.  With
    ``mesh`` (and the serve ``shape`` it was made for) this rank's pieces as
    ``cache_specs`` places them."""
    if mesh is None:
        return _lm_tree(tree, cfg, dev_mod.resolve(device))
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import sharding as sh

    sp = C.as_spmd(mesh)
    full = _lm_tree(tree, cfg, torch.device("cpu"))
    return _to(sh.shard_tree(full, sh.cache_specs(full, cfg, shape, sp), sp), sp.device)


def _to(tree, dev: torch.device):
    from repro_torch.parallel import sharding as sh

    return sh.map_with_path(lambda _, t: t.to(dev), tree)


# ---------------------------------------------------------------------------
# Training: the optimizer's state and the train state
# ---------------------------------------------------------------------------


def _over_params(ref, like, leaf, g: int | None = None):
    """``leaf(ref_subtree, like_tensor, group)`` at every parameter of the
    port's tree ``like``, ``ref`` being a reference tree that mirrors the
    parameters (its ``groups`` stacked on a leading group axis)."""
    if isinstance(like, dict):
        return {
            k: ([_over_params(ref[k], sub, leaf, i) for i, sub in enumerate(v)]
                if k == "groups" and isinstance(v, list) else _over_params(ref[k], v, leaf, g))
            for k, v in like.items()
        }
    return leaf(ref, like, g)


def _q8_from_numpy(ref, like: torch.Tensor, g: int | None, sqrt_domain: bool, dev):
    """One parameter's ``Q8`` state.  Exact where the parameter's share of a
    stacked leaf is whole blocks of 128 (or the leaf is not stacked);
    otherwise the reference's blocks straddle groups, and the group's values
    are dequantised and quantised again in the port's blocks."""
    q, scale = np.asarray(ref.q), np.asarray(ref.scale)
    size = like.numel()
    if g is not None and size % optim._QBLOCK:
        qs = optim.Q8(torch.from_numpy(q.copy()), torch.from_numpy(scale.astype(np.float32)))
        flat = optim._dequantize(qs, (q.size,), sqrt_domain)[g * size:(g + 1) * size]
        out = optim._quantize(flat, sqrt_domain)
        return optim.Q8(out.q.to(dev), out.scale.to(dev))
    if g is not None:
        blocks = size // optim._QBLOCK
        q, scale = q[g * blocks:(g + 1) * blocks], scale[g * blocks:(g + 1) * blocks]
    return optim.Q8(torch.from_numpy(np.array(q, dtype=np.int8)).to(dev), _f32(scale, dev))


def _adafactor_stats(ref: dict, like: torch.Tensor, g: int | None, sliced) -> dict:
    """One parameter's Adafactor statistics.  A stacked leaf's rows and
    columns are the layer's own (``...`` axes), except where the layer's
    parameter is a vector: the reference factors the stack ``(G, d)`` of
    vectors across groups, where the port's unstacked vector keeps a full
    ``v``.  That ``v`` is carried as the reference's estimate,
    ``vr[g] vc / mean(vr)``, and the two differ from the next update on."""
    if "v" in ref or like.ndim >= 2:
        return {k: sliced(v, g) for k, v in ref.items()}
    vr, vc = np.asarray(ref["vr"], np.float32), np.asarray(ref["vc"], np.float32)
    v = vr[g] * vc / np.maximum(np.mean(vr, axis=-1), np.float32(1e-30))
    return {"v": sliced(v, None)}


def opt_state_from_numpy(tree: dict, opt_cfg, like: dict, device=dev_mod.DEFAULT) -> dict:
    """The reference optimizer's state as numpy (``opt.init`` or
    ``opt.update``'s, for ``opt_cfg.name``) -> the port's, in the tree of the
    port's parameters ``like`` (stacked ``groups`` unstacked): AdamW's
    ``m``/``v``, AdamW8's ``Q8`` pairs (``_q8_from_numpy``), Adafactor's
    ``vr``/``vc``/``v`` (``_adafactor_stats``) and every optimizer's
    ``count``."""
    dev = dev_mod.resolve(device)

    def sliced(a, g):
        a = np.asarray(a)
        return _f32(a if g is None else a[g], dev)

    out: dict = {"count": torch.tensor(int(np.asarray(tree["count"])), dtype=torch.int32,
                                       device=dev)}
    if opt_cfg.name == "adamw":
        for key in ("m", "v"):
            out[key] = _over_params(tree[key], like, lambda r, p, g: sliced(r, g))
    elif opt_cfg.name == "adamw8":
        for key, sqrt_domain in (("m", False), ("v", True)):
            out[key] = _over_params(
                tree[key], like, lambda r, p, g, s=sqrt_domain: _q8_from_numpy(r, p, g, s, dev))
    elif opt_cfg.name == "adafactor":
        out["stats"] = _over_params(tree["stats"], like,
                                    lambda r, p, g: _adafactor_stats(r, p, g, sliced))
    elif opt_cfg.name != "sgd":
        raise ValueError(opt_cfg.name)
    return out


def train_state_from_numpy(tree: dict, cfg, opt_cfg, device=dev_mod.DEFAULT) -> dict:
    """The reference's train state as numpy (``{"params", "opt", "step"}``
    and, from its train loop, ``"monitor"``) -> the port's: parameters
    requiring gradients, the optimizer's state, an int32 step and the
    monitor's ``SketchState``."""
    dev = dev_mod.resolve(device)
    params = lm_params_from_numpy(tree["params"], cfg, dev)
    for p in tree_flatten(params)[0]:
        p.requires_grad_(True)
    state = {
        "params": params,
        "opt": opt_state_from_numpy(tree["opt"], opt_cfg, params, dev),
        "step": torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32, device=dev),
    }
    if "monitor" in tree:
        state["monitor"] = SketchState(*(_f32(a, dev) for a in tree["monitor"]))
    return state
