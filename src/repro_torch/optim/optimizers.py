"""Optimizers, self-contained (counterpart of ``repro.optim.optimizers``):
AdamW (float32 or int8-quantised state), Adafactor (factored second moment),
SGD; the warmup-cosine schedule; global-norm clipping.

The state is the reference's tree, not a ``torch.optim`` object, so that a
checkpoint and ``convert.opt_state_from_numpy`` carry it: AdamW
``{"m", "v", "count"}`` with ``m`` and ``v`` mirroring the parameters
(``Q8`` leaves for ``adamw8``), Adafactor ``{"stats", "count"}`` with
``{"vr", "vc"}`` (rows and columns) for a leaf of rank 2 or more and
``{"v"}`` below, SGD ``{"count"}``; ``count`` an int32 scalar on the
parameters' device.

``update(grads, state, params, step)`` works in place under
``torch.no_grad()``: the parameters and the state's tensors are overwritten
(the reference returns new trees and its train step donates the old ones),
and it returns ``(params, state, {"lr", "gnorm"})`` with the metrics as
device scalars, so nothing waits for the card.  The arithmetic is the
reference's, in its order: the bias correction from ``count = 1``, the
int8 state in blocks of 128 rounded half to even (``torch.round``, as
``jnp.round``), ``v`` quantised in the square-root domain.

On a mesh (``update(..., mesh=, specs=)``, ``specs`` the parameters'
``parallel.sharding`` specs) each rank updates its own blocks, its state
placed by ``opt_state_specs``: AdamW and SGD are elementwise; Adafactor's
row and column means of a split dimension are all-reduced over its axis;
AdamW8's int8 state is the whole leaf's (replicated), so its update runs
on the gathered leaf and keeps this rank's block.  The global norm for
clipping all-reduces the squared sums of the distinct blocks only: a leaf
replicated over an axis counts once, not once a rank.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.parallel.collectives import all_reduce, as_spmd
from repro_torch.parallel.sharding import gather_leaf, shard_leaf, sharded_axes

Params = Any
_F32 = torch.float32
_QBLOCK = 128  # block size for int8 state quantisation
# A leaf bigger than this (bytes, float32) of rank 3 or more is updated one
# slice of its leading axis at a time, so that the update's float32
# temporaries stay a slice's size (the reference lax.maps over that axis).
_CHUNK_UPDATE_BYTES = 1 << 28


def _chunked_leaf_update(upd, p: torch.Tensor, *args) -> None:
    """Apply the in-place ``upd(p_slice, *arg_slices)`` over axis 0 when the
    leaf is huge, else once.  ``args`` are tensors or trees of tensors of
    ``p``'s leading axis."""
    if p.ndim >= 3 and p.shape[0] > 1 and p.numel() * 4 > _CHUNK_UPDATE_BYTES:
        for i in range(p.shape[0]):
            upd(p[i], *(tree_map(lambda t, i=i: t[i], a) for a in args))
    else:
        upd(p, *args)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def warmup_cosine(base_lr: float, warmup: int, total: int, floor: float = 0.1):
    """``lr(step)``: linear warm-up to ``base_lr``, then a cosine down to
    ``floor * base_lr`` at ``total``; a float32 scalar tensor on the step's
    device."""

    def lr(step):
        step = torch.as_tensor(step).to(_F32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, base_lr * cos)

    return lr


def _global_sq(leaves, spec_leaves, sp) -> torch.Tensor:
    """The sum of squares of the whole gradient from this rank's blocks:
    the leaves split over the same axes are summed, all-reduced over those
    axes, and the classes added in a fixed order."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import sharded_axes

    classes: dict[tuple, list] = {}
    for g, spec in zip(leaves, spec_leaves, strict=True):
        classes.setdefault(sharded_axes(spec), []).append(g)
    total = None
    for axes in sorted(classes):
        part = sum(torch.sum(torch.square(g.to(_F32))) for g in classes[axes])
        part = C.all_reduce(part, sp, axes)
        total = part if total is None else total + part
    return total


def _spec_leaves(params, specs):
    """The specs of ``params``' leaves, in ``tree_flatten``'s order."""
    from repro_torch.parallel.sharding import walk

    by_path = dict(walk(specs))
    return [by_path[path] for path, _ in walk(params)]


def clip_by_global_norm(grads, max_norm: float, mesh=None, specs=None):
    """Scale every gradient in place by ``min(1, max_norm / ||grads||)``;
    returns ``(grads, ||grads||)``, the norm of the unscaled gradients (on
    a mesh, of the whole gradient)."""
    from repro_torch.parallel.collectives import as_spmd

    leaves = tree_flatten(grads)[0]
    sp = as_spmd(mesh)
    if sp is None or sp.world == 1:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(_F32))) for g in leaves))
    else:
        gnorm = torch.sqrt(_global_sq(leaves, _spec_leaves(grads, specs), sp))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    with torch.no_grad():
        for g in leaves:
            g.mul_(scale.to(g.dtype))
    return grads, gnorm


# ---------------------------------------------------------------------------
# int8 blockwise quantisation for optimizer state
# ---------------------------------------------------------------------------


class Q8(NamedTuple):
    q: torch.Tensor  # int8 payload, (n_blocks, 128)
    scale: torch.Tensor  # float32 per-block max-abs, (n_blocks,)


def _quantize(x: torch.Tensor, sqrt_domain: bool = False) -> Q8:
    """Blockwise max-abs int8.  ``sqrt_domain`` compresses the dynamic range
    quadratically — used for Adam's second moment (v ~ g^2 spans too many
    decades for linear int8)."""
    flat = x.reshape(-1)
    if sqrt_domain:
        flat = torch.sqrt(torch.clamp(flat, min=0.0))
    pad = (-flat.shape[0]) % _QBLOCK
    fp = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, _QBLOCK)
    scale = torch.amax(torch.abs(fp), dim=1, keepdim=True)
    q = torch.round(fp / torch.clamp(scale, min=1e-12) * 127.0).to(torch.int8)
    return Q8(q, scale[:, 0])


def _dequantize(qs: Q8, shape, sqrt_domain: bool = False) -> torch.Tensor:
    fp = qs.q.to(_F32) * (qs.scale[:, None] / 127.0)
    fp = fp.reshape(-1)[: math.prod(shape)].reshape(shape)
    if sqrt_domain:
        fp = fp * fp
    return fp


def _store_q8(dst: Q8, src: Q8) -> None:
    dst.q.copy_(src.q)
    dst.scale.copy_(src.scale)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | adamw8 | adafactor | sgd
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params, Any], tuple[Params, Any, dict]]


def _count(params) -> torch.Tensor:
    leaves = tree_flatten(params)[0]
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=_F32, device=p.device)


def _decayed(p: torch.Tensor, step_: torch.Tensor, lr: torch.Tensor, wd: float) -> None:
    """``p <- p - step_ - lr * wd * p`` in float32, stored in p's dtype."""
    pf = p.to(_F32)
    p.copy_(pf - step_ - lr * wd * pf)


def _adamw(cfg: OptConfig, quantized: bool) -> Optimizer:
    lr_fn = warmup_cosine(cfg.lr, cfg.warmup, cfg.total_steps)

    def init(params):
        with torch.no_grad():
            moment = (lambda p: _quantize(_zeros(p))) if quantized else _zeros
            return {"m": tree_map(moment, params), "v": tree_map(moment, params),
                    "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, _step, mesh=None, specs=None):
        sp = as_spmd(mesh)
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, sp, specs)
        count = state["count"].add_(1)
        lr = lr_fn(count)
        b1c = 1.0 - torch.pow(cfg.b1, count.to(_F32))
        b2c = 1.0 - torch.pow(cfg.b2, count.to(_F32))

        def moments(g, mf, vf):
            g = g.to(_F32)
            mf = cfg.b1 * mf + (1 - cfg.b1) * g
            vf = cfg.b2 * vf + (1 - cfg.b2) * g * g
            return mf, vf, lr * (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)

        def upd(p, g, m, v):
            mf, vf, step_ = moments(g, m, v)
            m.copy_(mf)
            v.copy_(vf)
            _decayed(p, step_, lr, cfg.weight_decay)

        def upd_q8(p, g, m, v):
            mf, vf, step_ = moments(g, _dequantize(m, p.shape),
                                    _dequantize(v, p.shape, sqrt_domain=True))
            _store_q8(m, _quantize(mf))
            _store_q8(v, _quantize(vf, sqrt_domain=True))
            _decayed(p, step_, lr, cfg.weight_decay)

        pflat, spec = tree_flatten(params)
        trees = (grads, state["m"], state["v"])
        pspecs = _spec_leaves(params, specs) if sp is not None else [()] * len(pflat)
        for p, g, m, v, ps in zip(pflat, *map(spec.flatten_up_to, trees), pspecs, strict=True):
            if quantized and sharded_axes(ps):
                # The int8 state is the whole leaf's: update the gathered
                # leaf and keep this rank's block.
                full = gather_leaf(p, ps, sp).clone()
                upd_q8(full, gather_leaf(g, ps, sp), m, v)
                p.copy_(shard_leaf(full, ps, sp))
            elif quantized:
                upd_q8(p, g, m, v)
            else:
                _chunked_leaf_update(upd, p, g, m, v)
        return params, state, {"lr": lr, "gnorm": gnorm}

    return Optimizer(init, update)


def _adafactor(cfg: OptConfig) -> Optimizer:
    """Factored second-moment (Shazeer & Stern): O(rows+cols) state for 2D+."""
    lr_fn = warmup_cosine(cfg.lr, cfg.warmup, cfg.total_steps)

    def init(params):
        def st(p):
            if p.ndim >= 2:
                return {
                    "vr": torch.zeros(p.shape[:-1], dtype=_F32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=_F32, device=p.device),
                }
            return {"v": _zeros(p)}

        return {"stats": tree_map(st, params), "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, _step, mesh=None, specs=None):
        sp = as_spmd(mesh)
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, sp, specs)
        count = state["count"].add_(1)
        lr = lr_fn(count)
        decay = 1.0 - torch.pow(count.to(_F32), -0.8)

        def upd(p, g, s, entries=(None, None)):
            def mean(t, dim, entry, keepdim=False):
                # A mean over a dimension split over ``entry``'s axes: the
                # local means, averaged over the ranks.
                out = torch.mean(t, dim=dim, keepdim=keepdim)
                if entry is None:
                    return out
                axes = (entry,) if isinstance(entry, str) else tuple(entry)
                n = 1
                for a in axes:
                    n *= sp.size(a)
                return all_reduce(out, sp, axes) / n

            g = g.to(_F32)
            g2 = g * g + 1e-30
            if p.ndim >= 2:
                vr = decay * s["vr"] + (1 - decay) * mean(g2, -1, entries[-1])
                vc = decay * s["vc"] + (1 - decay) * mean(g2, -2, entries[-2])
                denom = torch.sqrt(
                    vr[..., :, None] * vc[..., None, :]
                    / torch.clamp(mean(vr, -1, entries[-2], keepdim=True), min=1e-30)[..., None]
                )
                step_ = lr * g / torch.clamp(denom, min=1e-30)
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = decay * s["v"] + (1 - decay) * g2
                step_ = lr * g / (torch.sqrt(v) + 1e-30)
                s["v"].copy_(v)
            _decayed(p, step_, lr, cfg.weight_decay)

        pflat, spec = tree_flatten(params)
        trees = (grads, state["stats"])
        pspecs = _spec_leaves(params, specs) if sp is not None else [()] * len(pflat)
        for p, g, s, ps in zip(pflat, *map(spec.flatten_up_to, trees), pspecs, strict=True):
            entries = (tuple(ps) + (None,) * p.ndim)[:p.ndim] if p.ndim >= 2 else (None, None)
            _chunked_leaf_update(functools.partial(upd, entries=entries), p, g, s)
        return params, state, {"lr": lr, "gnorm": gnorm}

    return Optimizer(init, update)


def _sgd(cfg: OptConfig) -> Optimizer:
    lr_fn = warmup_cosine(cfg.lr, cfg.warmup, cfg.total_steps)

    def init(params):
        return {"count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, _step, mesh=None, specs=None):
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, as_spmd(mesh), specs)
        count = state["count"].add_(1)
        lr = lr_fn(count)
        pflat, spec = tree_flatten(params)
        for p, g in zip(pflat, spec.flatten_up_to(grads), strict=True):
            p.copy_(p.to(_F32) - lr * g.to(_F32))
        return params, state, {"lr": lr, "gnorm": gnorm}

    return Optimizer(init, update)


def make_optimizer(cfg: OptConfig) -> Optimizer:
    if cfg.name == "adamw":
        return _adamw(cfg, quantized=False)
    if cfg.name == "adamw8":
        return _adamw(cfg, quantized=True)
    if cfg.name == "adafactor":
        return _adafactor(cfg)
    if cfg.name == "sgd":
        return _sgd(cfg)
    raise ValueError(cfg.name)
