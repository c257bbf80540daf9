"""CLOMPR for K-means (paper Algorithm 1) — counterpart of
``repro.core.decoders.clompr``.

The reference restructures the decoder into fixed shapes inside one ``jit``;
the port keeps that structure and runs it eagerly:

- the support lives in a padded ``(K+1, n)`` buffer whose first ``active``
  slots are in use (the support grows by one per iteration and is
  hard-thresholded back to K once ``t >= K``); ``fori_loop`` and
  ``lax.cond`` become Python control flow, and ``active`` is a host integer,
  so the loop never waits on the device to learn it;
- steps 1 and 5 are projected Adam with a fixed step count, in unit-box
  coordinates ``c = l + s (u - l)``, with gradients from
  ``torch.autograd.grad``;
- NNLS (steps 3/4) is FISTA with a fixed iteration budget (``core.nnls``);
- hard thresholding is a stable descending sort + a compacting gather.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from repro_torch.core import freq_ops as fo
from repro_torch.core import nnls as nnls_mod
from repro_torch.core import sketch as sk
from repro_torch.core.decoders.common import adam as _adam
from repro_torch.core.decoders.common import median
from repro_torch.core.decoders.registry import register_decoder

InitStrategy = Literal["range", "sample", "kpp"]


@dataclasses.dataclass(frozen=True)
class CLOMPRConfig:
    """Hyper-parameters of the decoder (the reference's defaults)."""

    k: int
    atom_steps: int = 300  # step-1 gradient ascent iterations
    joint_steps: int = 200  # step-5 joint gradient descent iterations
    nnls_iters: int = 150
    atom_lr: float = 0.05  # Adam lr in unit-box coordinates
    joint_lr: float = 0.02
    init: InitStrategy = "range"
    # Step-1 ascent restarts: best of R random inits.
    atom_restarts: int = 1
    # Extra step-5 iterations run once after the 2K outer loop (the Matlab
    # reference runs its minimisations to convergence).
    final_steps: int = 1000
    # Before hard thresholding, atoms closer than
    # ``merge_radius_scale / median||omega||`` to a higher-beta atom are
    # suppressed (within-resolution duplicates); 0 = off (paper-faithful).
    merge_radius_scale: float = 2.5


def _clip_unit(p):
    return (torch.clamp(p[0], 0.0, 1.0),)


def _clip_joint(p):
    return torch.clamp(p[0], 0.0, 1.0), torch.clamp(p[1], min=0.0)


# ---------------------------------------------------------------------------
# Step 1 — find a new centroid: maximise Re< A d_c / ||.||, r > over the box
# ---------------------------------------------------------------------------


def _init_s0(gen, s_buf, mask, x_unit, cfg: CLOMPRConfig, shape):
    """Initial point(s) for the step-1 ascent, in unit-box coordinates."""
    if cfg.init == "range" or x_unit is None:
        return torch.rand(shape, generator=gen, dtype=torch.float32, device=s_buf.device)
    if cfg.init == "sample":
        idx = torch.randint(
            0, x_unit.shape[0], (shape[0],), generator=gen, device=s_buf.device
        )
        return x_unit[idx]
    # "kpp": D^2 sampling against the *current* support (k-means++ style).
    d2 = torch.sum((x_unit[:, None, :] - s_buf[None, :, :]) ** 2, dim=-1)  # (N, K+1)
    d2 = torch.where(mask[None, :], d2, float("inf"))
    dmin = torch.amin(d2, dim=1)
    dmin = torch.where(torch.isfinite(dmin), dmin, 1.0)  # t=0: uniform
    idx = torch.multinomial(
        torch.clamp(dmin, min=1e-20), shape[0], replacement=True, generator=gen
    )
    return x_unit[idx]


def _find_atom(gen, r, w, lo, span, s_buf, mask, x_unit, cfg: CLOMPRConfig):
    """Gradient-ascend the normalised correlation; best of ``atom_restarts``."""
    inv_norm = float(np.float32(1.0) / np.sqrt(np.float32(w.m)))

    def neg_corr(p):  # p[0]: (R, n) -> scalar (summed; restarts are independent)
        a = sk.atoms(lo + p[0] * span, w)  # (R, 2m)
        return -torch.sum((a @ r) * inv_norm)

    s0 = _init_s0(gen, s_buf, mask, x_unit, cfg, (cfg.atom_restarts, w.n))
    (s_opt,) = _adam(neg_corr, (s0,), cfg.atom_steps, cfg.atom_lr, _clip_unit)
    corr = sk.atoms(lo + s_opt * span, w) @ r  # (R,)
    return s_opt[torch.argmax(corr)]


# ---------------------------------------------------------------------------
# The decoder
# ---------------------------------------------------------------------------


def clompr(
    gen: torch.Generator,
    z: torch.Tensor,
    w,
    lower: torch.Tensor,
    upper: torch.Tensor,
    cfg: CLOMPRConfig,
    x_init: torch.Tensor | None = None,
):
    """Decode K weighted Diracs from the sketch ``z`` (stacked-real, (2m,)).

    Returns ``(centroids (K, n), weights (K,), cost)`` where ``cost`` is the
    final value of the paper's objective (4), used to select among
    replicates.  ``x_init`` is only read by the "sample"/"kpp" inits.  All
    tensors live on ``z``'s device, and ``gen`` must live there too.
    """
    w = fo.as_operator(w)
    dev = z.device
    kp1 = cfg.k + 1
    z = z.to(torch.float32)
    lo = lower.to(torch.float32)
    span = torch.clamp(upper.to(torch.float32) - lo, min=1e-12)
    x_unit = None if x_init is None else (x_init.to(dev, torch.float32) - lo) / span
    inv_norm = float(np.float32(1.0) / np.sqrt(np.float32(w.m)))
    slots = torch.arange(kp1, device=dev)

    def residual(s_buf, alpha, mask):
        """``z`` minus the masked mixture sketch ``sum_k alpha_k A delta_{c_k}``."""
        a = sk.atoms(lo + s_buf * span, w)  # (K+1, 2m)
        return z - (alpha * mask.to(torch.float32)) @ a

    def joint_descent(s_buf, alpha, mask, steps):
        """Step 5: projected Adam on (C, alpha) jointly, then the residual."""

        def loss(p):
            res = residual(p[0], p[1], mask)
            return torch.sum(res * res)

        s_buf, alpha = _adam(loss, (s_buf, alpha), steps, cfg.joint_lr, _clip_joint)
        with torch.no_grad():
            return s_buf, alpha, residual(s_buf, alpha, mask)

    s_buf = torch.zeros((kp1, w.n), dtype=torch.float32, device=dev)
    alpha = torch.zeros((kp1,), dtype=torch.float32, device=dev)
    active = 0  # slots [0, active) of the support are in use
    r = z
    for t in range(2 * cfg.k):
        # -- Step 1+2: find a new centroid, expand support into the free slot.
        mask = slots < active
        s_new = _find_atom(gen, r, w, lo, span, s_buf, mask, x_unit, cfg)
        s_buf = s_buf.clone()
        s_buf[active] = s_new  # active <= K: one slot always free
        active += 1
        mask = slots < active

        # -- Step 3: hard thresholding once t >= K (support is then K+1).
        if t >= cfg.k:
            a_n = sk.atoms(lo + s_buf * span, w) * inv_norm  # normalised atoms
            beta = nnls_mod.nnls(a_n.T, z, mask, iters=cfg.nnls_iters)
            score = torch.where(mask, beta, float("-inf"))
            if cfg.merge_radius_scale > 0:
                # Suppress within-resolution duplicates of higher-beta atoms.
                cents = lo + s_buf * span
                d2 = torch.sum((cents[:, None] - cents[None]) ** 2, dim=-1)
                radius = cfg.merge_radius_scale / median(w.col_norms())
                higher = (beta[None, :] > beta[:, None]) | (
                    (beta[None, :] == beta[:, None]) & (slots[None, :] < slots[:, None])
                )
                close = d2 < radius * radius
                absorbed = torch.any(close & higher & mask[None, :], dim=1)
                score = torch.where(absorbed, float("-inf"), score)
            order = torch.argsort(-score, stable=True)  # top-K first
            s_buf = s_buf[order]
            active = cfg.k
            mask = slots < active

        # -- Step 4: NNLS projection for alpha on the (unnormalised) atoms.
        a = sk.atoms(lo + s_buf * span, w)
        alpha = nnls_mod.nnls(a.T, z, mask, iters=cfg.nnls_iters)

        # -- Step 5: joint gradient descent on (C, alpha), box + nonneg proj.
        s_buf, alpha, r = joint_descent(s_buf, alpha, mask, cfg.joint_steps)

    # Final polish: one long joint descent (Matlab runs step 5 to convergence).
    if cfg.final_steps > 0:
        s_buf, alpha, r = joint_descent(s_buf, alpha, mask, cfg.final_steps)

    # Compact the K active slots to the front (exactly K are active at exit).
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    centroids = (lo + s_buf * span)[order][: cfg.k]
    weights = torch.where(mask, alpha, 0.0)[order][: cfg.k]
    wsum = torch.clamp(torch.sum(weights), min=1e-20)
    cost = torch.sum(r * r)
    return centroids, weights / wsum, cost


# ---------------------------------------------------------------------------
# Registry adapter
# ---------------------------------------------------------------------------


@register_decoder("clompr")
def decode_clompr(gen, z, w, lower, upper, cfg, x_init=None):
    """Registry entry: the ``CLOMPRConfig`` of the pipeline config, then
    :func:`clompr`."""
    return clompr(gen, z, w, lower, upper, cfg.clompr_config(), x_init)
