"""Sketch-and-shift: a mean-shift decoder on the sketched characteristic
function (after Belhadji & Gribonval 2023) — the ``"sketch_shift"`` registry
entry, counterpart of ``repro.core.decoders.sketch_shift``.

K rounds, each on the residual sketch ``r = z - A(C) alpha``:

1. a swarm of P candidates climbs the residual sketched density
   ``f_r(c) = (1/m) <A delta_c, r>`` by mean-shift fixed-point steps
   ``c <- clip_box(c + h^2 grad f_r / max(f_r, floor))``, each step clipped
   to length h (``h^2 = n / mean_j ||w_j||^2``);
2. the densest candidate not within the sketch's resolution of a kept mode
   joins the support;
3. NNLS reweights the support and the residual is deflated.

Then a joint Adam polish of ``(C, alpha)`` in unit-box coordinates on
``||z - A(C) alpha||^2``, the objective every registry decoder reports.

The score step is ``kernels.ops.sketch_shift_scores``: the CUDA kernel on
the card, its plain version on the CPU.  The kernel takes a dense matrix,
so the operator is materialised once per decode (40 KB at n = 10,
m = 1000); atoms, NNLS, the residual and the polish keep using the
operator itself, as the reference's do.

The port runs the reference's ``lax.scan``/``fori_loop`` as Python loops
with no host sync inside: the step size, the density floor, the harvest's
``argmax`` and the gather of the winning candidate all stay on the device.
On the card each round's mean-shift steps, the NNLS loops and the polish
run as CUDA graphs (``core.graphs``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import freq_ops as fo
from repro_torch.core import graphs
from repro_torch.core import nnls as nnls_mod
from repro_torch.core import sketch as sk
from repro_torch.core.decoders import common
from repro_torch.core.decoders.registry import register_decoder
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class SketchShiftConfig:
    """Hyper-parameters of the decoder (the reference's defaults).  The
    reference's ``impl`` has no counterpart: the device picks the kernel."""

    k: int
    candidates: int = 40  # P, the mean-shift swarm size per round
    shift_steps: int = 75  # T fixed-point iterations per round
    step_scale: float = 1.0  # multiplier on the natural step h^2
    nnls_iters: int = 150
    polish_steps: int = 400  # joint Adam on (C, alpha) after the K rounds
    polish_lr: float = 0.02
    init: str = "range"  # "range" -> uniform in box; else rows of x_init
    # No new mode is harvested within dedup_radius_scale / median||w_j|| of
    # the kept support (one kernel std: it only stops a round re-picking the
    # same mode out of leftover residue).
    dedup_radius_scale: float = 1.0
    # Floor on the mean-shift denominator: the residual surrogate is signed,
    # so far from any mode it can be ~0 or negative.
    density_floor: float = 1e-3
    # Convergence tracing: the decoder also returns {"residual_norm": (K,)},
    # ||r|| after each deflation round; the centroids are bitwise those of
    # the untraced decode.
    trace: bool = False


# Mean-shift steps per captured graph (a divisor of the step count, at most
# this).
_SHIFT_UNROLL = 10


def _swarm_init(gen, cfg: SketchShiftConfig, lo, span, x_data, s_buf, t: int):
    """The round-``t`` swarm ``(P, n)``: uniform in the box ("range"), data
    rows ("sample"), or D^2 sampling against the ``t`` kept modes ("kpp").
    Called once per round, in round order."""
    dev = lo.device
    if x_data is None:
        u = torch.rand((cfg.candidates, lo.shape[0]), generator=gen, device=dev)
        return lo + u * span
    if cfg.init != "kpp":  # "sample": uniform data rows
        idx = torch.randint(0, x_data.shape[0], (cfg.candidates,), generator=gen, device=dev)
        return x_data[idx]
    kept = torch.arange(cfg.k, device=dev) < t
    d2 = torch.sum((x_data[:, None, :] - s_buf[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(kept[None, :], d2, float("inf"))
    dmin = torch.amin(d2, dim=1)
    dmin = torch.where(torch.isfinite(dmin), dmin, 1.0)  # t = 0: uniform
    probs = torch.softmax(torch.log(torch.clamp(dmin, min=1e-20)), dim=0)
    idx = torch.multinomial(probs, cfg.candidates, replacement=True, generator=gen)
    return x_data[idx]


def _shift_step(state, inputs, row, op, density_floor):
    """One mean-shift fixed-point step of the whole swarm on residual r."""
    (c,) = state
    w_dense, r, h2, h, lo, hi = inputs
    f, g = ops.sketch_shift_scores(c, w_dense, r)
    delta = h2 * g / torch.clamp(f, min=density_floor)[:, None]
    norm = torch.linalg.vector_norm(delta, dim=1, keepdim=True)
    delta = delta * torch.clamp(h / torch.clamp(norm, min=1e-20), max=1.0)
    return (torch.clamp(c + delta, min=lo, max=hi),)


def sketch_shift(
    gen: torch.Generator,
    z: torch.Tensor,
    w,
    lower: torch.Tensor,
    upper: torch.Tensor,
    cfg: SketchShiftConfig,
    x_init: torch.Tensor | None = None,
    *,
    eager: bool = False,
):
    """Decode K centroids from the sketch ``z`` by K rounds of mean shift on
    the residual sketched density.

    Returns ``(centroids (K, n), weights (K,), cost)`` with ``cost`` the
    shared objective ``||z - A(C) alpha||^2`` (with ``cfg.trace``, also
    ``{"residual_norm": (K,)}``).  ``x_init`` seeds the swarm with data rows
    when ``cfg.init != "range"``.  All tensors live on
    ``z``'s device, and ``gen`` must live there too.  ``eager`` runs the
    loops eagerly on the card too (for comparisons only).
    """
    w = fo.as_operator(w)
    dev = z.device
    n, k = w.n, cfg.k
    z = z.to(torch.float32)
    lo = lower.to(torch.float32)
    hi = upper.to(torch.float32)
    span = torch.clamp(hi - lo, min=1e-12)
    w_dense = w.materialize().to(torch.float32).contiguous()

    # Natural step: kappa(d) ~ 1 - ||d||^2 mean||w||^2 / (2n) near 0.
    h2 = cfg.step_scale * n / torch.clamp(torch.mean(w.col_sq_norms()), min=1e-12)
    h = torch.sqrt(h2)
    radius = common.resolution_radius(w, cfg.dedup_radius_scale)
    x_data = (
        None if (cfg.init == "range" or x_init is None)
        else torch.clamp(x_init.to(dev, torch.float32), min=lo, max=hi)
    )
    slots = torch.arange(k, device=dev)

    s_buf = torch.zeros((k, n), dtype=torch.float32, device=dev)
    alpha = torch.zeros((k,), dtype=torch.float32, device=dev)
    res_trace = torch.zeros((k,), dtype=torch.float32, device=dev)
    r = z
    for t in range(k):
        # Mean-shift swarm on the residual density.
        cands = _swarm_init(gen, cfg, lo, span, x_data, s_buf, t).contiguous()
        (cands,) = graphs.loop(
            _shift_step, (cands,), (w_dense, r, h2, h, lo, hi), cfg.shift_steps,
            const=cfg.density_floor, unroll=_SHIFT_UNROLL, eager=eager,
        )

        # Harvest: the densest candidate not within resolution of a kept mode.
        f, _ = ops.sketch_shift_scores(cands, w_dense, r)
        d2 = torch.sum((cands[:, None] - s_buf[None]) ** 2, dim=-1)  # (P, K)
        dup = torch.any((d2 < radius * radius) & (slots < t)[None, :], dim=1)
        score = torch.where(dup, float("-inf"), f)
        s_buf[t] = cands.index_select(0, torch.argmax(score).reshape(1))[0]

        # Reweight the support and deflate the residual.
        mask = slots <= t
        a = sk.atoms(s_buf, w)  # (K, 2m)
        alpha = nnls_mod.nnls(a.T, z, mask, iters=cfg.nnls_iters, eager=eager)
        r = z - (alpha * mask.to(torch.float32)) @ a
        if cfg.trace:
            res_trace[t] = torch.linalg.vector_norm(r)
    cents = s_buf

    # Polish: joint descent on the shared objective in unit-box coordinates.
    if cfg.polish_steps > 0:
        s, alpha = common.adam(
            common.polish_loss, ((cents - lo) / span, alpha), cfg.polish_steps,
            cfg.polish_lr, common.clip_joint, (z, lo, span), w, eager=eager,
        )
        cents = lo + s * span

    cost = common.residual_cost(z, cents, alpha, w)
    wsum = torch.clamp(torch.sum(alpha), min=1e-20)
    if cfg.trace:
        return cents, alpha / wsum, cost, {"residual_norm": res_trace}
    return cents, alpha / wsum, cost


# ---------------------------------------------------------------------------
# Registry adapter
# ---------------------------------------------------------------------------


@register_decoder("sketch_shift")
def decode_sketch_shift(gen, z, w, lower, upper, cfg, x_init=None, *, eager=False):
    """Registry entry: the ``SketchShiftConfig`` of the pipeline config, then
    :func:`sketch_shift`."""
    return sketch_shift(gen, z, w, lower, upper, cfg.sketch_shift_config(), x_init,
                        eager=eager)
