"""CL-AMP: approximate message passing on the sketched characteristic
function (after Byrne, Chatalic, Gribonval & Schniter 2017) — the ``"amp"``
registry entry, counterpart of ``repro.core.decoders.amp``.

The sketch samples ``y_j = sum_k alpha_k e^{i w_j c_k}``: linear in the
centroids through the frequency operator, nonlinear per measurement.  A
simplified (scalar-variance) hybrid GAMP loop estimates all K centroids
jointly:

- output channel, per (frequency, component): the Gaussian pseudo-prior on
  the phase and the von Mises likelihood of the leave-one-out residual add
  as complex vectors, giving the posterior phase mean (unwrapped onto the
  prior's sheet) and variance;
- input channel, per (component, coordinate): the truncated-normal
  posterior under the box prior, ``kernels.ops.amp_denoise`` (the CUDA
  kernel on the card, its plain version on the CPU);
- the two talk through the operator's ``apply``, ``adjoint`` and
  ``col_sq_norms`` only, so the structured operator keeps its fast
  transform and nothing is materialised.

Weights are refreshed by NNLS each iteration; the loop ends with a final
NNLS and the joint Adam polish on ``||z - A(C) alpha||^2`` that every
registry decoder reports.

The reference's ``fori_loop`` is a loop with no host sync inside: every
variance (``q_p``, ``q_z``, ``q_s``, ``q_r``, ``q_x``) is a 0-d tensor on the
device, and the clamps with a traced bound use ``torch.minimum`` /
``torch.maximum``.  On the card the GAMP iteration (with its inner NNLS
weight refresh), the final NNLS and the polish run as CUDA graphs
(``core.graphs``).  With ``trace`` on, the GAMP step also writes its noise
level and input variance into two ``(iters,)`` device buffers carried in the
loop's state, at the step index it reads from a schedule of step numbers:
the graphed loop records the eager loop's series without a host read.
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

_TWO_PI = 6.283185307179586
# GAMP iterations per captured graph (a divisor of the count, at most this).
_GAMP_UNROLL = 10


@dataclasses.dataclass(frozen=True)
class AMPConfig:
    """Hyper-parameters of the decoder (the reference's defaults).  The
    reference's ``impl`` has no counterpart: the device picks the kernel."""

    k: int
    iters: int = 300  # GAMP iterations
    damp: float = 0.3  # damping on the S / C updates (1 = undamped)
    inner_nnls_iters: int = 40  # weight refresh inside the loop
    nnls_iters: int = 150  # final weights
    polish_steps: int = 600  # joint Adam on (C, alpha) after the loop
    polish_lr: float = 0.02
    init: str = "range"  # "range" -> uniform in box; "sample"/"kpp" from x_init
    # The output channel sees weights floored at alpha_floor / K, so a
    # component whose weight collapses keeps receiving likelihood.
    alpha_floor: float = 0.05
    noise_floor: float = 1e-8  # floor on the output-channel noise variance
    # Convergence tracing: the decoder also returns {"unexplained_energy":
    # (iters,), "posterior_variance": (iters,)}, the output-channel noise
    # level v and the damped input-channel variance q_x per GAMP iteration;
    # the centroids are bitwise those of the untraced decode.
    trace: bool = False


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]; ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    return x - _TWO_PI * torch.round(x / _TWO_PI)


def _estimates_init(gen, cfg: AMPConfig, lo, hi, span, x_init):
    """The ``(K, n)`` starting centroids: uniform in the box ("range"), data
    rows ("sample"), or sequential D^2 sampling over data rows ("kpp")."""
    k, n, dev = cfg.k, lo.shape[0], lo.device
    if cfg.init == "range" or x_init is None:
        return lo + torch.rand((k, n), generator=gen, device=dev) * span
    x_data = torch.clamp(x_init.to(dev, torch.float32), min=lo, max=hi)
    if cfg.init != "kpp":  # "sample": uniform data rows
        return x_data[torch.randint(0, x_data.shape[0], (k,), generator=gen, device=dev)]
    c_buf = torch.zeros((k, n), dtype=torch.float32, device=dev)
    slots = torch.arange(k, device=dev)
    for t in range(k):
        d2 = torch.sum((x_data[:, None, :] - c_buf[None]) ** 2, dim=-1)
        d2 = torch.where((slots < t)[None, :], d2, float("inf"))
        dmin = torch.amin(d2, dim=1)
        dmin = torch.where(torch.isfinite(dmin), dmin, 1.0)  # t = 0: uniform
        probs = torch.softmax(torch.log(torch.clamp(dmin, min=1e-20)), dim=0)
        c_buf[t] = x_data[torch.multinomial(probs, 1, generator=gen)[0]]
    return c_buf


def _gamp_step(state, inputs, row, w, const):
    """One GAMP iteration: the linear stage, the von Mises output channel,
    the truncated-normal input channel and the NNLS weight refresh.  With
    ``trace``, ``row`` is the step number ``(1,)`` and the state carries the
    two series."""
    k, damp, alpha_floor, noise_floor, nnls_iters, eager, trace = const
    cents, s_mat, q_x, alpha = state[:4]
    z, anorm2, lo, hi, all_k = inputs
    n, m = w.n, w.m
    # Stacked-real z = [sum b cos, -sum b sin]: the sampled CF is z1 - i z2.
    y_re, y_im = z[:m], -z[m:]
    # Linear stage out: pseudo-measurement means with the Onsager term.
    q_p = torch.clamp(q_x * anorm2 / m, min=1e-12)
    p_mat = w.apply(cents).to(torch.float32) - q_p * s_mat

    # Output channel: von Mises posterior per (component, frequency).
    al = torch.clamp(alpha, min=alpha_floor / k)[:, None]  # (K, 1)
    rho = torch.exp(-0.5 * q_p)  # |E e^{i theta}| under N(p, q_p)
    cos_p, sin_p = torch.cos(p_mat), torch.sin(p_mat)
    g_re, g_im = rho * cos_p, rho * sin_p  # (K, m)
    yhat_re = torch.sum(al * g_re, dim=0)  # (m,)
    yhat_im = torch.sum(al * g_im, dim=0)
    # Output-noise level: the unexplained measurement energy.
    v = torch.mean((y_re - yhat_re) ** 2 + (y_im - yhat_im) ** 2) + noise_floor
    # Leave-one-out residual: what frequency j says about component k.
    res_re = (y_re - yhat_re)[None, :] + al * g_re
    res_im = (y_im - yhat_im)[None, :] + al * g_im
    res_abs = torch.sqrt(res_re**2 + res_im**2)
    kappa_y = 2.0 * al * res_abs / v  # likelihood concentration
    safe = torch.clamp(res_abs, min=1e-20)
    # Prior (concentration 1/q_p at angle p) + likelihood (kappa_y at the
    # residual's angle) add as complex vectors.
    vec_re = cos_p / q_p + kappa_y * res_re / safe
    vec_im = sin_p / q_p + kappa_y * res_im / safe
    kappa = torch.clamp(torch.sqrt(vec_re**2 + vec_im**2), min=1e-20)
    mu = torch.atan2(vec_im, vec_re)
    z_hat = p_mat + _wrap(mu - p_mat)  # unwrap onto the prior's sheet
    # Posterior phase variance ~ 1/kappa, capped below q_p so that q_s
    # stays positive (the cap is a device tensor: no host sync).
    q_z = torch.minimum(torch.clamp(torch.mean(1.0 / kappa), min=1e-12), 0.999 * q_p)

    s_new = (z_hat - p_mat) / q_p
    s_mat = damp * s_new + (1.0 - damp) * s_mat
    q_s = torch.clamp((1.0 - q_z / q_p) / q_p, min=1e-12)

    # Linear stage in + input channel: the truncated-normal denoiser.
    q_r = n / (anorm2 * q_s)
    r_mat = cents + q_r * w.adjoint(s_mat).to(torch.float32)
    c_new, v_new = ops.amp_denoise(r_mat, q_r, lo, hi)
    cents = damp * c_new + (1.0 - damp) * cents
    q_x = torch.clamp(torch.mean(v_new), min=1e-12)

    # Weight refresh.
    alpha = nnls_mod.nnls(sk.atoms(cents, w).T, z, all_k, iters=nnls_iters,
                          eager=eager)
    alpha = alpha / torch.clamp(torch.sum(alpha), min=1e-20)
    if trace:
        v_trace = state[4].index_copy(0, row, v.reshape(1))
        qx_trace = state[5].index_copy(0, row, q_x.reshape(1))
        return cents, s_mat, q_x, alpha, v_trace, qx_trace
    return cents, s_mat, q_x, alpha


def cl_amp(
    gen: torch.Generator,
    z: torch.Tensor,
    w,
    lower: torch.Tensor,
    upper: torch.Tensor,
    cfg: AMPConfig,
    x_init: torch.Tensor | None = None,
    *,
    eager: bool = False,
):
    """Decode K centroids jointly from the sketch ``z`` by simplified hybrid
    GAMP on the sketched characteristic function.

    Returns ``(centroids (K, n), weights (K,), cost)`` with ``cost`` the
    shared objective ``||z - A(C) alpha||^2`` (with ``cfg.trace``, also the
    two series).  ``x_init`` seeds the estimates with data rows when
    ``cfg.init != "range"``.  All tensors live
    on ``z``'s device, and ``gen`` must live there too.  ``eager`` runs the
    loops eagerly on the card too (for comparisons only).
    """
    w = fo.as_operator(w)
    dev = z.device
    n, m, k = w.n, w.m, cfg.k
    z = z.to(torch.float32)
    lo = lower.to(torch.float32)
    hi = upper.to(torch.float32)
    span = torch.clamp(hi - lo, min=1e-12)
    # ||A||_F^2 of the linear stage: the only operator statistic the
    # scalar-variance GAMP needs beyond apply/adjoint.
    anorm2 = torch.clamp(torch.sum(w.col_sq_norms()), min=1e-12)
    all_k = torch.ones((k,), dtype=torch.bool, device=dev)

    cents = _estimates_init(gen, cfg, lo, hi, span, x_init)
    s_mat = torch.zeros((k, m), dtype=torch.float32, device=dev)
    q_x = torch.mean(span * span) / 12.0  # variance of the box prior
    alpha = torch.full((k,), 1.0 / k, dtype=torch.float32, device=dev)
    state, steps = (cents, s_mat, q_x, alpha), None
    if cfg.trace:
        state += tuple(torch.zeros((cfg.iters,), dtype=torch.float32, device=dev)
                       for _ in range(2))
        steps = torch.arange(cfg.iters, device=dev).reshape(-1, 1)
    state = graphs.loop(
        _gamp_step, state, (z, anorm2, lo, hi, all_k), cfg.iters, sched=steps,
        op=w, unroll=_GAMP_UNROLL, eager=eager,
        const=(k, cfg.damp, cfg.alpha_floor, cfg.noise_floor, cfg.inner_nnls_iters, eager,
               cfg.trace),
    )
    cents, s_mat, q_x, alpha = state[:4]

    # Final weights, then the joint polish in unit-box coordinates.
    alpha = nnls_mod.nnls(sk.atoms(cents, w).T, z, all_k, iters=cfg.nnls_iters, eager=eager)
    if cfg.polish_steps > 0:
        s, alpha = common.adam(
            common.polish_loss, ((cents - lo) / span, alpha), cfg.polish_steps,
            cfg.polish_lr, common.clip_joint, (z, lo, span), w, eager=eager,
        )
        cents = lo + s * span

    cost = common.residual_cost(z, cents, alpha, w)
    wsum = torch.clamp(torch.sum(alpha), min=1e-20)
    if cfg.trace:
        traces = {"unexplained_energy": state[4], "posterior_variance": state[5]}
        return cents, alpha / wsum, cost, traces
    return cents, alpha / wsum, cost


# ---------------------------------------------------------------------------
# Registry adapter
# ---------------------------------------------------------------------------


@register_decoder("amp")
def decode_amp(gen, z, w, lower, upper, cfg, x_init=None, *, eager=False):
    """Registry entry: the ``AMPConfig`` of the pipeline config, then
    :func:`cl_amp`."""
    return cl_amp(gen, z, w, lower, upper, cfg.amp_config(), x_init, eager=eager)
