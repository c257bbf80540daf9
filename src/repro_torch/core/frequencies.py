"""Frequency distributions for the sketching operator (paper §3.1).

Counterpart of ``repro.core.frequencies``.  Frequencies are ``omega = R * phi``
with ``phi`` uniform on the unit sphere and the radius ``R`` drawn from the
*adapted radius* density

    p_AR(R)  ∝  sqrt(R^2 sigma^2 + R^4 sigma^4 / 4) * exp(-R^2 sigma^2 / 2)

(Keriven et al., arXiv:1606.02838); a Gaussian and a folded-Gaussian radius are
kept as baselines.  ``sigma^2`` comes from the small-sketch regression
heuristic (:func:`estimate_sigma2`).  Everything is float32; draws come from an
explicit ``torch.Generator`` in place of a JAX key.
"""

from __future__ import annotations

from typing import Literal

import torch

from repro_torch import device as dev_mod

FreqDist = Literal["adapted_radius", "gaussian", "folded_gaussian"]

# Number of grid points for inverse-CDF sampling of the radius density.
_GRID = 4096
# The adapted-radius density has negligible mass beyond R*sigma ~ 6.
_RMAX_SIGMA = 6.0
_F32 = torch.float32


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``start*(1-s) + stop*s`` for ``s = i/(num-1)``, ending exactly at ``stop``.

    The same formula as ``jnp.linspace``; ``torch.linspace`` computes the two
    halves of the grid from opposite ends and rounds differently.
    """
    div = num - 1
    step = torch.arange(div, dtype=start.dtype, device=start.device) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def _adapted_radius_pdf(r: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    """Unnormalised adapted-radius pdf evaluated at radii ``r``."""
    r2 = r * r * sigma2
    return torch.sqrt(r2 + r2 * r2 / 4.0) * torch.exp(-r2 / 2.0)


def radius_from_uniform(u: torch.Tensor, sigma2) -> torch.Tensor:
    """Map uniforms ``u in [0, 1)`` through the adapted-radius inverse CDF.

    The deterministic half of the sampler (grid CDF + linear interpolation).
    ``torch.searchsorted(right=False)`` is left-sided like ``jnp.searchsorted``.
    """
    u = torch.as_tensor(u, dtype=_F32)
    sigma2 = torch.as_tensor(sigma2, dtype=_F32, device=u.device)
    sigma = torch.sqrt(sigma2)
    grid = _linspace(
        torch.zeros((), dtype=_F32, device=u.device),
        _RMAX_SIGMA / torch.clamp(sigma, min=1e-20),
        _GRID,
    )
    pdf = _adapted_radius_pdf(grid, sigma2)
    cdf = torch.cumsum(pdf, 0)
    cdf = cdf / cdf[-1]
    idx = torch.searchsorted(cdf, u, right=False)
    idx = torch.clamp(idx, 1, _GRID - 1)
    # Linear interpolation between grid points for a smooth sample.
    c0, c1 = cdf[idx - 1], cdf[idx]
    w = (u - c0) / torch.clamp(c1 - c0, min=1e-20)
    return grid[idx - 1] + w * (grid[idx] - grid[idx - 1])


def _inverse_cdf_sample(gen: torch.Generator, m: int, sigma2) -> torch.Tensor:
    """Draw ``m`` radii from the adapted-radius density by inverse-CDF."""
    u = torch.rand((m,), generator=gen, dtype=_F32, device=gen.device)
    return radius_from_uniform(u, sigma2)


def _uniform_sphere(gen: torch.Generator, m: int, n: int) -> torch.Tensor:
    v = torch.randn((m, n), generator=gen, dtype=_F32, device=gen.device)
    return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)


def _device_of(gen: torch.Generator, device) -> torch.device:
    dev = dev_mod.resolve(device)
    if gen.device.type != dev.type:
        raise ValueError(
            f"generator lives on {gen.device} but device={str(dev)!r}; create "
            "it with torch.Generator(device=...)"
        )
    return dev


def draw_radii(
    gen: torch.Generator,
    m: int,
    n: int,
    sigma2,
    dist: FreqDist = "adapted_radius",
    device=dev_mod.DEFAULT,
) -> torch.Tensor:
    """Draw ``m`` frequency radii ``||omega||`` from ``Lambda``'s radial law."""
    dev = _device_of(gen, device)
    sigma2 = torch.as_tensor(sigma2, dtype=_F32, device=dev)
    if dist == "adapted_radius":
        return _inverse_cdf_sample(gen, m, sigma2)
    if dist == "gaussian":
        v = torch.randn((m, n), generator=gen, dtype=_F32, device=dev)
        return torch.linalg.vector_norm(v, dim=1) / torch.sqrt(sigma2)
    if dist == "folded_gaussian":
        v = torch.randn((m,), generator=gen, dtype=_F32, device=dev)
        return torch.abs(v) / torch.sqrt(sigma2)
    raise ValueError(f"unknown frequency distribution {dist!r}")


def draw_frequencies(
    gen: torch.Generator,
    m: int,
    n: int,
    sigma2,
    dist: FreqDist = "adapted_radius",
    device=dev_mod.DEFAULT,
) -> torch.Tensor:
    """Draw ``m`` frequency vectors in R^n from ``Lambda``: ``W`` of shape
    ``(n, m)`` (column frequencies), so the sketch phases are ``X @ W``."""
    dev = _device_of(gen, device)
    sigma2 = torch.as_tensor(sigma2, dtype=_F32, device=dev)
    if dist == "adapted_radius":
        radius = _inverse_cdf_sample(gen, m, sigma2)
        w = _uniform_sphere(gen, m, n) * radius[:, None]
    elif dist == "gaussian":
        w = torch.randn((m, n), generator=gen, dtype=_F32, device=dev)
        w = w / torch.sqrt(sigma2)
    elif dist == "folded_gaussian":
        v = torch.randn((m,), generator=gen, dtype=_F32, device=dev)
        radius = torch.abs(v) / torch.sqrt(sigma2)
        w = _uniform_sphere(gen, m, n) * radius[:, None]
    else:
        raise ValueError(f"unknown frequency distribution {dist!r}")
    return w.T.contiguous()  # (n, m)


# ---------------------------------------------------------------------------
# Scale (sigma^2) estimation — small-sketch regression of [5], §5.2.
# ---------------------------------------------------------------------------


def estimate_sigma2(
    gen: torch.Generator,
    x_sample: torch.Tensor,
    m0: int = 500,
    n_iters: int = 3,
    sigma2_init: float | None = None,
    n_candidates: int = 64,
    device=dev_mod.DEFAULT,
) -> torch.Tensor:
    """Estimate the frequency scale ``sigma^2`` from a small data fraction.

    At the current scale, draw ``m0`` frequencies, sketch the sample, and fit
    the modulus of the empirical characteristic function with the Gaussian
    decay ``|z(omega)| ≈ exp(-sigma^2 ||omega||^2 / 2)`` over a log-grid of
    candidate scales; a few iterations re-centre the grid on the fit.  The
    candidates are scored in one broadcast ``(n_candidates, m0)`` pass (the
    reference ``vmap``s a per-candidate loss).
    """
    dev = _device_of(gen, device)
    x_sample = torch.as_tensor(x_sample, dtype=_F32).to(dev)
    n = x_sample.shape[1]
    if sigma2_init is None:
        # Coarse one-pass initial guess: mean squared distance to the mean.
        mu = torch.mean(x_sample, dim=0)
        spread = torch.mean(torch.sum((x_sample - mu) ** 2, dim=1)) / n
        sigma2 = torch.clamp(spread, min=1e-12)
    else:
        sigma2 = torch.as_tensor(sigma2_init, dtype=_F32, device=dev)

    exps = _linspace(
        torch.tensor(-2.0, dtype=_F32, device=dev),
        torch.tensor(2.0, dtype=_F32, device=dev),
        n_candidates,
    )
    grid = torch.pow(torch.tensor(10.0, dtype=_F32, device=dev), exps)
    for _ in range(n_iters):
        w = draw_frequencies(gen, m0, n, sigma2, "adapted_radius", dev)
        proj = x_sample @ w  # (S, m0)
        zr = torch.mean(torch.cos(proj), dim=0)
        zi = torch.mean(torch.sin(proj), dim=0)
        mod = torch.sqrt(zr**2 + zi**2)  # (m0,)
        r2 = torch.sum(w * w, dim=0)  # ||omega||^2
        cands = sigma2 * grid
        logmod = torch.log(torch.clamp(mod, min=1e-3))
        weights = (mod > 0.05).to(_F32)  # trust only the low-noise region
        pred = -cands[:, None] * r2[None, :] / 2.0  # (C, m0)
        losses = torch.sum(weights * (logmod - pred) ** 2, dim=1) / torch.clamp(
            torch.sum(weights), min=1.0
        )
        sigma2 = cands[torch.argmin(losses)]
    return sigma2.to(_F32)
