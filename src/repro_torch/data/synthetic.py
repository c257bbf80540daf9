"""Synthetic datasets used by the paper's experiments (§4.1) — counterpart of
``repro.data.synthetic.gaussian_mixture``."""

from __future__ import annotations

import math

import torch

from repro_torch import device as dev_mod


def gaussian_mixture(
    seed: int,
    n_points: int,
    k: int,
    n: int,
    c: float = 1.5,
    return_labels: bool = False,
    device=dev_mod.DEFAULT,
):
    """Draw ``n_points`` from the paper's mixture of K unit Gaussians in R^n:
    uniform weights, means ``N(0, c K^{1/n} Id)``.  Drawn on ``device`` from a
    ``torch.Generator`` created there, so N = 10^7 points never touch the host."""
    dev = dev_mod.resolve(device)
    gen = dev_mod.generator(seed, dev)
    means = torch.randn((k, n), generator=gen, dtype=torch.float32, device=dev)
    means = means * math.sqrt(c * k ** (1.0 / n))
    labels = torch.randint(0, k, (n_points,), generator=gen, device=dev)
    x = torch.randn((n_points, n), generator=gen, dtype=torch.float32, device=dev)
    x += means[labels]
    if return_labels:
        return x, labels, means
    return x
