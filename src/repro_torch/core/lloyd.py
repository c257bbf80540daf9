"""Lloyd-Max K-means + k-means++ — the paper's baseline, counterpart of
``repro.core.lloyd``.

Random ("range"/"sample") or k-means++ seeding, then Lloyd iterations until
the largest centroid move is at most ``tol`` or ``max_iters`` is reached;
empty clusters keep their previous centroid.  Replicates run one after
another and the best-SSE one wins.

The assignment always goes through ``kernels.ops.assign_argmin`` (the CUDA
kernel on the card).  The centroid update uses ``index_add_``: O(K n) memory,
where the reference's one-hot product holds N x K floats.  On CUDA,
``index_add_`` sums in an order that can change from run to run, so
centroids may differ in their last bits between runs; the sketch, not this
baseline, is what must be bitwise repeatable.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import device as dev_mod
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class LloydConfig:
    k: int
    max_iters: int = 100
    tol: float = 1e-4
    init: str = "range"  # "range" | "sample" | "kpp"
    replicates: int = 1


class LloydResult(NamedTuple):
    centroids: torch.Tensor
    sse: torch.Tensor
    iters: int


def _init_centroids(gen, x, lo, hi, cfg: LloydConfig) -> torch.Tensor:
    n_pts, n = x.shape
    if cfg.init == "range":
        u = torch.rand((cfg.k, n), generator=gen, dtype=torch.float32, device=x.device)
        return lo + u * (hi - lo)
    if cfg.init == "sample":
        if cfg.k > n_pts:
            raise ValueError(f"init='sample' needs k <= N, got k={cfg.k}, N={n_pts}")
        idx = torch.randperm(n_pts, generator=gen, device=x.device)[: cfg.k]
        return x[idx]
    if cfg.init != "kpp":
        raise ValueError(f"unknown init {cfg.init!r}")
    # k-means++ (D^2 seeding).
    first = x[torch.randint(0, n_pts, (1,), generator=gen, device=x.device)[0]]
    cents = torch.zeros((cfg.k, n), dtype=x.dtype, device=x.device)
    cents[0] = first
    d2 = torch.sum((x - first) ** 2, dim=1)
    for i in range(1, cfg.k):
        idx = torch.multinomial(torch.clamp(d2, min=1e-30), 1, generator=gen)[0]
        cents[i] = x[idx]
        d2 = torch.minimum(d2, torch.sum((x - x[idx]) ** 2, dim=1))
    return cents


def _iterate(x: torch.Tensor, cents0: torch.Tensor, cfg: LloydConfig):
    """Lloyd iterations from ``cents0`` -> ``(centroids, iterations)``.

    One host sync per iteration reads whether the largest move exceeds
    ``tol`` (the reference's ``while_loop`` condition).
    """
    k, n = cents0.shape
    cents = cents0.to(torch.float32).contiguous()
    it = 0
    moved = float("inf")
    while it < cfg.max_iters and moved > cfg.tol:
        labels, _ = kops.assign_argmin(x, cents)
        labels = labels.to(torch.int64)
        counts = torch.bincount(labels, minlength=k).to(torch.float32)  # (K,)
        sums = torch.zeros((k, n), dtype=torch.float32, device=x.device)
        sums.index_add_(0, labels, x)  # (K, n)
        new = torch.where(
            counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1.0), cents
        )
        moved = float(torch.amax(torch.abs(new - cents)))
        cents = new.contiguous()
        it += 1
    return cents, it


def lloyd(seed: int, x: torch.Tensor, cfg: LloydConfig, device=dev_mod.DEFAULT) -> LloydResult:
    """One replicate of Lloyd-Max (``kmeans`` in the paper's figures)."""
    dev = dev_mod.resolve(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev).contiguous()
    lo = torch.amin(x, dim=0)
    hi = torch.amax(x, dim=0)
    cents0 = _init_centroids(dev_mod.generator(seed, dev), x, lo, hi, cfg)
    cents, iters = _iterate(x, cents0, cfg)
    _, mind2 = kops.assign_argmin(x, cents)
    return LloydResult(cents, torch.sum(mind2, dtype=torch.float64).to(torch.float32), iters)


def kmeans(seed: int, x: torch.Tensor, cfg: LloydConfig, device=dev_mod.DEFAULT) -> LloydResult:
    """Lloyd-Max with replicates run one after another; replicate ``r`` draws
    from ``derive_seed(seed, r)`` and the best-SSE one is returned (the
    first on ties)."""
    dev = dev_mod.resolve(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev).contiguous()
    best = None
    for r in range(cfg.replicates):
        res = lloyd(dev_mod.derive_seed(seed, r), x, cfg, dev)
        if best is None or float(res.sse) < float(best.sse):
            best = res
    return best
