"""Non-negative least squares by FISTA (counterpart of ``repro.core.nnls``).

CLOMPR's steps 3 and 4 solve ``min_{beta >= 0} ||z - A beta||_2`` where ``A``
stacks the atoms of the current support.  The support is a padded buffer with
a boolean column mask; FISTA (accelerated projected gradient) with a
power-iteration Lipschitz estimate runs a fixed number of iterations.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def nnls(
    a: torch.Tensor,
    z: torch.Tensor,
    mask: torch.Tensor,
    iters: int = 200,
    power_iters: int = 16,
) -> torch.Tensor:
    """Solve ``min_{beta>=0} ||z - a @ beta||`` with masked-out columns pinned to 0.

    a:    (d, s)  — atom matrix (columns are atoms; padded columns arbitrary)
    z:    (d,)    — target sketch
    mask: (s,)    — True for active columns
    """
    maskf = mask.to(a.dtype)
    # Zero out dead columns with a select, not a multiply: padded columns may
    # hold NaN/inf, and 0 * NaN = NaN would poison the gram matrix.
    a = torch.where(maskf[None, :] > 0, a, torch.zeros((), dtype=a.dtype, device=a.device))
    gram = a.T @ a  # (s, s) — s is small (<= 2K)
    atz = a.T @ z

    # Lipschitz constant of grad: 2 * lambda_max(gram), via power iteration.
    v = torch.ones((a.shape[1],), dtype=a.dtype, device=a.device) / math.sqrt(a.shape[1])
    for _ in range(power_iters):
        v = gram @ v
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30)
    lam = v @ (gram @ v)
    # Empty support (all columns masked) or an all-zero atom matrix gives
    # gram = 0 and a Rayleigh quotient of ~0: freeze the iteration with a zero
    # step (the fixed point is beta = 0) instead of a huge step and NaNs.
    step = torch.where(
        lam > 1e-12, 1.0 / (2.0 * torch.clamp(lam, min=1e-12)), torch.zeros_like(lam)
    )

    beta = torch.zeros((a.shape[1],), dtype=a.dtype, device=a.device)
    y = beta
    t = np.float32(1.0)  # the momentum schedule is data-independent: host scalars
    for _ in range(iters):
        grad = 2.0 * (gram @ y - atz)
        beta_next = torch.clamp(y - step * grad, min=0.0) * maskf
        t_next = np.float32(0.5) * (np.float32(1.0) + np.sqrt(np.float32(1.0) + np.float32(4.0) * t * t))
        y = beta_next + float((t - np.float32(1.0)) / t_next) * (beta_next - beta)
        beta, t = beta_next, t_next
    return beta
