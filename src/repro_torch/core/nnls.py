"""Non-negative least squares by FISTA (counterpart of ``repro.core.nnls``).

CLOMPR's steps 3 and 4 solve ``min_{beta >= 0} ||z - A beta||_2`` where ``A``
stacks the atoms of the current support.  The support is a padded buffer with
a boolean column mask; FISTA (accelerated projected gradient) with a
power-iteration Lipschitz estimate runs a fixed number of iterations.

Both fixed-length loops go through ``core.graphs.loop``: on the card each is
one CUDA graph of the whole loop, replayed; on the CPU they run eagerly.
FISTA's momentum schedule does not depend on the data, so its coefficients
are computed once on the host in float32 (:func:`momentum_table`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.core import graphs


@functools.lru_cache(maxsize=None)
def momentum_table(iters: int, device: torch.device) -> torch.Tensor:
    """``(iters, 1)`` float32 on ``device``: FISTA's momentum coefficients
    ``(t_i - 1) / t_{i+1}``, as the eager loop computed them on the host."""
    t = np.float32(1.0)
    out = np.empty((iters, 1), np.float32)
    for i in range(iters):
        t_next = np.float32(0.5) * (np.float32(1.0) + np.sqrt(np.float32(1.0) + np.float32(4.0) * t * t))
        out[i, 0] = (t - np.float32(1.0)) / t_next
        t = t_next
    return torch.from_numpy(out).to(device)


def _power_step(state, inputs, row, op, const):
    (v,), (gram,) = state, inputs
    v = gram @ v
    return (v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30),)


def _fista_step(state, inputs, row, op, const):
    beta, y = state
    gram, atz, maskf, step = inputs
    grad = 2.0 * (gram @ y - atz)
    beta_next = torch.clamp(y - step * grad, min=0.0) * maskf
    return beta_next, beta_next + row[0] * (beta_next - beta)


def nnls(
    a: torch.Tensor,
    z: torch.Tensor,
    mask: torch.Tensor,
    iters: int = 200,
    power_iters: int = 16,
    *,
    eager: bool = False,
) -> torch.Tensor:
    """Solve ``min_{beta>=0} ||z - a @ beta||`` with masked-out columns pinned to 0.

    a:    (d, s)  — atom matrix (columns are atoms; padded columns arbitrary)
    z:    (d,)    — target sketch
    mask: (s,)    — True for active columns
    eager: run the loops eagerly on the card too (for comparisons only)
    """
    maskf = mask.to(a.dtype)
    # Zero out dead columns with a select, not a multiply: padded columns may
    # hold NaN/inf, and 0 * NaN = NaN would poison the gram matrix.
    a = torch.where(maskf[None, :] > 0, a, torch.zeros((), dtype=a.dtype, device=a.device))
    gram = a.T @ a  # (s, s) — s is small (<= 2K)
    atz = a.T @ z

    # Lipschitz constant of grad: 2 * lambda_max(gram), via power iteration.
    v = torch.ones((a.shape[1],), dtype=a.dtype, device=a.device) / math.sqrt(a.shape[1])
    (v,) = graphs.loop(_power_step, (v,), (gram,), power_iters, unroll=power_iters,
                       eager=eager)
    lam = v @ (gram @ v)
    # Empty support (all columns masked) or an all-zero atom matrix gives
    # gram = 0 and a Rayleigh quotient of ~0: freeze the iteration with a zero
    # step (the fixed point is beta = 0) instead of a huge step and NaNs.
    step = torch.where(
        lam > 1e-12, 1.0 / (2.0 * torch.clamp(lam, min=1e-12)), torch.zeros_like(lam)
    )

    beta = torch.zeros((a.shape[1],), dtype=a.dtype, device=a.device)
    beta, _ = graphs.loop(
        _fista_step, (beta, beta), (gram, atz, maskf, step), iters,
        sched=momentum_table(iters, a.device), unroll=iters, eager=eager,
    )
    return beta

