"""Shared decoder machinery: projected Adam + the sketch-domain objective
(counterpart of ``repro.core.decoders.common``)."""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.core import freq_ops as fo
from repro_torch.core import graphs
from repro_torch.core import sketch as sk

Params = tuple[torch.Tensor, ...]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8
# Adam steps per captured graph (a divisor of the step count, at most this),
# and the least length of the bias-correction table the graphs read.
_ADAM_UNROLL = 10
_ADAM_ROWS = 1024


def ensure_operator(w, caller: str = "decoder helper") -> fo.FrequencyOperator:
    """Operator pass-through; raw tensors raise (wrap with ``as_operator``)."""
    if not isinstance(w, fo.FrequencyOperator):
        raise TypeError(
            f"{caller} requires a core.freq_ops.FrequencyOperator; wrap a raw "
            "(n, m) tensor with freq_ops.as_operator(w)"
        )
    return w


def adam_table(steps: int, device: torch.device) -> torch.Tensor:
    """``(rows, 2)`` float32 on ``device``, ``rows >= steps``: Adam's
    bias-correction scales ``1 / (1 - b^t)`` for ``b = b1, b2`` at step ``i``
    (``t = i + 1``, as the reference computes them in float32: its scan feeds
    i = 1..steps and adds one).  Row ``i - 1`` does not depend on the step
    count, so one table of at least ``_ADAM_ROWS`` rows (a power of two)
    serves every count up to its length, and so do the graphs that read it."""
    return _adam_table(max(_ADAM_ROWS, 1 << max(0, steps - 1).bit_length()), device)


@functools.lru_cache(maxsize=None)
def _adam_table(rows: int, device: torch.device) -> torch.Tensor:
    one = np.float32(1.0)
    out = np.empty((rows, 2), np.float32)
    for i in range(1, rows + 1):
        t = np.float32(i + 1)
        out[i - 1, 0] = one / (one - np.float32(_B1) ** t)
        out[i - 1, 1] = one / (one - np.float32(_B2) ** t)
    return torch.from_numpy(out).to(device)


def _adam_step(state, inputs, row, op, const):
    """One projected-Adam step on ``state = (*p, *m, *v)``."""
    loss_fn, project, lr, n = const
    p, m, v = state[:n], state[n:2 * n], state[2 * n:]
    leaves = tuple(q.detach().requires_grad_(True) for q in p)
    args = inputs if op is None else (op, *inputs)
    grads = torch.autograd.grad(loss_fn(leaves, *args), leaves)
    with torch.no_grad():
        mhat_scale, vhat_scale = row[0], row[1]
        m = tuple(_B1 * m_ + (1 - _B1) * g for m_, g in zip(m, grads))
        v = tuple(_B2 * v_ + (1 - _B2) * g * g for v_, g in zip(v, grads))
        p = tuple(
            p_ - lr * (m_ * mhat_scale) / (torch.sqrt(v_ * vhat_scale) + _EPS)
            for p_, m_, v_ in zip(p, m, v)
        )
        p = project(p)
    return (*p, *m, *v)


def adam(
    loss_fn: Callable[..., torch.Tensor],
    params: Params,
    steps: int,
    lr: float,
    project: Callable[[Params], Params],
    inputs: Params = (),
    op=None,
    *,
    eager: bool = False,
) -> Params:
    """Minimise ``loss_fn(p, *inputs)`` (``loss_fn(p, op, *inputs)`` when an
    operator is given) over a tuple of tensors with projected Adam.

    Gradients come from ``torch.autograd.grad`` on fresh leaves each step; the
    moment updates and the projection run without autograd.  On the card the
    steps run as a CUDA graph (``core.graphs.loop``), which reads ``inputs``
    from static copies: the loss must take every tensor it reads through
    ``inputs`` or ``op``, not from closure cells.  ``eager`` runs the steps
    eagerly on the card too (for comparisons only).
    """
    p = tuple(t.detach() for t in params)
    on_graph = p[0].is_cuda and not eager
    if on_graph and loss_fn.__closure__:
        raise ValueError(
            "a graphed Adam loss must read its tensors through inputs or op, "
            "not closure cells"
        )
    state = (*p, *(torch.zeros_like(t) for t in p), *(torch.zeros_like(t) for t in p))
    state = graphs.loop(
        _adam_step, state, tuple(inputs), steps, sched=adam_table(steps, p[0].device),
        op=op, const=(loss_fn, project, lr, len(p)), unroll=_ADAM_UNROLL, eager=eager,
    )
    return tuple(t.detach() for t in state[: len(p)])


def polish_loss(p: Params, w, z: torch.Tensor, lo: torch.Tensor,
                span: torch.Tensor) -> torch.Tensor:
    """The shared objective ``||z - A(C) alpha||^2`` at ``C = lo + p[0] span``,
    ``alpha = p[1]``: the joint polish of sketch_shift and CL-AMP."""
    res = z - p[1] @ sk.atoms(lo + p[0] * span, w)
    return torch.sum(res * res)


def clip_joint(p: Params) -> Params:
    """The joint polish's projection: unit box for C, non-negative alpha."""
    return torch.clamp(p[0], 0.0, 1.0), torch.clamp(p[1], min=0.0)


def residual_cost(
    z: torch.Tensor, centroids: torch.Tensor, alpha: torch.Tensor, w
) -> torch.Tensor:
    """The shared selection objective: ``||z - sum_k alpha_k A delta_{c_k}||^2``."""
    op = ensure_operator(w, "residual_cost")
    r = z - alpha @ sk.atoms(centroids, op)
    return torch.sum(r * r)


def median(v: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values when the length is
    even (``torch.median`` returns the lower one)."""
    s = torch.sort(v.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def resolution_radius(w, scale: float) -> torch.Tensor:
    """The sketch's spatial resolution: ``scale / median ||omega_j||``."""
    op = ensure_operator(w, "resolution_radius")
    return scale / median(op.col_norms())
