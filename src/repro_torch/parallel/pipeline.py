"""GPipe pipeline parallelism over a "pipe" axis (counterpart of
``repro.parallel.pipeline``).

Schedule: GPipe fill-drain over ``n_micro`` microbatches and ``n_stages``
stages (the size of the axis), one process a stage.  In tick t of
``n_micro + n_stages - 1`` every stage applies its block to its current
activation, then sends it one stage on and receives the previous stage's
(a cyclic send and receive, as the reference's ``ppermute``).  Stage 0
takes microbatch t; stage s computes microbatch m at tick m + s; the last
stage keeps its outputs, and an all-reduce of them (every other stage adds
zeros) gives every stage the result.  The bubble fraction is
(n_stages - 1) / (n_micro + n_stages - 1).

The schedule runs forward only (the sends are not differentiable).
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from repro_torch.parallel import collectives as C


def pipeline_apply(stage_fn, stage_params, x_micro: torch.Tensor, mesh, axis: str = "pipe"):
    """Run the GPipe schedule.  Returns the (n_micro, mb, ...) outputs.

    ``stage_params``: this rank's block of the stages' parameters, a tree
    whose leaves have a leading dim of 1 (the full tree's leading dim is the
    stage, placed P(axis)); ``x_micro``: the (n_micro, mb, ...)
    microbatches, the same on every stage; ``stage_fn(params, x)`` one
    stage's computation."""
    sp = C.as_spmd(mesh)
    n_stages = sp.size(axis)
    n_micro = x_micro.shape[0]
    stage = sp.rank(axis)
    params = tree_map(lambda p: p[0], stage_params)
    carry = torch.zeros(x_micro.shape[1:], dtype=x_micro.dtype, device=x_micro.device)
    outs = [torch.zeros_like(carry) for _ in range(n_micro)]
    for t in range(n_micro + n_stages - 1):
        x_in = x_micro[min(t, n_micro - 1)] if stage == 0 else carry
        y = stage_fn(params, x_in)
        m = t - (n_stages - 1)
        if stage == n_stages - 1 and m >= 0:
            outs[m] = y
        carry = y if n_stages == 1 else \
            C.exchange(y, sp, axis, (stage + 1) % n_stages, (stage - 1) % n_stages)
    out = torch.stack(outs)
    if stage != n_stages - 1:
        out = torch.zeros_like(out)
    return C.all_reduce(out, sp, (axis,))


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
