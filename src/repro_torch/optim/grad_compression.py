"""Cross-pod gradient compression with error feedback (counterpart of
``repro.optim.grad_compression``).

Within a pod gradients reduce exactly (the "data" and "model" reductions
of ``launch.train``).  Across pods they are quantised with a shared max-abs
scale before the exchange, and the quantisation error is fed back into the
next step (error feedback keeps convergence: Karimireddy et al. 2019).
This follows the reference's code, not its docstring:

    gt    = g_pod + err                          # this pod's gradient + residual
    scale = max(max|gt| over every pod, 1e-30) / 2^13
    q     = clip(round(gt / scale), +-2^13)      # int16, a 13-bit payload
    sum   = (sum of the pods' q) * scale         # an int16 wire
    err   = gt - q * scale                       # stays with this pod

|q| <= 2^13 leaves headroom for the int16 sum of 2-4 pods.  The max is
taken over the whole leaf: over the axes its block is split over and the
pods.  Neither gloo nor NCCL reduces int16, so each rank all-gathers the
pods' int16 payloads as raw bytes (2 bytes an element, the int16 wire) and
sums them as integers, in pod order: the same exact sum on every rank.
The residual has a leading pod dimension (``error_state_specs``: P("pod",
...)), so each pod carries its own across steps and it checkpoints like
the rest of the state.
"""

from __future__ import annotations

import torch

from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as sh

_QMAX = float(1 << 13)  # 13-bit payload: the int16 sum of 2-4 pods can't wrap

__all__ = ["compress_allreduce_tree", "init_error_state", "error_state_specs",
           "local_error_state"]


def _int16_sum(q: torch.Tensor, sp: C.Spmd, axis: str) -> torch.Tensor:
    """The sum over ``axis``'s ranks of int16 ``q``, exact (int32)."""
    if sp.size(axis) == 1:
        return q.to(torch.int32)
    wire = C.all_gather(q.contiguous().view(torch.uint8).reshape(1, -1), sp, axis, 0)
    parts = wire.view(torch.int16).to(torch.int32)
    total = parts[0]
    for row in parts[1:]:
        total = total + row
    return total.reshape(q.shape)


def compress_allreduce_tree(grads, err, mesh, axis: str = "pod", specs=None):
    """The int16 error-feedback all-reduce of a gradient tree over ``axis``.

    ``grads``: this rank's blocks; ``err``: the same tree with a leading dim
    of 1 (this pod's residual); ``specs``: the gradients' specs (None: every
    leaf whole on each rank).  Returns (summed gradients, new residuals)."""
    sp = C.as_spmd(mesh)
    flat = None if specs is None else dict(sh.walk(specs))

    def one(path, g):
        e = err_by_path[path]
        spec = () if flat is None else flat[path]
        gt = g.detach().to(torch.float32) + e[0]
        amax = C.all_reduce(torch.amax(torch.abs(gt)), sp, sh.sharded_axes(spec) + (axis,), "max")
        scale = torch.clamp(amax / _QMAX, min=1e-30)
        q = torch.clamp(torch.round(gt / scale), -_QMAX, _QMAX).to(torch.int16)
        total = _int16_sum(q, sp, axis).to(torch.float32) * scale
        new_err[path] = (gt - q.to(torch.float32) * scale)[None]
        return total.to(g.dtype)

    err_by_path = dict(sh.walk(err))
    new_err: dict = {}
    summed = sh.map_with_path(one, grads)
    return summed, sh.map_with_path(lambda path, _: new_err[path], err)


def init_error_state(grads_shape, n_pods: int, device=None):
    """The zero residual of the whole tree: (n_pods, *shape) float32 a leaf
    (``grads_shape``: tensors or ``sds`` records)."""
    return sh.map_with_path(
        lambda _, g: torch.zeros((n_pods, *g.shape), dtype=torch.float32, device=device),
        grads_shape)


def local_error_state(params):
    """This rank's block of the zero residual: (1, *block shape) a leaf."""
    return sh.map_with_path(
        lambda _, p: torch.zeros((1, *p.shape), dtype=torch.float32, device=p.device), params)


def error_state_specs(grads_specs):
    """P("pod", *spec) for every gradient spec."""
    return sh.map_with_path(lambda _, s: sh.P("pod", *tuple(s)), grads_specs)
