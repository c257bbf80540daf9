"""Collectives over the axes of a ``torch.distributed`` ``DeviceMesh``, and
the autograd functions the LM on a mesh is written with.

The reference writes its model once and lets GSPMD insert the
collectives; here every collective is explicit, SPMD, one process a rank.
``Spmd`` wraps a mesh: its axis sizes, groups and this rank's coordinates.
Every function below is the identity on an axis of size 1, so a mesh whose
axes all have size 1 computes the one-card program's bits.

Differentiable collectives (Megatron's pairing):

- ``copy_to(x, sp, axes)``: identity forward, all-reduce backward (``f``:
  the input of a column-parallel product, or a replicated leaf whose
  gradient is summed over ``axes``);
- ``reduce_from(x, sp, axes)``: all-reduce forward, identity backward
  (``g``: the output of a row-parallel product, a loss's partial sums);
- ``reduce_both``: all-reduce both ways (a partial sum that is read again
  by column-parallel consumers: Mamba's ``x_proj`` product);
- ``gather(x, sp, [(axis, dim, grad), ...])``: all-gathers forward;
  backward a reduce-scatter (``grad="sum"``: the ranks' uses are partial,
  FSDP) or this rank's slice (``grad="slice"``: every rank computed the
  same full gradient, a replicated computation);
- ``scale_grad(x, s)``: identity forward, gradient times ``s``.

Sequence parallelism (Megatron's pair, over "model" along dim 1):

- ``gather_seq(x, sp)``: the blocks of the sequence all-gathered forward,
  the gradient reduce-scattered backward (``g``: the input of a
  tensor-parallel part); with ``grad="slice"`` this rank's block of the
  gradient instead (the input of a part every rank computes whole);
- ``reduce_scatter_seq(x, sp)``: the ranks' partial sums reduce-scattered
  over the sequence forward, all-gathered backward (``ḡ``: the output of a
  row-parallel product);
- ``split_seq(x, sp)``: this rank's block forward, all-gathered backward
  (the output of a part every rank computed whole).

``region_input`` / ``region_output`` pick the pair a part's input and
output take: these three where the stream is sequence-parallel, else
``copy_to`` / ``reduce_from`` for a tensor-parallel part.  ``all_to_all``
exchanges blocks of dim 0 over one axis (not differentiable).

On a gloo group a CUDA operand travels through a host copy (gloo's TCP
transport reads host memory; ``core/topology.py`` stages its sends the same
way), so gloo ranks on one card run the same program as NCCL ranks; a
gather over several axes goes down and up once.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
# ``reduce_scatter_tensor`` under the name newer torch releases give it.
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, DeviceMesh)


class Spmd:
    """A ``DeviceMesh`` as the model code reads it: axis sizes, this rank's
    coordinate on each axis, each axis's process group.

    ``reduce_pod=False`` (the compressed train step) leaves the "pod" axis
    out of every gradient and loss reduction: each pod computes its own
    gradients, which ``optim.grad_compression`` then exchanges."""

    def __init__(self, mesh, reduce_pod: bool = True):
        if isinstance(mesh, Spmd):
            mesh = mesh.mesh
        if not _is_device_mesh(mesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = dict(zip(self.names, tuple(mesh.mesh.shape)))
        self.model = self.sizes.get("model", 1)
        self.batch_axes = tuple(a for a in ("pod", "data") if a in self.names)
        self.reduce_pod = reduce_pod
        # The axes a loss's partial sums and a replicated leaf's gradient
        # are reduced over.
        self.grad_axes = tuple(a for a in self.batch_axes if reduce_pod or a != "pod")
        self.dp = math.prod(self.sizes[a] for a in self.grad_axes)
        self._groups: dict[str, object] = {}

    @property
    def device(self) -> torch.device:
        """This rank's device: the mesh's type, on cards the current one
        (asked only here, so a mesh over fake tensors needs no card)."""
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

    @property
    def world(self) -> int:
        return math.prod(self.sizes.values())

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def group(self, axis: str):
        if axis not in self._groups:
            self._groups[axis] = self.mesh.get_group(axis)
        return self._groups[axis]

    def rank(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis) if self.size(axis) > 1 else 0

    def index(self, axes) -> tuple[int, int]:
        """(this rank's block, the number of blocks) of a dimension split
        over ``axes`` (one name or a tuple, the first the most significant,
        as a PartitionSpec entry)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx, n = 0, 1
        for a in axes:
            idx = idx * self.size(a) + self.rank(a)
            n *= self.size(a)
        return idx, n


def as_spmd(mesh) -> Spmd | None:
    """``None``, an ``Spmd`` as it is, or a ``DeviceMesh`` wrapped (anything
    else raises ``TypeError``)."""
    if mesh is None or isinstance(mesh, Spmd):
        return mesh
    return Spmd(mesh)


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _gather_raw(x: torch.Tensor, sp: Spmd, axis: str, dim: int) -> torch.Tensor:
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(sp.size(axis))]
    dist.all_gather(parts, src, group=sp.group(axis))
    return torch.cat(parts, dim=dim)


def _reduce_scatter_raw(x: torch.Tensor, sp: Spmd, axis: str, dim: int) -> torch.Tensor:
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // sp.size(axis), *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _REDUCE_SCATTER(out, src, group=sp.group(axis))
    return out.movedim(0, dim).contiguous()


def _run_staged(x: torch.Tensor, sp: Spmd, axes, fn) -> torch.Tensor:
    """``fn`` of ``x`` on the host when a gloo group of ``axes`` would read
    a CUDA operand (one copy down and one up however many collectives ``fn``
    runs), else on its device."""
    staged = any(_staged(x, sp.group(a)) for a in axes)
    out = fn(x.detach().cpu() if staged else x.detach())
    return out.to(x.device) if staged else out


def all_reduce(x: torch.Tensor, sp: Spmd, axes: Sequence[str], op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``axes`` (one axis after another), a new tensor."""
    live = [a for a in ((axes,) if isinstance(axes, str) else axes) if sp.size(a) > 1]
    if not live:
        return x

    def run(t):
        buf = t.contiguous()
        if buf.untyped_storage() is x.untyped_storage():
            buf = buf.clone()  # all_reduce works in place; the caller's tensor stays
        for a in live:
            dist.all_reduce(buf, op=_OPS[op], group=sp.group(a))
        return buf

    return _run_staged(x, sp, live, run)


def gather_steps(x: torch.Tensor, sp: Spmd, steps) -> torch.Tensor:
    """``x`` all-gathered over each ``(axis, dim)`` of ``steps`` in turn."""
    steps = [(a, d) for a, d in steps if sp.size(a) > 1]
    if not steps:
        return x

    def run(t):
        for axis, dim in steps:
            t = _gather_raw(t, sp, axis, dim)
        return t

    return _run_staged(x, sp, [a for a, _ in steps], run)


def all_gather(x: torch.Tensor, sp: Spmd, axis: str, dim: int) -> torch.Tensor:
    """The blocks of ``x`` on ``axis``'s ranks concatenated along ``dim``."""
    return gather_steps(x, sp, [(axis, dim)])


def own_slice(x: torch.Tensor, sp: Spmd, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` split over ``axes``."""
    idx, n = sp.index(axes)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, idx * size, size)


def all_to_all(x: torch.Tensor, sp: Spmd, axis: str, in_splits: Sequence[int],
               out_splits: Sequence[int]) -> torch.Tensor:
    """``x``'s dim 0 cut into blocks of ``in_splits``, block t sent to
    ``axis``-rank t; returns the blocks every rank sent here (rank t's of
    ``out_splits[t]`` rows) concatenated in rank order."""
    if sp.size(axis) == 1:
        return x

    def run(t):
        src = t.contiguous()
        out = torch.empty((sum(out_splits), *src.shape[1:]), dtype=src.dtype, device=src.device)
        dist.all_to_all_single(out, src, output_split_sizes=list(out_splits),
                               input_split_sizes=list(in_splits), group=sp.group(axis))
        return out

    return _run_staged(x, sp, [axis], run)


def exchange(x: torch.Tensor, sp: Spmd, axis: str, to: int, frm: int) -> torch.Tensor:
    """Send ``x`` to ``axis``-rank ``to``, return what ``axis``-rank ``frm``
    sent (same shape and dtype)."""
    group = sp.group(axis)
    staged = _staged(x, group)
    out = (x.detach().cpu() if staged else x.detach()).contiguous()
    buf = torch.empty_like(out)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, out, dist.get_global_rank(group, to), group),
        dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, frm), group),
    ])
    for req in reqs:
        req.wait()
    return buf.to(x.device) if staged else buf


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------


def _live(sp: Spmd | None, axes) -> tuple[str, ...]:
    if sp is None:
        return ()
    return tuple(a for a in ((axes,) if isinstance(axes, str) else axes) if sp.size(a) > 1)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp, axes):
        ctx.sp, ctx.axes = sp, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.sp, ctx.axes), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp, axes, both):
        ctx.sp, ctx.axes, ctx.both = sp, axes, both
        return all_reduce(x, sp, axes)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce(g, ctx.sp, ctx.axes) if ctx.both else g), None, None, None


class _Gather(torch.autograd.Function):
    """All-gathers over ``steps``, ``(axis, dim, grad)`` each, in turn; the
    backward undoes them in reverse order (staged once either way)."""

    @staticmethod
    def forward(ctx, x, sp, steps):
        ctx.sp, ctx.steps = sp, steps
        return gather_steps(x, sp, [(a, d) for a, d, _ in steps])

    @staticmethod
    def backward(ctx, g):
        sp = ctx.sp

        def run(t):
            for axis, dim, grad in reversed(ctx.steps):
                t = (_reduce_scatter_raw(t, sp, axis, dim) if grad == "sum"
                     else own_slice(t, sp, axis, dim).contiguous())
            return t

        return _run_staged(g, sp, [a for a, _, _ in ctx.steps], run), None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter over ``axis`` along ``dim`` forward; all-gather of the
    gradient backward."""

    @staticmethod
    def forward(ctx, x, sp, axis, dim):
        ctx.sp, ctx.axis, ctx.dim = sp, axis, dim
        return _run_staged(x, sp, [axis], lambda t: _reduce_scatter_raw(t, sp, axis, dim))

    @staticmethod
    def backward(ctx, g):
        return gather_steps(g, ctx.sp, [(ctx.axis, ctx.dim)]), None, None, None


class _Split(torch.autograd.Function):
    """This rank's block over ``axis`` along ``dim`` forward; all-gather of
    the gradient backward."""

    @staticmethod
    def forward(ctx, x, sp, axis, dim):
        ctx.sp, ctx.axis, ctx.dim = sp, axis, dim
        return own_slice(x, sp, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_steps(g, ctx.sp, [(ctx.axis, ctx.dim)]), None, None, None


class _Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def copy_to(x: torch.Tensor, sp: Spmd | None, axes) -> torch.Tensor:
    live = _live(sp, axes)
    return _Copy.apply(x, sp, live) if live else x


def reduce_from(x: torch.Tensor, sp: Spmd | None, axes) -> torch.Tensor:
    live = _live(sp, axes)
    return _Reduce.apply(x, sp, live, False) if live else x


def reduce_both(x: torch.Tensor, sp: Spmd | None, axes) -> torch.Tensor:
    live = _live(sp, axes)
    return _Reduce.apply(x, sp, live, True) if live else x


def gather(x: torch.Tensor, sp: Spmd | None, steps) -> torch.Tensor:
    """``x`` all-gathered over each ``(axis, dim, grad)`` of ``steps`` (see
    the module's docstring for ``grad``)."""
    steps = tuple(s for s in steps if sp is not None and sp.size(s[0]) > 1)
    if not steps:
        return x
    if any(grad not in ("sum", "slice") for _, _, grad in steps):
        raise ValueError(steps)
    return _Gather.apply(x, sp, steps)


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    return x if s == 1 else _Scale.apply(x, s)


def gather_seq(x: torch.Tensor, sp: Spmd | None, grad: str = "sum") -> torch.Tensor:
    """(B, S / model, ...) -> (B, S, ...): the sequence blocks of "model"
    all-gathered (see the module's docstring for ``grad``)."""
    return gather(x, sp, [("model", 1, grad)])


def reduce_scatter_seq(x: torch.Tensor, sp: Spmd | None) -> torch.Tensor:
    """(B, S, ...) -> (B, S / model, ...): the sum over "model" of ``x``,
    this rank's block of its sequence."""
    return _ReduceScatter.apply(x, sp, "model", 1) if _live(sp, "model") else x


def split_seq(x: torch.Tensor, sp: Spmd | None) -> torch.Tensor:
    """(B, S, ...) -> (B, S / model, ...): this rank's block of the
    sequence."""
    return _Split.apply(x, sp, "model", 1) if _live(sp, "model") else x


def region_input(x: torch.Tensor, sp: Spmd | None, tp: bool, seq: bool) -> torch.Tensor:
    """The input of a part of a layer over "model": tensor-parallel (``tp``)
    or computed whole on every rank, from a stream that is sequence-parallel
    (``seq``: this rank's block, gathered) or whole."""
    if seq:
        return gather_seq(x, sp, grad="sum" if tp else "slice")
    return copy_to(x, sp, ("model",)) if tp else x


def region_output(x: torch.Tensor, sp: Spmd | None, tp: bool, seq: bool) -> torch.Tensor:
    """The output of the part ``region_input`` entered: a tensor-parallel
    part's partial sums reduced (over the sequence's blocks where ``seq``),
    a whole part's output cut to this rank's block where ``seq``."""
    if seq:
        return reduce_scatter_seq(x, sp) if tp else split_seq(x, sp)
    return reduce_from(x, sp, ("model",)) if tp else x


def use_param(t: torch.Tensor, spec, sp: Spmd | None, tensor_parallel: bool,
              model_grad: str = "slice") -> torch.Tensor:
    """A parameter shard as a product reads it.

    Its "data" (FSDP) dimensions are all-gathered, their gradient
    reduce-scattered; a leaf with no "data" dimension gets its gradient
    summed over the data axes instead (and over "pod" unless the step
    exchanges pods itself).  Its "model" dimensions stay local when
    ``tensor_parallel``, else are all-gathered (``model_grad`` says how
    their gradient comes back: see ``gather``)."""
    if sp is None:
        return t
    entries = list(spec) + [None] * (t.ndim - len(spec))
    if sp.reduce_pod:
        t = copy_to(t, sp, ("pod",))
    if "data" not in entries:
        t = copy_to(t, sp, ("data",))
    steps = [(e, dim, "sum" if e == "data" else model_grad) for dim, e in enumerate(entries)
             if e == "data" or (e == "model" and not tensor_parallel)]
    return gather(t, sp, steps)
