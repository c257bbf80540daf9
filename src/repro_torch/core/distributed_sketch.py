"""Distributed / streaming sketch computation (counterpart of
``repro.core.distributed_sketch``).

The canonical mergeable-sketch API is :class:`repro_torch.core.engine.SketchEngine`;
this module keeps the reference's ``SketchState`` accumulator (its layout
is the one train-loop checkpoints carry) and ``sharded_sketch``, which
delegates to the engine's sharded backend.

The sketch is linear in the empirical distribution: sketches of dataset
shards simply add up (weighted by shard sizes).  So

- ``SketchState`` is a mergeable accumulator (sketch sums, count, box
  bounds), the "one pass over X" object of paper §3.1;
- ``sharded_sketch`` sketches each rank's rows and merges the statistics
  with one reduction over the mesh's data axes, whose traffic is O(m),
  independent of N.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch import device as dev_mod
from repro_torch.core import freq_ops as fo
from repro_torch.core import sketch as sk
from repro_torch.core.engine import SketchEngine, rank_block
from repro_torch.kernels import ops as kops


class SketchState(NamedTuple):
    """Mergeable one-pass statistics: merge(a, b) = elementwise combine."""

    sums: torch.Tensor  # (2m,) un-normalised stacked-real sketch sums
    count: torch.Tensor  # () f32 — number of points seen
    lo: torch.Tensor  # (n,) running per-coordinate min
    hi: torch.Tensor  # (n,) running per-coordinate max


def init_state(m: int, n: int, device=dev_mod.DEFAULT) -> SketchState:
    dev = dev_mod.resolve(device)
    return SketchState(
        sums=torch.zeros((2 * m,), dtype=torch.float32, device=dev),
        count=torch.zeros((), dtype=torch.float32, device=dev),
        lo=torch.full((n,), float("inf"), dtype=torch.float32, device=dev),
        hi=torch.full((n,), float("-inf"), dtype=torch.float32, device=dev),
    )


def update(state: SketchState, x: torch.Tensor, w) -> SketchState:
    """Fold a batch ``x: (B, n)`` into the accumulator (streaming use).

    ``w``: a ``core.freq_ops.FrequencyOperator`` or a raw ``(n, m)`` matrix.
    The batch's unnormalised sums come from the sketch kernels on the
    state's device (``kernels.ops.fourier_sketch_sums``: kernel 1 for a
    dense operator, kernel 4 for a structured one; their plain versions on
    the CPU), as the engine's do.
    """
    x = torch.as_tensor(x, dtype=torch.float32).to(state.sums.device).contiguous()
    b = x.shape[0]
    ones = torch.ones((b,), dtype=torch.float32, device=x.device)
    part = sk._stacked(*kops.fourier_sketch_sums(x, fo.as_operator(w).to(x.device), ones))
    return SketchState(
        sums=state.sums + part,
        count=state.count + b,
        lo=torch.minimum(state.lo, torch.amin(x, dim=0)),
        hi=torch.maximum(state.hi, torch.amax(x, dim=0)),
    )


def merge(a: SketchState, b: SketchState) -> SketchState:
    return SketchState(
        sums=a.sums + b.sums,
        count=a.count + b.count,
        lo=torch.minimum(a.lo, b.lo),
        hi=torch.maximum(a.hi, b.hi),
    )


def finalize(state: SketchState) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (z stacked-real (2m,), lower (n,), upper (n,))."""
    z = state.sums / torch.clamp(state.count, min=1.0)
    return z, state.lo, state.hi


def sharded_sketch(
    x: torch.Tensor,
    w,
    mesh,
    data_axes: Sequence[str] = ("data",),
    reduce_topology: str = "allreduce",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-pass distributed sketch and bounds over a ``DeviceMesh``.

    ``x: (N_r, n)`` is this rank's rows (``shard_points`` cuts them out of a
    global batch); other mesh axes hold replicas.  Returns the replicated
    ``(z, lo, hi)`` of all ranks' rows.  A thin wrapper over
    :class:`SketchEngine` (backend ``"sharded"``, on the mesh's device
    type): the cross-rank merge is the engine's ``merge`` as a collective,
    and ``reduce_topology`` picks its schedule (``core.topology``).
    """
    eng = SketchEngine(
        w, "sharded", device=mesh.device_type, mesh=mesh, data_axes=tuple(data_axes),
        reduce_topology=reduce_topology,
    )
    return eng.sketch(x)


def shard_points(x: torch.Tensor, mesh, data_axes: Sequence[str] = ("data",)) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s leading axis over
    ``data_axes`` (see ``engine.rank_block``)."""
    return rank_block(x, mesh, tuple(data_axes))
