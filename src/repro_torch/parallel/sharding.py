"""Mesh axis arithmetic over a ``torch.distributed`` ``DeviceMesh``
(counterpart of ``repro.parallel.sharding.axis_extent``)."""

from __future__ import annotations

from typing import Sequence


def axis_extent(mesh, axes: Sequence[str]) -> int:
    """Product of the named mesh axes' sizes — the number of ranks a leading
    data axis is split over (the sharded SketchEngine's block count, the
    ``p`` of ``core.topology.wire_cost_model``)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    ext = 1
    for a in axes:
        ext *= sizes[a]
    return ext
