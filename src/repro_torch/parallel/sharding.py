"""Mesh axis arithmetic and the fleet's tenant mesh (counterpart of
``repro.parallel.sharding.axis_extent`` and ``tenant_mesh``).

``axis_extent`` reads a ``torch.distributed`` ``DeviceMesh`` (the sharded
SketchEngine's, one process a rank) or a :class:`TenantMesh`.  A
``TenantMesh`` is the fleet's single-controller mesh: one process, one
device per block of tenant rows, no process group.  The reference's
``tenant_shard_specs`` (PartitionSpecs for a sharded JAX array) has no
counterpart: no torch tensor spans devices, so the fleet keeps one ordinary
stacked state a block (``core.fleet.FleetShards``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch import device as dev_mod


@dataclasses.dataclass(frozen=True)
class TenantMesh:
    """A 1-D mesh of ``devices`` on the axis ``mesh_dim_names[0]``: block s
    of a tenant-sharded fleet lives on ``devices[s]``.  A device may repeat
    (several blocks on one card, or on the CPU): placement and routing are
    real, concurrency is not."""

    devices: tuple[torch.device, ...]
    mesh_dim_names: tuple[str, ...]

    @property
    def shape(self) -> tuple[int, ...]:
        return (len(self.devices),)


def tenant_mesh(shards: int, axis: str = "tenant", devices=None) -> TenantMesh:
    """1-D mesh for fleet tenant sharding: ``shards`` devices on one axis.

    ``devices=None`` takes the first ``shards`` visible CUDA cards and raises
    when there are fewer (no fallback to the CPU, no sharing of a card).  An
    explicit ``devices`` list is taken in order and may repeat a device,
    e.g. ``[torch.device("cpu")] * 4``.
    """
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if devices is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if shards > cards:
            raise ValueError(
                f"tenant_mesh needs {shards} devices, only {cards} available (visible "
                "CUDA cards; pass devices=[...] to place several blocks on one device)"
            )
        devices = [torch.device("cuda", i) for i in range(shards)]
    devices = [dev_mod.resolve(d) for d in devices]
    if shards > len(devices):
        raise ValueError(f"tenant_mesh needs {shards} devices, only {len(devices)} given")
    return TenantMesh(tuple(devices[:shards]), (str(axis),))


def axis_extent(mesh, axes: Sequence[str]) -> int:
    """Product of the named mesh axes' sizes — the number of ranks a leading
    data axis is split over (the sharded SketchEngine's block count, the
    ``p`` of ``core.topology.wire_cost_model``), or a tenant mesh's block
    count."""
    shape = mesh.shape if isinstance(mesh, TenantMesh) else mesh.mesh.shape
    sizes = dict(zip(mesh.mesh_dim_names, shape))
    ext = 1
    for a in axes:
        ext *= sizes[a]
    return ext
