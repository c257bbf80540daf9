"""Mesh construction (counterpart of ``repro.launch.mesh``).

``make_production_mesh`` gives the production mesh's axis names and shape
((16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")) with
no devices behind it: that is all the spec functions of
``parallel.sharding`` read, and no process can host 512 ranks.
``make_local_mesh`` is a ``torch.distributed`` ``DeviceMesh`` over the
process group this process belongs to (one process a rank): on the card
unless the caller asks for the CPU.  The group must exist first
(``torch.distributed.init_process_group``, NCCL on cards, gloo on the CPU
or for several ranks on one card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import device as dev_mod
from repro_torch.parallel.sharding import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(axes, shape)


def make_local_mesh(model: int = 1, data: int | None = None, device=dev_mod.DEFAULT):
    """A (data, model) ("data", "model") ``DeviceMesh`` over the process
    group's ranks; ``data`` defaults to world size / ``model``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    dev = dev_mod.resolve(device)
    n = dist.get_world_size()
    data = data or n // model
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks, the group has {n}")
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))
