"""Multi-rank scenarios of the port's sharded backend, run by
``tests/test_torch_distributed.py`` on the CPU with gloo.

    python tests/_torch_dist_ranks.py <scenario> <world> <dir>

spawns ``world`` ranks (``torch.multiprocessing``, spawn), each of which
joins a gloo process group through ``file://<dir>/init``, reads the shared
inputs from ``<dir>/inputs.npz``, runs ``<scenario>`` and saves what it got
to ``<dir>/rank<r>.pt``; the test compares those with the reference.  This
file imports neither JAX nor the reference package: the ranks run the port
alone.
"""

from __future__ import annotations

import datetime
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

TOPOLOGIES = ("allreduce", "tree", "ring")
# Every collective gives up after this long, so a hung rank fails the run
# instead of waiting forever.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def _engine(inputs, mesh, topology, *, bits=None, decay=None, data_axes=("data",)):
    from repro_torch import convert
    from repro_torch.core.engine import SketchEngine

    backend = "kernel" if mesh is None else "sharded"
    q = None if bits is None else convert.quantizer_from_numpy(bits, inputs["dither"], device="cpu")
    return SketchEngine(convert.operator_from_numpy(inputs["w"], device="cpu"), backend,
                        device="cpu", mesh=mesh, data_axes=data_axes, quantizer=q,
                        reduce_topology=topology, decay=decay)


def parity(inputs, world):
    """Four ranks: the sharded engine over a (4,) "data" mesh under every
    topology, float, 1-bit and decayed, the ragged stream, async ingest, a
    (2, 2) ("pod", "data") mesh, distributed_sketch, and sharded fits."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import ckm, distributed_sketch as ds, ingest
    from repro_torch.data.pipeline import chunked

    assert world == 4, world
    x = torch.from_numpy(inputs["x"])
    w = torch.from_numpy(inputs["w"])
    out = {}
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    pod = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    for name in TOPOLOGIES:
        e = _engine(inputs, mesh, name)
        out[f"{name}/float"] = e.sketch(e.shard_points(x))
        out[f"{name}/ragged"] = e.sketch_stream(e.shard_points(c) for c in chunked(x[:4003], 1000))
        out[f"{name}/ragged_rows"] = torch.tensor(
            [e.shard_points(c).shape[0] for c in chunked(x[:4003], 1000)])
        q = _engine(inputs, mesh, name, bits=1)
        out[f"{name}/1bit"] = tuple(q.update(q.init_state(), q.shard_points(x)))
        d = _engine(inputs, mesh, name, decay=0.9)
        dq = _engine(inputs, mesh, name, bits=1, decay=0.9)
        s, sq = d.init_state(), dq.init_state()
        for t, c in enumerate(chunked(x, 1000)):
            s = d.update(s, d.shard_points(c), t=t)
            sq = dq.update(sq, dq.shard_points(c), t=t)
        out[f"{name}/decayed"] = tuple(s)
        out[f"{name}/decayed_1bit"] = tuple(sq)
        e2 = _engine(inputs, pod, name, data_axes=("pod", "data"))
        out[f"{name}/pod_data"] = e2.sketch(e2.shard_points(x))
    e = _engine(inputs, mesh, "allreduce")
    blocks = [e.shard_points(c) for c in chunked(x, 512)]
    sync = e.init_state()
    for b in blocks:
        sync = e.update(sync, b)
    out["ingest_sync"] = tuple(sync)
    out["ingest_async"] = tuple(ingest.ingest_stream(e, iter(blocks))[0])
    out["distributed_sketch"] = ds.sharded_sketch(ds.shard_points(x, mesh), w, mesh, ("data",))
    out["distributed_sketch/pod_data"] = ds.sharded_sketch(
        ds.shard_points(x, pod, ("pod", "data")), w, pod, ("pod", "data"), "tree")
    # "data" alone over the (2, 2) mesh: the pods are replicas, and each of
    # the two data ranks of a pod holds half the rows — a 2-way sharded fit.
    cfg = ckm.CKMConfig(k=3, m=48, sketch_backend="sharded", atom_steps=20, joint_steps=10,
                        final_steps=20, nnls_iters=20, reduce_topology="ring")
    res = ckm.fit(7, ds.shard_points(x, pod), cfg, device="cpu", mesh=pod)
    out["fit"] = (res.centroids, res.weights, res.cost, res.sigma2, res.sketch, *res.bounds)
    res_s = ckm.fit_streaming(7, (ds.shard_points(c, pod) for c in chunked(x, 1024)), cfg,
                              device="cpu", mesh=pod)
    out["fit_streaming"] = (res_s.centroids, res_s.weights, res_s.cost, res_s.sigma2,
                            res_s.sketch, *res_s.bounds)
    return out


def tree3(inputs, world):
    """Three ranks: the butterfly refuses the axis; ring and allreduce work."""
    from torch.distributed.device_mesh import init_device_mesh

    x = torch.from_numpy(inputs["x"])
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    out = {}
    for name in ("allreduce", "ring"):
        e = _engine(inputs, mesh, name)
        out[f"{name}/float"] = e.sketch(e.shard_points(x))
        q = _engine(inputs, mesh, name, bits=1)
        out[f"{name}/1bit"] = tuple(q.update(q.init_state(), q.shard_points(x)))
    e = _engine(inputs, mesh, "tree")
    try:
        e.sketch(e.shard_points(x))
        out["tree_error"] = ""
    except ValueError as err:
        out["tree_error"] = str(err)
    return out


SCENARIOS = {"parity": parity, "tree3": tree3}


def _rank(rank: int, world: int, scenario: str, root: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/init", rank=rank,
                            world_size=world, timeout=COLLECTIVE_TIMEOUT)
    try:
        inputs = dict(np.load(f"{root}/inputs.npz"))
        torch.save(SCENARIOS[scenario](inputs, world), f"{root}/rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv: list[str]) -> None:
    scenario, world, root = argv[0], int(argv[1]), argv[2]
    mp.start_processes(_rank, args=(world, scenario, root), nprocs=world, start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1:])
