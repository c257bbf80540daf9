"""Multi-pod dry run (counterpart of ``repro.launch.dryrun``).

For every (arch x shape) cell: one rank's step of the production mesh
(16 x 16, or 2 x 16 x 16 with ``--multi-pod``) on fake tensors, costed op
by op (``utils.hlo.CostMode``: flops, HBM bytes, collective bytes, live
bytes), with the H100's roofline terms (``utils.roofline``) written to
experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

No card and no other process is needed.  The reference's ``XLA_FLAGS``
line (512 placeholder CPU devices) has its counterpart in ``fake_group``: a
process group of 256 or 512 ranks, this process rank 0, on the ``fake``
backend that ships with torch (``torch.testing._internal.distributed
.fake_pg``), whose collectives complete at once and move nothing.  The step
is the one a rank runs (train: ``launch.train.jit_train_step``; prefill:
``launch.serve.make_prefill``; decode: ``make_serve_step``), its inputs
each rank's blocks (``parallel.sharding.local_shape`` of the specs) made
under ``FakeTensorMode``: shapes, dtypes and a device, nothing allocated.

The fake tensors are CUDA tensors where a card is visible, the card's
path.  Without one they are CPU tensors, and the result says so
(``fake_device``): torch built without CUDA has no device guard for a
fake CUDA tensor, which autograd asks for a stream and indexing for a
device.  The branches the steps take on ``is_cuda`` are
``torch.utils.checkpoint``'s save and restore of the device's RNG state
(no aten op), the autograd engine's device thread (the cost mode follows
it) and ``parallel.collectives._staged`` (a gloo group only: the fake
group never stages).  None changes a count: the smoke's ``[dryrun]``
phase traces llama3.2-1B's train step on fake CUDA and fake CPU tensors
and runs it on the card, and holds the three costs equal.

Result keys are the reference's; ``lower_s`` is the seconds to build the
step and its fake inputs, ``compile_s`` the fake trace's (nothing is
compiled), ``memory_analysis`` the counted live bytes (``utils.hlo``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs.base import ARCHS, SHAPES, ShapeConfig, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import train_batch_specs
from repro_torch.parallel import sharding as sh
from repro_torch.utils import hlo
from repro_torch.utils import roofline as rl

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

__all__ = ["cell_skipped", "fake_group", "production_device_mesh", "fake_device",
           "fake_inputs", "run_cell", "save", "OUT_DIR"]


def cell_skipped(cfg, shape: ShapeConfig) -> str | None:
    if shape.kind == "long_decode" and cfg.long_context == "skip":
        return "pure full-attention arch: long_500k skipped per DESIGN.md §4"
    return None


def _parse_override(kv: str):
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    return k, v


def fake_group(world: int) -> None:
    """This process as rank 0 of a ``world``-rank group on the ``fake``
    backend (an existing fake group of another size is replaced; any other
    group raises)."""
    import torch.testing._internal.distributed.fake_pg as fake_pg  # registers "fake"

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group exists: the dry run "
                               "needs a process of its own")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0, world_size=world)


def production_device_mesh(multi_pod: bool = False):
    """The production mesh as a ``DeviceMesh`` of CUDA ranks over a fake
    group, this process rank 0."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = make_production_mesh(multi_pod=multi_pod)
    fake_group(math.prod(shape.shape))
    return init_device_mesh("cuda", shape.shape, mesh_dim_names=shape.axis_names)


def fake_device() -> torch.device:
    """The fake tensors' device: the card where one is visible, else the
    CPU (see the module's docstring)."""
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


def fake_inputs(shapes, specs, mesh, device) -> object:
    """Each rank's block of every ``sds`` leaf of ``shapes`` placed by the
    matching spec of ``specs`` on ``mesh`` (a ``MeshShape``), as an empty
    tensor on ``device`` (call it under ``FakeTensorMode``)."""
    flat = dict(sh.walk(specs))

    def leaf(path, s):
        return torch.empty(sh.local_shape(s.shape, flat[path], mesh), dtype=s.dtype,
                           device=device)

    return sh.map_with_path(leaf, shapes)


def _step_and_specs(cfg, shape: ShapeConfig, mesh):
    """(step, [(shapes, specs) of each tensor input], trailing inputs, model
    flops) of the cell."""
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        from repro_torch.launch.train import jit_train_step

        step, shapes, specs, bspecs = jit_train_step(cfg, shape, mesh)
        return (step, [(shapes, specs), (train_batch_specs(cfg, shape), bspecs)], (),
                rl.train_model_flops(cfg.active_param_count(), tokens))
    from repro_torch.launch.serve import make_prefill, make_serve_step, serve_specs

    specs = serve_specs(cfg, shape, mesh)
    if shape.kind == "prefill":
        step, (pshapes, bshapes) = make_prefill(cfg, shape, mesh)
        return (step, [(pshapes, specs["params"]), (bshapes, specs["batch"])], (),
                2.0 * cfg.active_param_count() * tokens)
    # decode / long_decode: one token at the cache's last position.
    step, (pshapes, tok, cshapes, _) = make_serve_step(cfg, shape, mesh)
    return (step, [(pshapes, specs["params"]), ([tok], [specs["token"]]),
                   (cshapes, specs["cache"])], (shape.seq_len - 1,),
            rl.decode_model_flops(cfg.active_param_count(), shape.global_batch))


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    verbose: bool = True,
    overrides: dict | None = None,
) -> dict:
    """One cell's result dict (the reference's keys)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_leaves

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    result: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "kind": shape.kind,
    }
    skip = cell_skipped(cfg, shape)
    if skip:
        result["status"] = "skipped"
        result["reason"] = skip
        return result

    mesh = production_device_mesh(multi_pod)
    chips = mesh.size()
    dev = fake_device()
    t0 = time.time()
    tokens = shape.global_batch * shape.seq_len
    step, trees, extra, model_flops = _step_and_specs(cfg, shape, mesh)
    with FakeTensorMode():
        layout = make_production_mesh(multi_pod=multi_pod)
        inputs = [fake_inputs(shapes, specs, layout, dev) for shapes, specs in trees]
        if shape.kind == "train":
            for p in tree_leaves(inputs[0]["params"]):
                p.requires_grad_(True)
        elif shape.kind != "prefill":
            inputs[1] = inputs[1][0]  # the decode's token, a tensor
        t_lower = time.time() - t0
        costs = hlo.analyze(step, *inputs, *extra)
    t_compile = time.time() - t0 - t_lower

    roof = rl.analyze(costs, chips, model_flops)
    result.update(
        status="ok",
        lower_s=round(t_lower, 1),
        compile_s=round(t_compile, 1),
        chips=chips,
        params=cfg.param_count(),
        active_params=cfg.active_param_count(),
        tokens=tokens,
        flops_per_device=roof.flops,
        hbm_bytes_per_device=roof.hbm_bytes,
        collective_bytes_per_device=roof.collective_bytes,
        compute_s=roof.compute_s,
        memory_s=roof.memory_s,
        collective_s=roof.collective_s,
        dominant=roof.dominant,
        model_flops=roof.model_flops,
        useful_ratio=round(roof.useful_ratio, 4),
        roofline_fraction=round(roof.roofline_fraction(), 4),
    )
    result["collectives"] = {
        op: {"bytes": b, "count": int(costs.coll_count[op])}
        for op, b in sorted(costs.coll_by_op.items())
    }
    result["memory_analysis"] = costs.memory_analysis()
    result["fake_device"] = dev.type
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] fake {dev.type} tensors")
        print(f"  memory_analysis: {result['memory_analysis']}")
        print(
            f"  flops/dev {roof.flops:.3e}  hbm/dev {roof.hbm_bytes:.3e}  "
            f"coll/dev {roof.collective_bytes:.3e}"
        )
        print(
            f"  compute {roof.compute_s*1e3:.2f} ms | memory {roof.memory_s*1e3:.2f} ms"
            f" | collective {roof.collective_s*1e3:.2f} ms -> {roof.dominant}-bound"
        )
        print(
            f"  useful_ratio {roof.useful_ratio:.3f}  roofline_fraction "
            f"{roof.roofline_fraction():.3f}  (build {t_lower:.0f}s trace {t_compile:.0f}s)"
        )
    return result


def save(result: dict):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    name = f"{result['arch']}__{result['shape']}__{result['mesh']}.json"
    (OUT_DIR / name).write_text(json.dumps(result, indent=2))


def main(argv=None):  # pragma: no cover - CLI
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument(
        "--set", action="append", default=[],
        help="config override key=value (repeatable), e.g. --set score_dtype=bf16",
    )
    ap.add_argument("--tag", default=None, help="suffix for the output json")
    args = ap.parse_args(argv)
    overrides = dict(_parse_override(kv) for kv in args.set) or None

    cells = []
    if args.all:
        for a in ARCHS:
            for s in SHAPES:
                cells.append((a, s))
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all)"
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        try:
            result = run_cell(arch, shape, args.multi_pod, overrides=overrides)
        except Exception as e:  # noqa: BLE001 - report and continue
            traceback.print_exc()
            result = {
                "arch": arch, "shape": shape,
                "mesh": "2x16x16" if args.multi_pod else "16x16",
                "status": "error", "error": f"{type(e).__name__}: {e}",
            }
            failures += 1
        if args.tag:
            result["tag"] = args.tag
            result["mesh"] = f"{result['mesh']}__{args.tag}"
        save(result)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
