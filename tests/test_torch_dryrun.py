"""The port's dry run (``repro_torch.launch.dryrun``): ``cell_skipped`` and
the overrides as the reference's; one small config's train step costed on
one device against the reference's compiled step; one 16 x 16 cell of
each kind end to end (256 ranks of a fake group, a subprocess) with the
invariants of ``tests/test_dryrun.py``, the card's 80 GB in place of the
v5e's 16 GB; and the reference's layout on the mesh in the counts: the
vocab-parallel decode's collective bytes, the prefill's attention split
over query heads, kimi-k2's sequence-parallel train step under a card's
80 GB."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import train as ltrain
from repro_torch.launch.specs import train_batch_specs
from repro_torch.optim.optimizers import OptConfig, make_optimizer
from repro_torch.utils import hlo

pytestmark = pytest.mark.torch_port


def _reference_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` to 512 host
    devices: the flag is put back, so JAX in this process keeps its own."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def test_cell_skipped_matches_the_reference():
    from repro.configs.base import get_config as jget

    ref = _reference_dryrun()
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            assert dryrun.cell_skipped(get_config(arch), shape) == ref.cell_skipped(
                jget(arch), ref.SHAPES[name]), (arch, name)
    for kv in ("a=3", "b=0.25", "score_dtype=bf16"):
        assert dryrun._parse_override(kv) == ref._parse_override(kv)


def test_train_step_costs_match_the_reference_compiled_step():
    """llama3.2-1B's smoke config, B = 2, S = 256 (one loss
    chunk), AdamW, remat "full", bf16 compute, on one device."""
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import get_smoke_config as jsmoke
    from repro.launch import train as jtrain
    from repro.launch.specs import train_batch_specs as jbatch
    from repro.optim.optimizers import OptConfig as JOpt
    from repro.optim.optimizers import make_optimizer as jmake
    from repro.utils import hlo as jhlo

    arch, b, s = "llama3.2-1b", 2, 256
    jopt = jmake(JOpt(name="adamw"))
    jstep = jtrain.build_train_step(jsmoke(arch), jopt, remat="full", dtype=jnp.bfloat16)
    compiled = jax.jit(jstep).lower(jtrain.state_shapes(jsmoke(arch), jopt),
                                    jbatch(jsmoke(arch), JShape("t", s, b, "train"))).compile()
    ref = jhlo.analyze_compiled(compiled)

    cfg = get_smoke_config(arch)
    opt = make_optimizer(OptConfig(name="adamw"))
    step = ltrain.build_train_step(cfg, opt, remat="full", dtype=torch.bfloat16)
    is_sds = lambda t: hasattr(t, "dtype")  # noqa: E731
    with FakeTensorMode():
        make = lambda t: torch.empty(t.shape, dtype=t.dtype)  # noqa: E731
        state = tree_map(make, ltrain.state_shapes(cfg, opt), is_leaf=is_sds)
        for p in tree_leaves(state["params"]):
            p.requires_grad_(True)
        batch = tree_map(make, train_batch_specs(cfg, ShapeConfig("t", s, b, "train")),
                         is_leaf=is_sds)
        got = hlo.analyze(step, state, batch)
    # Flops: the port recomputes each loss chunk's logits in the backward
    # (the reference's compiled step does not): one chunk's product more.
    assert got.flops == pytest.approx(ref.flops, rel=0.05), (got.flops, ref.flops)
    assert got.argument_bytes == compiled.memory_analysis().argument_size_in_bytes


_CELLS = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    from repro_torch.launch import dryrun

    dryrun.OUT_DIR = Path(sys.argv[1])
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k"])
    r = json.loads((dryrun.OUT_DIR / "llama3.2-1b__train_4k__16x16.json").read_text())
    r2 = dryrun.run_cell("llama3.2-1b", "decode_32k", multi_pod=False, verbose=False)
    # Nothing falls back: a process group that is not fake refuses the run.
    import torch.distributed as dist
    dist.destroy_process_group()
    dist.init_process_group("gloo", init_method="file://" + sys.argv[1] + "/store", rank=0,
                            world_size=1)
    try:
        dryrun.run_cell("llama3.2-1b", "decode_32k", multi_pod=False, verbose=False)
        refused = False
    except RuntimeError:
        refused = True
    print(json.dumps({"train": r, "decode": r2, "refused": refused}))
""")

# The reference's result keys (``repro.launch.dryrun.run_cell``).
_KEYS = {"arch", "shape", "mesh", "kind", "status", "lower_s", "compile_s", "chips", "params",
         "active_params", "tokens", "flops_per_device", "hbm_bytes_per_device",
         "collective_bytes_per_device", "compute_s", "memory_s", "collective_s", "dominant",
         "model_flops", "useful_ratio", "roofline_fraction", "collectives", "memory_analysis"}


def test_dryrun_cells_end_to_end(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", _CELLS, str(tmp_path)], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    r, r2 = res["train"], res["decode"]
    assert _KEYS <= set(r) and _KEYS <= set(r2)
    assert r["status"] == "ok", r
    assert r["chips"] == 256
    assert r["dominant"] in ("compute", "memory", "collective")
    assert 0.3 < r["useful_ratio"] < 1.2, r["useful_ratio"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0 and r["collective_s"] > 0
    mem = r["memory_analysis"]
    assert (mem["argument_size"] + mem["temp_size"]) < 2 * 80 * 2**30, mem
    assert r2["status"] == "ok"
    # The vocab-parallel serve: this rank's block of the table gathered over
    # "data" and the logits over "model", not the whole table (6.5e7 B).
    assert r2["collective_bytes_per_device"] <= 3.5e7, r2["collectives"]
    assert r["fake_device"] == r2["fake_device"] == ("cuda" if torch.cuda.is_available()
                                                     else "cpu")
    assert res["refused"]


_LAYOUT_CELLS = textwrap.dedent("""
    import json, math
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import sharding as sh

    prefill = dryrun.run_cell("llama3.2-1b", "prefill_32k", multi_pod=False, verbose=False)
    kimi = {n: dryrun.run_cell("kimi-k2-1t-a32b", "train_4k", multi_pod=False, verbose=False,
                               overrides={"n_layers": n})["memory_analysis"] for n in (2, 4)}
    # The full config's arguments: each rank's blocks of its state and batch.
    cfg = get_config("kimi-k2-1t-a32b")
    mesh = dryrun.production_device_mesh()
    _, trees, _, _ = dryrun._step_and_specs(cfg, SHAPES["train_4k"], mesh)
    layout = make_production_mesh()
    args = 0
    for shapes, specs in trees:
        flat = dict(sh.walk(specs))
        for path, s in sh.walk(shapes):
            args += math.prod(sh.local_shape(s.shape, flat[path], layout)) * s.dtype.itemsize
    print(json.dumps({"prefill": prefill, "kimi": kimi, "kimi_args": args,
                      "kimi_layers": cfg.n_layers}))
""")


def test_dryrun_counts_the_mesh_layout(tmp_path):
    """llama3.2-1b's prefill_32k computes each rank's query heads of the
    attention (useful_ratio 0.033 when it was replicated over "model"), and
    kimi-k2's train_4k, its residual stream sequence-parallel, fits a card:
    its full config's arguments plus the temporaries of 2 and 4 layers
    extrapolated linearly to its 61 under 80e9 B a device.  (The cut
    configs take AdamW and float32 parameters where the full one takes
    Adafactor over bf16 ones, so their temporaries bound the full one's
    from above; their arguments do not extrapolate.)"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", _LAYOUT_CELLS], env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    prefill = res["prefill"]
    assert prefill["status"] == "ok" and prefill["useful_ratio"] > 0.3, prefill["useful_ratio"]
    assert prefill["collectives"]["all-to-all"]["count"] == 16  # one a layer, into the cache
    t2, t4 = (res["kimi"][str(n)]["temp_size"] for n in (2, 4))
    temp = t4 + (t4 - t2) / 2 * (res["kimi_layers"] - 4)
    assert res["kimi_args"] + temp < 80e9, (res["kimi_args"], temp)
