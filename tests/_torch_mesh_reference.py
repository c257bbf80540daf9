"""The reference's LM on a mesh, for ``tests/test_torch_mesh.py``.

    python tests/_torch_mesh_reference.py <out.npz> <arch,...> [extras]

Runs under four forced host devices, on meshes built here with
``AxisType.Auto`` axes (``repro.launch.mesh.make_local_mesh`` gives
``Explicit`` axes on this JAX, which ``activation_sharder``'s constraints
refuse).  For the smoke config of each named architecture, on (2, 2) and
(4, 1) ("data", "model") meshes: the parameters (one draw, shared with the
port), the batch, ``lm_loss`` as device 0 holds it, its gradients, and one
AdamW step's parameters.  With ``extras``: ``pipeline_apply`` over 4 "pipe"
stages and ``compress_allreduce_tree`` over a (2, 2) ("pod", "data") mesh.
Everything is saved flat in one npz.  The inputs (parameters, batches and
the extras' arrays) are written first, on their own, to ``draws.npz``
beside it, so that the port's ranks can start on them while this process
computes.
"""

import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs.base import get_smoke_config  # noqa: E402
from repro.models import transformer as tfm  # noqa: E402
from repro.optim import optimizers as opt_mod  # noqa: E402
from repro.parallel import sharding as sh  # noqa: E402

MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
B, S = 4, 32


def mesh_config(name):
    """The smoke config of a case's name (``arch``, ``arch@dN`` at d_model
    N, ``arch@seq``: the same config; see ``tests/_torch_mesh_ranks.py``)."""
    import dataclasses

    arch, _, tag = name.partition("@")
    cfg = get_smoke_config(arch)
    if tag.startswith("d"):
        cfg = dataclasses.replace(cfg, d_model=int(tag[1:]))
    return cfg


def batch_of(cfg, seed):
    """The batch: S positions in all (a vision prefix's patches count), so that
    no attention block is padded (the reference's padded last block reads
    shifted positions: ROADMAP Queue 3)."""
    rng = np.random.default_rng(seed)
    s = S - cfg.frontend_len if cfg.frontend == "vision" else S
    tokens = rng.integers(0, cfg.vocab_size, size=(B, s)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


def flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/" + sh._path_str(path)] = np.asarray(leaf)
    return out


def draw_extras() -> dict:
    """The pipeline's weights and microbatches and the pods' gradients."""
    rng = np.random.default_rng(7)
    return {"pipe/ws": (rng.standard_normal((4, 16, 16)) / 4.0).astype(np.float32),
            "pipe/x": rng.standard_normal((8, 2, 16)).astype(np.float32),
            "gc/g": rng.standard_normal((2, 4096)).astype(np.float32)}


def main(path, archs, extras):
    out = {}
    draws = {arch: (tfm.init_lm(jax.random.PRNGKey(sum(map(ord, arch))), mesh_config(arch)),
                    batch_of(mesh_config(arch), 100 + sum(map(ord, arch))))
             for arch in archs}
    for arch, (params, batch) in draws.items():
        out.update(flat(params, f"{arch}/params"))
        out.update({f"{arch}/batch/{k}": v for k, v in batch.items()})
    if extras:
        out.update(draw_extras())
    ready = Path(path).with_name("draws.npz")
    np.savez(ready.with_suffix(".tmp.npz"), **out)
    os.replace(ready.with_suffix(".tmp.npz"), ready)
    opt = opt_mod.make_optimizer(opt_mod.OptConfig(name="adamw"))
    update = jax.jit(opt.update)
    for arch, (params, batch) in draws.items():
        cfg = mesh_config(arch)
        for name, shape in MESHES.items():
            mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
            pspecs = sh.param_specs(jax.eval_shape(lambda: params), cfg, mesh)
            placed = jax.device_put(params, sh.to_shardings(pspecs, mesh))
            bspecs = sh.batch_specs(cfg, type("S", (), {"global_batch": B, "kind": "train"})(),
                                    mesh)
            b_placed = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                                      sh.to_shardings(bspecs, mesh))

            def loss_fn(p, b):
                return tfm.lm_loss(p, cfg, b, mesh=mesh, dtype=jnp.float32)

            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(placed, b_placed)
            grads = jax.device_get(grads)
            out[f"{arch}/{name}/loss"] = np.asarray(loss)
            out.update(flat(grads, f"{arch}/{name}/grads"))
            new, _, _ = update(grads, opt.init(params), params, jnp.zeros((), jnp.int32))
            out.update(flat(new, f"{arch}/{name}/step"))
    if extras:
        out.update(pipeline_and_compression(out))
    np.savez(path, **out)


def pipeline_and_compression(inputs: dict) -> dict:
    out = {}
    # GPipe over 4 stages.
    from repro.parallel.pipeline import pipeline_apply

    ws, xm = inputs["pipe/ws"], inputs["pipe/x"]
    pipe = jax.make_mesh((4,), ("pipe",), axis_types=(AxisType.Auto,))
    out["pipe/out"] = np.asarray(pipeline_apply(lambda w, h: jnp.tanh(h @ w), jnp.asarray(ws),
                                                jnp.asarray(xm), pipe, axis="pipe"))

    # The compressed all-reduce over (2, 2) ("pod", "data").
    from jax.sharding import PartitionSpec as P

    from repro.optim.grad_compression import compress_allreduce_tree
    from repro.utils.compat import shard_map

    pod = jax.make_mesh((2, 2), ("pod", "data"), axis_types=(AxisType.Auto,) * 2)
    g_pods = inputs["gc/g"]

    def body(g, e):
        return compress_allreduce_tree({"g": g[0]}, {"g": e}, "pod")

    fn = jax.jit(shard_map(body, mesh=pod, in_specs=(P("pod"), P("pod")),
                           out_specs=({"g": P()}, {"g": P("pod")}), axis_names={"pod"},
                           check_vma=True))
    err = jnp.zeros((2, 4096))
    sums = []
    for _ in range(20):
        s, e = fn(jnp.asarray(g_pods), err)
        err = e["g"]
        sums.append(np.asarray(s["g"]))
        if len(sums) == 1:
            out["gc/err1"] = np.asarray(err)
    out["gc/sums"] = np.stack(sums)
    return out


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2].split(","), len(sys.argv) > 3)
