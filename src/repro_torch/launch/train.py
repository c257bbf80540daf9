"""Training step construction (counterpart of ``repro.launch.train``): the
optimizer and parameter dtype an architecture defaults to, the train
state's shapes (on the meta device, nothing allocated), the state itself
on the card, and the train step, on one card or over a mesh.

Used by ``train/train_loop.py``, ``examples/train_lm.py`` and as a CLI:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --smoke [--device cpu]

The step runs eagerly: ``lm_loss`` under autograd (``remat="full"`` by
default), ``torch.autograd.grad`` over the parameters, then the optimizer's
in-place update.  The state is the reference's tree, ``{"params", "opt",
"step"}`` (``step`` an int32 scalar on the card).

Over a mesh (a ``torch.distributed`` ``DeviceMesh``, one process a rank):
``state_specs`` places the state by ``parallel.sharding``'s rules,
``init_sharded_state`` draws the seed's state and keeps each rank's
blocks, and the step built with ``mesh=`` takes the rank's state and its
rows of the batch (``batch_specs``).  Gradients come back already reduced:
an FSDP leaf's reduce-scattered over "data", a replicated leaf's summed over
the batch axes.  ``jit_train_step`` returns the step with the state's
shapes and specs and the batch's specs (nothing is jitted: the name is the
reference's).  ``build_compressed_train_step`` exchanges gradients across
a "pod" axis as int16 with error feedback (``optim.grad_compression``).
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch import device as dev_mod
from repro_torch.configs.base import ModelConfig, ShapeConfig, get_config, get_smoke_config
from repro_torch.launch.specs import make_batch, sds
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import OptConfig, Optimizer, make_optimizer
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as sh

__all__ = ["default_opt_config", "default_param_dtype", "state_shapes", "init_state",
           "state_specs", "init_sharded_state", "build_train_step",
           "build_compressed_train_step", "jit_train_step", "loss_and_grads"]


def default_opt_config(cfg: ModelConfig) -> OptConfig:
    """Adafactor for the giants, AdamW otherwise."""
    big = cfg.param_count() > 50e9
    return OptConfig(name="adafactor" if big else "adamw")


def default_param_dtype(cfg: ModelConfig) -> torch.dtype:
    """bf16 stored parameters for models of 400B and more (Adafactor keeps
    float32 statistics); float32 otherwise."""
    return torch.bfloat16 if cfg.param_count() > 400e9 else torch.float32


def init_state(cfg: ModelConfig, opt: Optimizer, seed: int = 0, param_dtype=None,
               device=dev_mod.DEFAULT, place=None) -> dict:
    """The train state drawn on ``device`` (``init_lm``'s parameters in
    ``param_dtype``, each requiring gradients; the optimizer's zero state;
    step 0).  ``device="meta"`` gives shapes and dtypes only.  ``place``
    (see ``init_lm``) keeps a block of each parameter."""
    param_dtype = param_dtype or default_param_dtype(cfg)
    params = tfm.init_lm(seed, cfg, device=device, place=place)
    params = tree_map(lambda p: p.to(param_dtype) if p.dtype == torch.float32 else p, params)
    for p in tree_flatten(params)[0]:
        p.requires_grad_(True)
    step_dev = tree_flatten(params)[0][0].device
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev)}


def state_shapes(cfg: ModelConfig, opt: Optimizer, param_dtype=None) -> dict:
    """The train state's shapes and dtypes (``sds`` records), built on the
    meta device: nothing is allocated."""
    state = init_state(cfg, opt, param_dtype=param_dtype, device="meta")
    return tree_map(lambda t: sds(tuple(t.shape), t.dtype), state)


def state_specs(state_shape: dict, cfg: ModelConfig, mesh) -> dict:
    """The train state's specs: the parameters' by ``param_specs``, the
    optimizer state's by ``opt_state_specs``, the step replicated."""
    pspecs = sh.param_specs(state_shape["params"], cfg, mesh)
    return {"params": pspecs, "opt": sh.opt_state_specs(state_shape["opt"], pspecs),
            "step": sh.P()}


def init_sharded_state(cfg: ModelConfig, opt: Optimizer, mesh, seed: int = 0,
                       param_dtype=None) -> dict:
    """This rank's blocks of the state ``init_state(cfg, opt, seed)`` draws,
    on the mesh's device.  Each parameter is drawn whole (the seed's bits)
    and cut at once, so the full tree is never resident; the optimizer's
    zero state is made at its blocks' shapes (AdamW8's int8 payloads whole:
    they are replicated)."""
    sp = C.Spmd(mesh)
    shapes = state_shapes(cfg, opt, param_dtype)
    specs = state_specs(shapes, cfg, mesh)
    pflat = dict(sh.walk(specs["params"]))
    place = (lambda path, t: sh.shard_leaf(t, pflat[path], sp).clone())
    state = init_state(cfg, opt, seed, param_dtype, device=sp.device, place=place)
    meta = init_state(cfg, opt, seed, param_dtype, device="meta")["opt"]
    oflat = dict(sh.walk(specs["opt"]))
    state["opt"] = sh.map_with_path(
        lambda path, t: torch.zeros(sh.local_shape(t.shape, oflat[path], sp), dtype=t.dtype,
                                    device=sp.device), meta)
    return state


def loss_and_grads(loss_fn, params):
    """``(loss_fn(params), d loss / d params)`` with the gradients in the
    parameters' tree; ``loss_fn`` may return ``(loss, aux)``, and then the
    result is ``((loss, aux), grads)``."""
    leaves, spec = tree_flatten(params)
    out = loss_fn(params)
    loss = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(loss, leaves)
    return out, tree_unflatten(list(grads), spec)


def build_train_step(
    cfg: ModelConfig,
    opt: Optimizer,
    mesh=None,
    remat: str = "full",
    dtype=torch.bfloat16,
    return_grads: bool = False,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  The state's
    tensors are updated in place (the reference donates them); the metrics
    (``loss``, ``lr``, ``gnorm``) are device scalars.  With ``mesh`` the
    state is this rank's blocks and the batch its rows; ``loss`` is this
    rank's value (the MoE's aux term is its data shard's, as on the
    reference's devices).  ``return_grads``: the metrics also hold
    ``grads``, a copy of the gradients the optimizer took, before clipping
    (on a mesh this rank's blocks, after the step's collectives)."""
    sp = C.as_spmd(mesh)
    pspecs = None if sp is None else \
        sh.param_specs(tfm.init_lm(0, cfg, device="meta"), cfg, sp)

    def train_step(state, batch):
        loss, grads = loss_and_grads(
            lambda p: tfm.lm_loss(p, cfg, batch, mesh=sp, dtype=dtype, remat=remat),
            state["params"])
        kept = {"grads": tree_map(torch.clone, grads)} if return_grads else {}
        _, _, metrics = opt.update(grads, state["opt"], state["params"], state["step"],
                                   mesh=sp, specs=pspecs)
        state["step"].add_(1)
        return state, {"loss": loss.detach(), **metrics, **kept}

    return train_step


def build_compressed_train_step(cfg: ModelConfig, opt: Optimizer, mesh, remat: str = "full",
                                dtype=torch.bfloat16, return_grads: bool = False):
    """Train step with an int16 error-feedback gradient exchange across pods
    (``optim.grad_compression``: a 13-bit payload on an int16 wire, a shared
    max-abs scale).  Each pod computes the gradients of its own rows (exact
    within the pod: its "data" and "model" reductions run as in
    ``build_train_step``), the pods exchange them compressed, and the
    optimizer runs on their mean.  The state gains ``"err"``: this rank's
    block of the error-feedback residual, (1, ...) per leaf (a leading pod
    dimension, ``error_state_specs``).  The loss is the mean of the pods'.
    ``return_grads`` as in ``build_train_step``: the exchanged mean."""
    from repro_torch.optim.grad_compression import compress_allreduce_tree

    sp = C.Spmd(mesh, reduce_pod=False)
    if "pod" not in sp.names:
        raise ValueError(f"the compressed step needs a 'pod' axis, the mesh has {sp.names}")
    n_pods = sp.size("pod")
    pspecs = sh.param_specs(tfm.init_lm(0, cfg, device="meta"), cfg, sp)

    def train_step(state, batch):
        loss, grads = loss_and_grads(
            lambda p: tfm.lm_loss(p, cfg, batch, mesh=sp, dtype=dtype, remat=remat),
            state["params"])
        grads, err = compress_allreduce_tree(grads, state["err"], sp, "pod", specs=pspecs)
        grads = tree_map(lambda g: g / n_pods, grads)
        for old, new in zip(tree_flatten(state["err"])[0], tree_flatten(err)[0], strict=True):
            old.copy_(new)
        loss = C.all_reduce(loss.detach(), sp, ("pod",)) / n_pods
        kept = {"grads": tree_map(torch.clone, grads)} if return_grads else {}
        _, _, metrics = opt.update(grads, state["opt"], state["params"], state["step"],
                                   mesh=sp, specs=pspecs)
        state["step"].add_(1)
        return state, {"loss": loss, **metrics, **kept}

    return train_step


def jit_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh, opt_cfg: OptConfig | None = None,
                   remat: str = "full", dtype=torch.bfloat16, return_grads: bool = False):
    """The mesh's train step with ``(state shapes, state specs, batch
    specs)``: ``(step, shapes, state_specs, batch_specs)``."""
    opt_cfg = opt_cfg or default_opt_config(cfg)
    opt = make_optimizer(opt_cfg)
    shapes = state_shapes(cfg, opt)
    specs = state_specs(shapes, cfg, mesh)
    step = build_train_step(cfg, opt, mesh=mesh, remat=remat, dtype=dtype,
                            return_grads=return_grads)
    return step, shapes, specs, sh.batch_specs(cfg, shape, mesh)


def main(argv=None):  # pragma: no cover - CLI
    import argparse

    ap = argparse.ArgumentParser(description="Train steps of an architecture on one card.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--device", default=dev_mod.DEFAULT,
                    help="where to run (default the CUDA card; 'cpu' for a CPU run)")
    args = ap.parse_args(argv)

    dev = dev_mod.resolve(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    opt = make_optimizer(default_opt_config(cfg))
    state = init_state(cfg, opt, device=dev)
    step = build_train_step(cfg, opt)
    for i in range(args.steps):
        batch = make_batch(cfg, shape, dev_mod.generator(i, dev))
        state, metrics = step(state, batch)
        print(f"step {i}: loss {float(metrics['loss']):.4f}")


if __name__ == "__main__":
    main()
