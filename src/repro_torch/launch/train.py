"""Training step construction on one card (counterpart of
``repro.launch.train``): the optimizer and parameter dtype an architecture
defaults to, the train state's shapes (on the meta device, nothing
allocated), the state itself on the card, and the train step.

Used by ``train/train_loop.py``, ``examples/train_lm.py`` and as a CLI:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --smoke [--device cpu]

The step runs eagerly: ``lm_loss`` under autograd (``remat="full"`` by
default), ``torch.autograd.grad`` over the parameters, then the optimizer's
in-place update.  The state is the reference's tree, ``{"params", "opt",
"step"}`` (``step`` an int32 scalar on the card).  The reference's
placement over a mesh (``state_specs``, ``jit_train_step``,
``init_sharded_state``) and its compressed step are ROADMAP Queue 1 item 22
(b), part 2: ``mesh`` must be ``None``, and ``build_compressed_train_step``
raises.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch import device as dev_mod
from repro_torch.configs.base import ModelConfig, ShapeConfig, get_config, get_smoke_config
from repro_torch.launch.specs import make_batch, sds
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import OptConfig, Optimizer, make_optimizer

__all__ = ["default_opt_config", "default_param_dtype", "state_shapes", "init_state",
           "build_train_step", "build_compressed_train_step", "loss_and_grads"]


def _part2(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: training runs on one card (the LM on a mesh is ROADMAP "
        "Queue 1 item 22 (b), part 2)"
    )


def _one_card(mesh) -> None:
    if mesh is not None:
        raise _part2("a train step over a mesh")


def default_opt_config(cfg: ModelConfig) -> OptConfig:
    """Adafactor for the giants, AdamW otherwise."""
    big = cfg.param_count() > 50e9
    return OptConfig(name="adafactor" if big else "adamw")


def default_param_dtype(cfg: ModelConfig) -> torch.dtype:
    """bf16 stored parameters for models of 400B and more (Adafactor keeps
    float32 statistics); float32 otherwise."""
    return torch.bfloat16 if cfg.param_count() > 400e9 else torch.float32


def init_state(cfg: ModelConfig, opt: Optimizer, seed: int = 0, param_dtype=None,
               device=dev_mod.DEFAULT) -> dict:
    """The train state drawn on ``device`` (``init_lm``'s parameters in
    ``param_dtype``, each requiring gradients; the optimizer's zero state;
    step 0).  ``device="meta"`` gives shapes and dtypes only."""
    param_dtype = param_dtype or default_param_dtype(cfg)
    params = tfm.init_lm(seed, cfg, device=device)
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
):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  The state's
    tensors are updated in place (the reference donates them); the metrics
    (``loss``, ``lr``, ``gnorm``) are device scalars."""
    _one_card(mesh)

    def train_step(state, batch):
        loss, grads = loss_and_grads(
            lambda p: tfm.lm_loss(p, cfg, batch, dtype=dtype, remat=remat), state["params"])
        _, _, metrics = opt.update(grads, state["opt"], state["params"], state["step"])
        state["step"].add_(1)
        return state, {"loss": loss.detach(), **metrics}

    return train_step


def build_compressed_train_step(cfg: ModelConfig, opt: Optimizer, mesh, remat: str = "full",
                                dtype=torch.bfloat16):
    """The reference's int8 error-feedback gradient exchange across pods."""
    raise _part2("the compressed train step (int8 error-feedback all-reduce across pods)")


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
