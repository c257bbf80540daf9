"""The training loop (counterpart of ``repro.train.train_loop``):
checkpoint and restart, preemption, monitoring, balancing, on one card or
over a mesh.

Fault-tolerance model:
- the state (parameters, optimizer state, step, monitor sketch) checkpoints
  atomically and asynchronously every ``ckpt_every`` steps and after the
  last; a restart resumes from the latest complete checkpoint;
- data is a pure function of (seed, step): a resume replays nothing and
  skips nothing;
- a preemption request (SIGTERM, or the file ``preempt_file`` appearing)
  forces a synchronous checkpoint, then the loop stops.

The CKM parts: the activation monitor folds each step's pooled hidden
states into a sketch (kernel 4 on the card at d_model >= 512), and the
compressive balancer folds each batch's document embeddings into its own
(kernel 1) and re-weights the data mixture every ``balance_every`` steps
from a decode.  Metrics come back to the host only every ``log_every``
steps and at the last.  As in the reference, the balancer's sketch and the
mixture weights are not part of the checkpoint: a run resumed with
balancing on starts its mixture from uniform again.

Over a mesh (``mesh=`` a ``DeviceMesh``, one process a rank, every rank
calling ``run``): each rank makes the whole batch (the data is a pure
function of (seed, step)) and keeps its rows (``batch_specs``); the state
is the rank's blocks (``init_sharded_state``).  The monitor's sketch of a
step is folded by each rank from its rows (kernel 4 on the card) and summed
over the data ranks; the balancer folds the whole batch's document
embeddings on every rank (kernel 1), so every rank holds the same mixture.
Checkpoints hold the gathered state, written by global rank 0, so a run
restores onto any mesh (or none): the reference's claim.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from pathlib import Path
from typing import Any

import torch
from torch.utils._pytree import tree_flatten

from repro_torch import device as dev_mod
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.clustering import CompressiveBalancer
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.core import distributed_sketch as ds
from repro_torch.launch.train import (
    default_opt_config,
    init_sharded_state,
    init_state,
    loss_and_grads,
    state_shapes,
    state_specs,
)
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as sh
from repro_torch.train.monitor import ActivationMonitor


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    keep: int = 3
    monitor_k: int = 0  # 0 = off
    balance_every: int = 0  # 0 = off; else rebalance the mixture every N steps
    preempt_file: str | None = None  # touch this file to request preemption
    log_every: int = 10
    dtype: Any = torch.bfloat16
    remat: str = "none"


def _pooled_loss(params, cfg: ModelConfig, batch: dict, dtype, remat: str, mesh=None):
    """(loss, pooled): ``lm_loss``'s value and the mean-pooled final hidden
    states (B, d) in float32."""
    loss, x = tfm.loss_and_hidden(params, cfg, batch, mesh, dtype, remat)
    return loss, torch.mean(x.to(torch.float32), dim=1)


def _sum_sketch(part: ds.SketchState, sp) -> ds.SketchState:
    """A sketch state summed over the batch axes (bounds by min and max)."""
    axes = sp.batch_axes
    return ds.SketchState(sums=C.all_reduce(part.sums, sp, axes),
                          count=C.all_reduce(part.count, sp, axes),
                          lo=C.all_reduce(part.lo, sp, axes, "min"),
                          hi=C.all_reduce(part.hi, sp, axes, "max"))


def _barrier(sp, dev) -> None:
    C.all_reduce(torch.zeros((1,), device=dev), sp, sp.names)


class _StepTimer:
    """The device time of one train step: CUDA events around it on the card
    (read at the next log point, where the host waits anyway), the host
    clock on the CPU, where the step is synchronous."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.start, self.end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.end.record()
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3

    def elapsed_ms(self) -> float:
        if self.cuda:
            self.end.synchronize()
            return self.start.elapsed_time(self.end)
        return self.ms


def run(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    loop: LoopConfig,
    data_cfg: DataConfig | None = None,
    opt_cfg=None,
    seed: int = 0,
    device=dev_mod.DEFAULT,
) -> dict:
    """Train; resume from the latest checkpoint in ``loop.ckpt_dir`` if any.

    Returns ``{"history": [...], "state": the final state, "save_s":
    seconds of the last checkpoint's save (snapshot and write),
    "balance_weights": the balancer's last sampling weights or None}``, and
    ``"monitor_result"`` (the monitor's decode) when the monitor is on.  A
    history entry, one per logged step, holds ``step``, ``loss``, ``lr``,
    ``gnorm``, ``step_ms`` (the step function's time: CUDA events on the
    card), ``wall_ms`` (the loop's host time per step since the previous log
    point's read-back: batch synthesis and upload, the step, the balancer's
    update and decode, and any checkpoint between log points) and, on the
    card, ``peak_bytes`` (``torch.cuda.max_memory_allocated`` after it: the
    peak since the caller last reset it).  ``"balance_s"`` lists the seconds
    of each balancer decode (CKM and the re-weighting).  Over a mesh the
    state is the rank's blocks and ``loss`` its value.
    """
    sp = C.as_spmd(mesh)
    dev = dev_mod.resolve(device) if sp is None else sp.device
    lead = sp is None or torch.distributed.get_rank() == 0
    opt_cfg = opt_cfg or default_opt_config(cfg)
    opt = make_optimizer(opt_cfg)
    data_cfg = data_cfg or DataConfig(seed=seed)
    source = SyntheticLM(cfg, shape, data_cfg, device=dev)
    ckpt = Checkpointer(loop.ckpt_dir, keep=loop.keep)

    monitor = ActivationMonitor(dim=cfg.d_model, k=loop.monitor_k, device=dev) \
        if loop.monitor_k else None
    balancer = CompressiveBalancer(k=data_cfg.n_domains, dim=data_cfg.embed_dim,
                                   seed=seed + 3, device=dev) if loop.balance_every else None

    specs = bspecs = None
    rows_split = False
    if sp is not None:
        specs = state_specs(state_shapes(cfg, opt), cfg, sp)
        bspecs = sh.batch_specs(cfg, shape, sp)
        rows_split = sh.batch_entry(sp, shape.global_batch) is not None

    def step_fn(state, batch):
        (loss, pooled), grads = loss_and_grads(
            lambda p: _pooled_loss(p, cfg, batch, loop.dtype, loop.remat, sp), state["params"])
        _, _, metrics = opt.update(grads, state["opt"], state["params"], state["step"],
                                   mesh=sp, specs=specs and specs["params"])
        state["step"].add_(1)
        if monitor is not None and sp is None:
            state["monitor"] = monitor.update(state["monitor"], pooled)
        elif monitor is not None:
            part = monitor.update(monitor.init_state(), pooled)
            state["monitor"] = ds.merge(state["monitor"], _sum_sketch(part, sp) if rows_split
                                        else part)
        return state, {"loss": loss.detach(), **metrics}

    def whole(state):
        """The state as the checkpoint holds it (gathered on a mesh)."""
        if sp is None:
            return state
        out = sh.gather_tree({k: v for k, v in state.items() if k != "monitor"},
                             {k: specs[k] for k in state if k != "monitor"}, sp)
        if "monitor" in state:
            out["monitor"] = state["monitor"]
        return out

    # -- init or resume ---------------------------------------------------------
    state = init_state(cfg, opt, seed=seed, device=dev) if sp is None \
        else init_sharded_state(cfg, opt, sp, seed=seed)
    if monitor is not None:
        state["monitor"] = monitor.init_state()
    if ckpt.latest_step() is not None:
        if sp is None:
            state = ckpt.restore(state)
        else:
            full = ckpt.restore(whole(state))
            mon = full.pop("monitor", None)
            state = sh.shard_tree(full, {k: specs[k] for k in full}, sp)
            if mon is not None:
                state["monitor"] = mon
            del full
        for p in tree_flatten(state["params"])[0]:
            p.requires_grad_(True)
        print(f"[train] resumed from step {ckpt.latest_step()}")
    start = int(state["step"])

    preempted = {"flag": False}

    def _sigterm(_sig, _frm):
        preempted["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, _sigterm)

    history, saved_at, weights, balance_s = [], None, None, []
    t_log, last_log = time.perf_counter(), start
    try:
        for step in range(start, loop.steps):
            host = source.batch_numpy(step)
            embeds = host.pop("_doc_embeds")
            host.pop("_domains")
            batch = {k: torch.from_numpy(a.copy()).to(dev) for k, a in host.items()}
            if sp is not None:
                batch = sh.shard_tree(batch, bspecs, sp)
            logged = (step + 1) % loop.log_every == 0 or step == loop.steps - 1
            timer = _StepTimer(dev) if logged else None
            state, metrics = step_fn(state, batch)
            if timer is not None:
                timer.stop()
            if balancer is not None:
                balancer.update(embeds)
                if (step + 1) % loop.balance_every == 0:
                    t0 = time.perf_counter()
                    weights = balancer.balanced_weights(balancer.cluster())
                    balance_s.append(time.perf_counter() - t0)
                    source.set_domain_weights(weights)
            if logged:
                m = {k: float(v) for k, v in metrics.items()}
                m["step_ms"] = timer.elapsed_ms()
                now = time.perf_counter()
                m["wall_ms"] = (now - t_log) * 1e3 / (step + 1 - last_log)
                t_log, last_log = now, step + 1
                if dev.type == "cuda":
                    m["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
                history.append({"step": step + 1, **m})
                print(f"[train] step {step + 1}: loss {m['loss']:.4f}")
            want_ckpt = (step + 1) % loop.ckpt_every == 0
            preempt = preempted["flag"] or bool(
                loop.preempt_file and Path(loop.preempt_file).exists())
            if sp is not None and sp.world > 1:
                # Every rank stops at the same step.
                flag = torch.tensor([float(preempt)], device=dev)
                preempt = bool(C.all_reduce(flag, sp, sp.names, "max")[0] > 0)
            if want_ckpt or preempt or step == loop.steps - 1:
                saved_at = time.perf_counter()
                snap = whole(state)
                if lead:
                    (ckpt.save if preempt else ckpt.save_async)(int(state["step"]), snap)
                del snap
                if preempt:
                    print("[train] preemption requested: checkpoint flushed, exiting")
                    break
    finally:
        ckpt.wait()
        signal.signal(signal.SIGTERM, old_handler)
        if sp is not None and sp.world > 1:
            _barrier(sp, dev)

    out = {"history": history, "state": state, "balance_weights": weights,
           "balance_s": balance_s,
           "save_s": None if saved_at is None else time.perf_counter() - saved_at}
    if monitor is not None:
        out["monitor_result"] = monitor.decode(state["monitor"])
    return out
