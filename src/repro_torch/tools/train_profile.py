"""Where an LM train step's time goes on one card.

    PYTHONPATH=src python3 -m repro_torch.tools.train_profile [--arch llama3.2-1b] [--batch 4] [--seq 4096] [--remat full]

Builds the published config's train state on the card (AdamW, float32
parameters) and runs ``launch.train.build_train_step``'s work (bf16
compute) on random batches: two warm-up steps, then ``--steps`` steps timed
by CUDA events, then one step under ``torch.profiler`` with its forward and
backward (``lm_loss`` and ``torch.autograd.grad``) and the optimizer's update
as ranges.  It prints each range's host time, the device time by kernel
class (GEMMs, the attention softmax, other reductions, elementwise and
copies, the rest) and the kernels that took the most device time.

It prints the card's name and power limit first, and raises without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import re
import statistics
import subprocess
from collections import defaultdict

import torch

from repro_torch import device as dev_mod
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import train as ltrain
from repro_torch.launch.specs import make_batch
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import make_optimizer

# Device kernels by class, first match wins (CUDA kernel names as the
# profiler reports them).
_CLASSES = (
    ("gemm", re.compile(r"gemm|xmma|cutlass|nvjet|sm90|ampere|wgmma", re.I)),
    ("softmax", re.compile(r"softmax", re.I)),
    ("reduction", re.compile(r"reduce|norm|sum|logsumexp", re.I)),
    ("elementwise and copies", re.compile(r"elementwise|vectorized|copy|cat|fill|memcpy|memset",
                                          re.I)),
)


_RANGES = ("forward and backward", "optimizer update")


def _kernel_class(name: str) -> str:
    return next((label for label, pat in _CLASSES if pat.search(name)), "other")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    dev = dev_mod.resolve("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)

    cfg = get_config(args.arch)
    shape = ShapeConfig("profile", args.seq, args.batch, "train")
    opt = make_optimizer(ltrain.default_opt_config(cfg))
    state = ltrain.init_state(cfg, opt, device=dev)
    params = state["params"]

    def step(i, ranges=False):
        batch = make_batch(cfg, shape, dev_mod.generator(i, dev))
        with torch.profiler.record_function(_RANGES[0]) if ranges else contextlib.nullcontext():
            loss, grads = ltrain.loss_and_grads(
                lambda p: tfm.lm_loss(p, cfg, batch, dtype=torch.bfloat16, remat=args.remat),
                params)
        with torch.profiler.record_function(_RANGES[1]) if ranges else contextlib.nullcontext():
            opt.update(grads, state["opt"], params, state["step"])
        state["step"].add_(1)
        return loss

    for i in range(2):
        step(i)
    times = []
    for i in range(args.steps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step(2 + i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    print(f"[train_profile] {cfg.name} B={args.batch} S={args.seq} remat {args.remat}: steps "
          f"{', '.join(f'{t:.1f}' for t in times)} ms (median {statistics.median(times):.1f}); "
          f"peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(99, ranges=True)
        torch.cuda.synchronize(dev)
    events = prof.key_averages()
    # A range appears twice: on the host and as a device-side annotation
    # spanning its kernels (not a kernel: left out of the device sums).
    for e in events:
        if e.key in _RANGES and e.cpu_time_total > 0:
            print(f"[train_profile range] {e.key}: host {e.cpu_time_total / 1e3:.1f} ms, device "
                  f"span {e.device_time_total / 1e3:.1f} ms", flush=True)
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0 and e.key not in _RANGES]
    total = sum(e.self_device_time_total for e in kernels)
    by_class = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        c = by_class[_kernel_class(e.key)]
        c[0] += e.self_device_time_total
        c[1] += e.count
    print(f"[train_profile device] {total / 1e3:.1f} ms of device time in "
          f"{sum(e.count for e in kernels)} kernels: " + "; ".join(
              f"{label} {us / 1e3:.1f} ms ({100 * us / total:.1f}%, {n} kernels)"
              for label, (us, n) in sorted(by_class.items(), key=lambda kv: -kv[1][0])),
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:args.top]:
        print(f"[train_profile kernel] {e.self_device_time_total / 1e3:8.1f} ms  x{e.count:<6d} "
              f"{_kernel_class(e.key):<22s} {e.key[:110]}", flush=True)


if __name__ == "__main__":
    main()
