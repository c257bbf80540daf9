"""Train a small LM end to end with the full substrate (counterpart of
``examples/train_lm.py``): the train step, checkpoints and restart, the CKM
activation monitor and compressive data balancing.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch llama3.2-1b --steps 200 [--device cpu]

Uses the reduced (smoke) config by default; pass --full-config for the
published one.  Kill it mid-run and run it again: it resumes from the
latest checkpoint and gives the uninterrupted loss curve (data =
f(seed, step)).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import device as dev_mod
from repro_torch.configs.base import ShapeConfig, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.train_loop import LoopConfig, run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default=dev_mod.DEFAULT,
                    help="where to run (default the CUDA card; 'cpu' for a CPU run)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full_config else get_smoke_config(args.arch)
    shape = ShapeConfig("example", args.seq, args.batch, "train")
    loop = LoopConfig(
        steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=50,
        monitor_k=4,  # CKM activation monitor: 4 clusters of pooled hiddens
        balance_every=50,  # compressive mixture re-balancing
        log_every=10,
        dtype=torch.float32,
    )
    out = run(cfg, shape, None, loop, DataConfig(seed=0, n_domains=4), device=args.device)
    mres = out["monitor_result"]
    print("\nactivation-space clusters (CKM from the streaming sketch):")
    print("  mixture weights:", [f"{float(w):.3f}" for w in mres.weights])
    print("  final loss:", out["history"][-1]["loss"])
    return out


if __name__ == "__main__":
    main()
