"""What the activation monitor's operator draw costs at a d_model and K.

    PYTHONPATH=src python3 -m repro_torch.tools.monitor_draw DIM K [DIM K ...]

For each pair, a fresh process builds ``ActivationMonitor(dim=DIM, k=K)``
on the card (m = 4 K DIM; the structured operator at DIM >= 512, drawn on a
CPU generator and moved, as ``freq_ops.seeded_operator`` does) and prints
m, the block count, the seconds and the process's peak host memory (its
maximum resident set).  ``_restricted_rescale`` sums its chain in chunks
past 512 MB, so the peak stays a few GB at any DIM.
"""

from __future__ import annotations

import argparse
import resource
import subprocess
import sys
import time


def draw(dim: int, k: int) -> None:
    import torch

    from repro_torch.train.monitor import ActivationMonitor

    t0 = time.perf_counter()
    mon = ActivationMonitor(dim=dim, k=k, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"[monitor draw d_model={dim} K={k}] m={mon.m_} nblocks={mon.freqs.nblocks} "
          f"d={mon.freqs.d}: {secs:.2f}s, host peak RSS {rss:.2f} GB", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("pairs", nargs="+", type=int, metavar="DIM K")
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if len(args.pairs) % 2:
        parser.error("give DIM K pairs")
    pairs = list(zip(args.pairs[::2], args.pairs[1::2]))
    if args.one:
        draw(*pairs[0])
        return
    for dim, k in pairs:
        subprocess.run([sys.executable, "-m", "repro_torch.tools.monitor_draw", "--one",
                        str(dim), str(k)], check=True)


if __name__ == "__main__":
    main()
