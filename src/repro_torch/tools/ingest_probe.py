"""Where a host-fed stream's time goes on one card.

    PYTHONPATH=src python3 -m repro_torch.tools.ingest_probe [--rows 1000000,100000] [--device]

For each batch size, on N = 10^7 points of n = 10 float32 made on the host:

- the cost of pinning a ``prefetch + 2`` ring of batch buffers, three times
  (the first pins; later ones come from torch's pinned-memory cache);
- one batch's copies: host to pinned (``Tensor.copy_``), pinned to device
  (``non_blocking``), pageable to device (``torch.as_tensor(...).to``);
- the fold of batches 2..B into a state, in turns: sync (update, wait),
  async with the producer's copy by ``Tensor.copy_`` (as ``core.ingest``
  does), async with a single-threaded ``numpy.copyto`` in its place, then
  the same three in reverse, each with its ``IngestStats``, and whether
  each gave the sync fold's bits.

With ``--device``, the batches are made on the card instead (10 batches of
10^6 rows) and only the fold runs, in turns: sync, async (a batch already
on the card passes the stager straight through), async with every batch
sent through a pinned slot and back (``_RoundTripStager``, what the stager
did to device batches before it passed them through), then the same three
in reverse.

It prints the card's name and power limit first, and raises without a card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from repro_torch.core import ckm, ingest
from repro_torch.data import synthetic
from repro_torch.kernels import _build

N, DIM, K, M, PREFETCH = 10_000_000, 10, 10, 1000, 2


class _NumpyCopyStager(ingest._PinnedStager):
    """``core.ingest``'s stager with its host copy done by a single-threaded
    ``numpy.copyto`` in place of ``Tensor.copy_``."""

    def __call__(self, batch):
        host = np.asarray(batch)
        slot = self.next
        self.next = (slot + 1) % len(self.buffers)
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        buf = self.buffers[slot]
        if buf is None or buf.numel() < host.size:
            buf = self.buffers[slot] = torch.empty(
                (host.size,), dtype=torch.float32, pin_memory=True)
        staged = buf[: host.size].view(host.shape)
        np.copyto(staged.numpy(), host, casting="same_kind")
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            x = torch.empty(staged.shape, dtype=torch.float32, device=self.device)
            x.copy_(staged, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[slot] = event
        return x, event


class _RoundTripStager(ingest._PinnedStager):
    """``core.ingest``'s stager with every batch, one already on the card
    too, copied into a pinned slot and back to the card."""

    __call__ = ingest._PinnedStager._pinned


def _fold(eng, batches, state0, stager=None):
    """``(state, stats)`` of the fold of ``batches`` into ``state0``: sync
    (update, wait) when ``stager`` is None, else ``ingest_stream`` with
    ``stager`` as its placement on the card."""
    if stager is None:
        state = state0
        for b in batches:
            state = eng.update(state, b)
            torch.cuda.synchronize()
        return state, None
    saved = ingest._PinnedStager
    ingest._PinnedStager = stager
    try:
        return ingest.ingest_stream(eng, iter(batches), state=state0, prefetch=PREFETCH)
    finally:
        ingest._PinnedStager = saved


def _stats_line(stats) -> str:
    if stats is None:
        return ""
    return (f"; produce {1e3 * stats.produce_s:.1f} ms, compute {1e3 * stats.compute_s:.1f}, "
            f"consumer wait {1e3 * stats.consumer_wait_s:.1f}, producer wait "
            f"{1e3 * stats.producer_wait_s:.1f}, overlap_efficiency "
            f"{stats.overlap_efficiency:.3f}")


def device_folds(dev, cfg) -> None:
    """The fold of batches already on the card: sync, async passing them
    through, async through the pinned round trip, in turns."""
    x = synthetic.gaussian_mixture(3, N, K, DIM, device=dev)
    batches = list(torch.split(x, N // 10))
    z, op, _, _, first = ckm.compute_sketch_streaming(5, iter(batches), cfg, device=dev)
    eng = ckm.make_engine(op, cfg, dev)
    state0 = eng.update(eng.init_state(), first)
    stagers = {"sync": None, "async": ingest._PinnedStager, "round trip": _RoundTripStager}
    _fold(eng, batches[1:], state0, _RoundTripStager)
    for name in ("sync", "async", "round trip", "round trip", "async", "sync"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, stats = _fold(eng, batches[1:], state0, stagers[name])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"[fold-device] B={N // 10} {name}: {1e3 * wall:.2f} ms for {len(batches) - 1} "
              f"batches, the sync bits: {torch.equal(eng.finalize(state)[0], z)}"
              + _stats_line(stats), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", default="1000000,100000")
    parser.add_argument("--device", action="store_true",
                        help="fold batches made on the card instead of the host")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ingest_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    _build.build()
    dev = torch.device("cuda", torch.cuda.current_device())
    if args.device:
        device_folds(dev, ckm.CKMConfig(k=K, m=M))
        return
    xh = synthetic.gaussian_mixture(3, N, K, DIM, device="cpu").numpy()
    cfg = ckm.CKMConfig(k=K, m=M)
    for rows in (int(r) for r in args.rows.split(",")):
        batches = [xh[i:i + rows] for i in range(0, N, rows)]
        for k in range(3):
            t0 = time.perf_counter()
            ring = [torch.empty((rows * DIM,), pin_memory=True) for _ in range(PREFETCH + 2)]
            print(f"[pin] B={rows}: a ring of {len(ring)} in {1e3 * (time.perf_counter() - t0):.2f} "
                  f"ms (try {k})", flush=True)
            del ring
        src = torch.from_numpy(batches[1])
        pinned = torch.empty(src.shape, pin_memory=True)
        dst = torch.empty(src.shape, device=dev)
        for k in range(3):
            t0 = time.perf_counter()
            pinned.copy_(src)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            dst.copy_(pinned, non_blocking=True)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            torch.as_tensor(batches[1]).to(dev)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            mb = src.numel() * 4 / 1e6
            print(f"[copy] B={rows} ({mb:.0f} MB): host to pinned {1e3 * (t1 - t0):.3f} ms, pinned "
                  f"to device {1e3 * (t3 - t2):.3f} ms, pageable to device {1e3 * (t4 - t3):.3f} ms "
                  f"(try {k})", flush=True)
        z, op, _, _, first = ckm.compute_sketch_streaming(5, iter(batches), cfg, device=dev)
        eng = ckm.make_engine(op, cfg, dev)
        state0 = eng.update(eng.init_state(), first)
        ingest.ingest_stream(eng, iter(batches[1:]), state=state0, prefetch=PREFETCH)
        stagers = {"sync": None, "copy_": ingest._PinnedStager, "numpy": _NumpyCopyStager}
        for name in ("sync", "copy_", "numpy", "numpy", "copy_", "sync"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, stats = _fold(eng, batches[1:], state0, stagers[name])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(f"[fold] B={rows} {name}: {1e3 * wall:.2f} ms for {len(batches) - 1} batches, "
                  f"the sync bits: {torch.equal(eng.finalize(state)[0], z)}"
                  + _stats_line(stats), flush=True)


if __name__ == "__main__":
    main()
