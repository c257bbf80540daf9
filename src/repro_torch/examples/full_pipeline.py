"""End-to-end example (the paper's kind of workload): cluster a large dataset
through the full pipeline (counterpart of ``examples/full_pipeline.py``).

    PYTHONPATH=src python -m repro_torch.examples.full_pipeline [--n 1000000]
        [--backend sharded|kernel] [--decoder clompr|sketch_shift|amp]
        [--topology allreduce|tree|ring] [--ingest sync|async]
        [--freq-op dense|structured] [--device cuda|cpu]
    PYTHONPATH=src torchrun --nproc-per-node P -m repro_torch.examples.full_pipeline

Stages (all from the library, nothing bespoke):
1. with ``--backend sharded``, a ("data",) mesh over the process group:
   under ``torchrun`` one rank a card, each sketching its block of the rows;
   launched alone, a one-rank group (NCCL on the card, gloo on the CPU) that
   this script makes and destroys (the reference's (4 data x 2 model)
   placeholder mesh of forced host devices has no counterpart);
2. the dataset is sketched in ONE pass through the unified SketchEngine —
   backend is a flag: "sharded" (each rank's kernel sums, then one O(m)
   reduction over the data axis) or "kernel" (the fused kernel on one
   device);
3. a registered decoder ("clompr", "sketch_shift" or "amp", the --decoder
   flag) decodes K centroids from the sketch alone;
4. a second, *streaming* CKM fit consumes the same data as a chunked
   iterator (fit_streaming) — out-of-core one-pass path;
5. Lloyd-Max x5 runs on the whole data as the reference;
6. wall-clock + quality comparison (paper Fig. 4 protocol).
Under ``torchrun`` every rank runs every stage and rank 0 prints.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import device as dev_mod
from repro_torch.core import (
    BACKENDS,
    CKMConfig,
    available_decoders,
    available_freq_ops,
    available_topologies,
    decode_sketch,
    fit_streaming,
    sse,
)
from repro_torch.core import ckm, freq_ops, frequencies, lloyd
from repro_torch.core import quantize as qz
from repro_torch.data import pipeline as pipe
from repro_torch.data import synthetic
from repro_torch.launch.specs import SketchJobSpec


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--backend", choices=BACKENDS, default="sharded")
    ap.add_argument("--decoder", choices=available_decoders(), default="clompr",
                    help="sketch decoder (core.decoders registry): clompr = paper "
                         "Algorithm 1; sketch_shift = mean shift on the sketched "
                         "characteristic function; amp = CL-AMP joint message passing "
                         "(accurate at small m)")
    ap.add_argument("--stream-chunk", type=int, default=0,
                    help="also run the one-pass streaming fit at this chunk size (0 = skip)")
    ap.add_argument("--quantize", default="none",
                    help="universal sketch quantization (QCKM): none | 1bit | <b>bit — "
                         "integer accumulators, cheaper merges")
    ap.add_argument("--topology", choices=available_topologies(), default="allreduce",
                    help="cross-device merge schedule of the sharded backend "
                         "(core.topology registry); same sketch either way, different "
                         "wire cost")
    ap.add_argument("--ingest", choices=("sync", "async"), default="sync",
                    help="streaming-fit ingest mode: async overlaps batch production "
                         "with sketch compute (core.ingest)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="async ingest queue depth (2 = double buffering)")
    ap.add_argument("--freq-op", choices=available_freq_ops(), default="dense",
                    help="frequency operator (core.freq_ops registry): dense = the "
                         "paper's materialized matrix; structured = stacked "
                         "fast-transform blocks (O(1) spec on the wire)")
    ap.add_argument("--device", default=dev_mod.DEFAULT,
                    help="where to run (default the CUDA card; 'cpu' for the plain kernels)")
    return ap.parse_args(argv)


def _data_mesh(dev: torch.device, say):
    """``(mesh, device, close)``: a ("data",) mesh over the process group —
    torchrun's (``env://``, this rank's card), else a one-rank group made
    here (NCCL on the card, gloo on the CPU) over a file store that lives
    until ``close`` destroys the group (NCCL reads the store at its first
    collective, not at init)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    made = not dist.is_initialized()
    store = None
    if made:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            if dev.type == "cuda":
                dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
                torch.cuda.set_device(dev)
            dist.init_process_group(backend)
        else:
            store = tempfile.TemporaryDirectory()
            dist.init_process_group(backend, init_method=f"file://{store.name}/init",
                                    rank=0, world_size=1)
            say(f"[0] launched alone: made a one-rank {backend} process group over a "
                "('data',) mesh")
    world = dist.get_world_size()
    mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("data",))
    say(f"[0] mesh: ('data',) of {world} rank(s), {dist.get_backend()} on {dev.type}")

    def close():
        if made:
            dist.destroy_process_group()
        if store is not None:
            store.cleanup()

    return mesh, dev, close


def main(argv=None) -> None:
    args = _parse(argv)
    job = SketchJobSpec(
        backend=args.backend, reduce_topology=args.topology,
        ingest=args.ingest, ingest_prefetch=args.prefetch,
        sketch_quantization=args.quantize, freq_op=args.freq_op,
        decoder=args.decoder,
    ).validate()
    dev = dev_mod.resolve(args.device)
    rank0 = int(os.environ.get("RANK", 0)) == 0

    def say(line):
        if rank0:
            print(line, flush=True)

    mesh, close = None, None
    if args.backend == "sharded":
        mesh, dev, close = _data_mesh(dev, say)
    try:
        _run(args, job, dev, mesh, say)
    finally:
        if close is not None:
            close()


def _run(args, job, dev, mesh, say) -> None:
    kd, kf, kdec, kl = (dev_mod.derive_seed(0, i) for i in range(4))
    x = synthetic.gaussian_mixture(kd, args.n, args.k, args.dim, device=dev)

    cfg = CKMConfig(k=args.k, **job.ckm_overrides())
    m = cfg.sketch_size(args.dim)
    sigma2 = frequencies.estimate_sigma2(dev_mod.generator(kf, dev), x[:2048], device=dev)
    freqs = freq_ops.seeded_operator(args.freq_op, kf, m, args.dim, float(sigma2), device=dev)

    quantizer = ckm.make_quantizer(kf, cfg, m, dev)
    engine = ckm.make_engine(freqs, cfg, dev, quantizer, mesh)
    xin = engine.shard_points(x) if args.backend == "sharded" else x

    dev_mod.sync(dev)
    t0 = time.perf_counter()
    z, lo, hi = engine.sketch(xin)
    dev_mod.sync(dev)
    t_sketch = time.perf_counter() - t0
    bits = qz.parse_bits(args.quantize)
    wire = qz.state_wire_bytes(m, args.n, bits)
    say(
        f"[1] sketch ({job.describe()}): {t_sketch:.2f}s  (m={m}, one pass, "
        f"merge wire bytes/state={wire}, operator leaves="
        f"{freqs.state_bytes()}B vs spec={freq_ops.spec_wire_bytes(freqs.spec())}B)"
    )

    t0 = time.perf_counter()
    cents, alphas, cost = decode_sketch(kdec, z, freqs, lo, hi, cfg, device=dev)
    dev_mod.sync(dev)
    t_decode = time.perf_counter() - t0
    sse_ckm = float(sse(x, cents, device=dev)) / args.n
    say(f"[2] {args.decoder} decode (sketch only): {t_decode:.2f}s  SSE/N={sse_ckm:.4f}")

    if args.stream_chunk > 0:
        t0 = time.perf_counter()
        res = fit_streaming(0, pipe.chunked(xin, args.stream_chunk), cfg, dev, mesh)
        dev_mod.sync(dev)
        t_stream = time.perf_counter() - t0
        say(
            f"[2b] streaming fit ({args.stream_chunk}-pt chunks): "
            f"{t_stream:.2f}s  SSE/N={float(sse(x, res.centroids, device=dev)) / args.n:.4f}"
        )

    t0 = time.perf_counter()
    base = lloyd.kmeans(kl, x, lloyd.LloydConfig(k=args.k, replicates=5, init="range"),
                        device=dev)
    dev_mod.sync(dev)
    t_km = time.perf_counter() - t0
    say(f"[3] Lloyd-Max x5 (full data): {t_km:.2f}s  SSE/N={float(base.sse) / args.n:.4f}")
    say(
        f"[4] relative SSE {sse_ckm * args.n / float(base.sse):.3f}; "
        f"decode speedup vs kmeans x5: {t_km / t_decode:.1f}x; "
        f"memory {args.n * args.dim * 4 / (2 * m + args.dim * m) / 4:.0f}x smaller working set"
    )


if __name__ == "__main__":
    main()
