"""How repeatable and how spread CKM's quality is on the card, at the
smoke run's configuration (N = 10^7, K = n = 10, m = 1000, default budgets).

    PYTHONPATH=src python3 -m repro_torch.tools.decode_spread   (one CUDA card)
        [--freq-op dense|structured] [--quantization none|1bit|<b>bit]
        [--decoder clompr|sketch_shift|amp]

The options pick the sketch path (``CKMConfig.freq_op`` and
``CKMConfig.sketch_quantization``; default the float dense path) and the
decoder (``CKMConfig.decoder``; default CLOMPR).  Prints
the k-means x5 SSE/N; whether two sketches of the same data, and two
decodes of the same sketch, are bitwise equal (also under
``torch.use_deterministic_algorithms``), and whether the decode with its
loops eager (``eager=True``) gives the graphed decode's bits; then the
relative SSE (CKM over k-means x5) of ``ckm.fit`` for seeds 1-8, and of
``ckm.fit`` with 3 replicates for seeds 1-3.
"""

import argparse
import dataclasses
import os
import time

import torch

from repro_torch import device as dm
from repro_torch.core import ckm, lloyd
from repro_torch.data import synthetic


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--freq-op", default="dense", choices=("dense", "structured"))
    parser.add_argument("--quantization", default="none")
    parser.add_argument("--decoder", default="clompr", choices=("clompr", "sketch_shift", "amp"))
    args = parser.parse_args()
    # Deterministic cuBLAS needs this before the first CUDA call.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    x = synthetic.gaussian_mixture(0, 10_000_000, 10, 10, device=dev)
    cfg = ckm.CKMConfig(
        k=10, m=1000, freq_op=args.freq_op, sketch_quantization=args.quantization,
        decoder=args.decoder,
    )
    print(f"path: freq_op={cfg.freq_op} sketch_quantization={cfg.sketch_quantization} "
          f"decoder={cfg.decoder}", flush=True)
    km = lloyd.kmeans(2, x, lloyd.LloydConfig(k=10, replicates=5), device=dev)
    ref = float(km.sse)
    print("kmeans sse/N", ref / 1e7, flush=True)
    z, op, s2, (lo, hi) = ckm.compute_sketch(dm.derive_seed(1, 0), x, cfg, device=dev)
    z2, _, _, _ = ckm.compute_sketch(dm.derive_seed(1, 0), x, cfg, device=dev)
    print("sketch bitwise repeat", torch.equal(z, z2), "sigma2", float(s2), flush=True)
    outs = []
    for i in range(2):
        t = time.perf_counter()
        c, a, cost = ckm.decode_sketch(dm.derive_seed(1, 1), z, op, lo, hi, cfg, device=dev)
        torch.cuda.synchronize()
        outs.append(c)
        print(
            f"decode {i}: {time.perf_counter() - t:.2f}s cost {float(cost):.6e} "
            f"rel {float(ckm.sse(x, c, device=dev)) / ref:.4f}",
            flush=True,
        )
    print(
        "decode bitwise repeat", torch.equal(outs[0], outs[1]),
        "max diff", float((outs[0] - outs[1]).abs().max()), flush=True,
    )
    t = time.perf_counter()
    c, _, _ = ckm.decode_sketch(dm.derive_seed(1, 1), z, op, lo, hi, cfg, device=dev, eager=True)
    torch.cuda.synchronize()
    print(
        f"eager decode: {time.perf_counter() - t:.2f}s bitwise equal to the graphed "
        f"{torch.equal(c, outs[0])} max diff {float((c - outs[0]).abs().max())}",
        flush=True,
    )
    torch.use_deterministic_algorithms(True)
    outs = []
    for i in range(2):
        c, a, cost = ckm.decode_sketch(dm.derive_seed(1, 1), z, op, lo, hi, cfg, device=dev)
        outs.append(c)
        print(
            f"det decode {i}: cost {float(cost):.6e} "
            f"rel {float(ckm.sse(x, c, device=dev)) / ref:.4f}",
            flush=True,
        )
    print("det decode bitwise repeat", torch.equal(outs[0], outs[1]), flush=True)
    torch.use_deterministic_algorithms(False)
    for seed in range(1, 9):
        r = ckm.fit(seed, x, cfg, device=dev)
        print(
            f"fit seed {seed}: rel {float(ckm.sse(x, r.centroids, device=dev)) / ref:.4f} "
            f"cost {float(r.cost):.6e}",
            flush=True,
        )
    for seed in range(1, 4):
        r = ckm.fit(seed, x, dataclasses.replace(cfg, replicates=3), device=dev)
        print(
            f"fit x3 seed {seed}: rel {float(ckm.sse(x, r.centroids, device=dev)) / ref:.4f}",
            flush=True,
        )


if __name__ == "__main__":
    main()
