"""How repeatable and how spread CKM's quality is on the card, at the
smoke run's configuration (N = 10^7, K = n = 10, m = 1000, default budgets).

    PYTHONPATH=src python3 -m repro_torch.tools.decode_spread   (one CUDA card)

Prints the k-means x5 SSE/N; whether two sketches of the same data, and two
decodes of the same sketch, are bitwise equal (also under
``torch.use_deterministic_algorithms``); then the relative SSE (CKM over
k-means x5) of ``ckm.fit`` for seeds 1-8, and of ``ckm.fit`` with 3
replicates for seeds 1-3.
"""

import os
import time

import torch

from repro_torch import device as dm
from repro_torch.core import ckm, lloyd
from repro_torch.data import synthetic


def main() -> None:
    # Deterministic cuBLAS needs this before the first CUDA call.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    x = synthetic.gaussian_mixture(0, 10_000_000, 10, 10, device=dev)
    cfg = ckm.CKMConfig(k=10, m=1000)
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
        r = ckm.fit(seed, x, ckm.CKMConfig(k=10, m=1000, replicates=3), device=dev)
        print(
            f"fit x3 seed {seed}: rel {float(ckm.sse(x, r.centroids, device=dev)) / ref:.4f}",
            flush=True,
        )


if __name__ == "__main__":
    main()
