"""Quickstart: compressive K-means in ~20 lines (counterpart of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--n 50000] [--device cuda]
"""

from __future__ import annotations

import argparse

from repro_torch import device as dev_mod
from repro_torch.core import ckm, lloyd
from repro_torch.data import synthetic


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--n", type=int, default=50_000, help="points (default 50,000)")
    ap.add_argument("--device", default=dev_mod.DEFAULT,
                    help="where to run (default the CUDA card; 'cpu' for the plain kernels)")
    args = ap.parse_args(argv)
    dev = dev_mod.resolve(args.device)
    k_data, k_ckm, k_km = (dev_mod.derive_seed(0, i) for i in range(3))

    # 8 separated Gaussian clusters in R^6.
    x = synthetic.gaussian_mixture(k_data, args.n, k=8, n=6, c=4.0, device=dev)

    # Compressive K-means: sketch once (one pass, m = 10*K*n numbers), then
    # decode centroids from the sketch alone — the data could now be discarded.
    cfg = ckm.CKMConfig(k=8)
    result = ckm.fit(k_ckm, x, cfg, device=dev)
    print(f"sketch size m = {cfg.sketch_size(6)} (vs {x.numel()} dataset scalars)")
    print(f"CKM    SSE/N = {float(ckm.sse(x, result.centroids, device=dev)) / x.shape[0]:.4f}")

    # Baseline: Lloyd-Max with 5 replicates (needs the full dataset every pass).
    base = lloyd.kmeans(k_km, x, lloyd.LloydConfig(k=8, replicates=5, init="kpp"), device=dev)
    print(f"Lloyd5 SSE/N = {float(base.sse) / x.shape[0]:.4f}")
    print(f"mixture weights alpha: {[f'{float(w):.3f}' for w in result.weights]}")


if __name__ == "__main__":
    main()
