"""The clustered-KV regime of ``examples/serve_kv_ckm.py`` (planted centres
x4, key noise 0.1, values half the centres) at a chosen head_dim, run by
the reference (JAX on the CPU) or by the port (the CPU, or the card):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_kv_ckm_probe.py \\
        --impl ref|port [--device cpu|cuda] [--plain] --hd 256 --k 16 --s 512 --ring 32 \\
        --seeds 0,1,2

For each seed: the same keys, values, query and attention weights (numpy,
from the seed) go through the implementation's ``build_compressed_cache``
(``--method``, default both) and its compressed decode attention, against
its own full-cache decode; prints the relative error of the attention
output, how many planted centres are some centroid's nearest (each
centroid of positive weight mapped to its nearest centre: K of K when no
two clusters merged), and the seconds.  ``--plain`` runs the port's Lloyd
and assignments through kernel 2's plain version on the card (the same
draws), so a difference from the default run is the kernel's.
``tests/test_kv_clustering.py`` holds that error under 0.15 at the smoke
config's head_dim of 16, and ``tests/test_torch_kv_clustering.py`` holds
both packages to it at head_dim 256 through ``planted_case``,
``ref_error`` and ``port_error``.  The reference's CKM recipe
(``src/repro/serve/kv_clustering.py:79-87``) is the port's, so this shows
which head_dims and sizes it reaches the bar at, on either side.
``--impl port`` imports neither JAX nor the reference.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def planted_case(seed: int, s: int, k: int, hd: int, d: int, h: int):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, 1, hd)) * 4
    assign = rng.integers(0, k, s)
    keys = (centers[assign][None] + 0.1 * rng.standard_normal((1, s, 1, hd))).astype(np.float32)
    vals = (centers[assign][None] * 0.5).astype(np.float32)
    x = rng.standard_normal((1, 1, d)).astype(np.float32)
    mixer = {n: (rng.standard_normal(sh) / np.sqrt(sh[0])).astype(np.float32)
             for n, sh in (("wq", (d, h * hd)), ("wk", (d, hd)), ("wv", (d, hd)),
                           ("wo", (h * hd, d)))}
    return keys, vals, x, mixer, centers[:, 0]


def _recovered(ck, clogw, centers) -> int:
    """Planted centres that are some live centroid's nearest."""
    ck = np.asarray(ck, np.float32)[0, :, 0]
    live = np.asarray(clogw)[0, :, 0] > -1e29
    d2 = ((ck[live][:, None] - centers[None]) ** 2).sum(-1)
    return len(set(np.argmin(d2, 1).tolist()))


def ref_error(method, seed, keys, vals, x, mixer, centers, dims_kw, k, ring):
    import jax
    import jax.numpy as jnp

    from repro.models import layers as L
    from repro.serve import kv_clustering as kvc

    dims = L.AttnDims(**dims_kw)
    s = keys.shape[1]
    pad = ((0, 0), (0, 1), (0, 0), (0, 0))
    full, _, _ = L.attention_decode(mixer, dims, x, jnp.pad(keys, pad), jnp.pad(vals, pad),
                                    jnp.asarray(s))
    cache = kvc.build_compressed_cache(jax.random.PRNGKey(seed), keys, vals, k, ring, method)
    out, _ = kvc.attention_decode_compressed(mixer, dims, x, cache, jnp.asarray(s))
    return (float(jnp.linalg.norm(out - full) / jnp.linalg.norm(full)),
            _recovered(cache["ck"], cache["clogw"], centers))


def port_error(method, seed, keys, vals, x, mixer, centers, dims_kw, k, ring, device,
               plain=False):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import assign_argmin as aa
    from repro_torch.models import layers as L
    from repro_torch.serve import kv_clustering as kvc

    def t(a):
        return torch.from_numpy(a).to(device)

    dims = L.AttnDims(**dims_kw)
    s = keys.shape[1]
    mixer = {n: t(a) for n, a in mixer.items()}
    pad = (0, 0, 0, 0, 0, 1)
    full, _, _ = L.attention_decode(mixer, dims, t(x), F.pad(t(keys), pad), F.pad(t(vals), pad),
                                    s)
    kernel = aa.assign_argmin
    if plain:
        aa.assign_argmin = aa.assign_argmin_plain
    try:
        cache = kvc.build_compressed_cache(seed, t(keys), t(vals), k, ring, method)
    finally:
        aa.assign_argmin = kernel
    out, _ = kvc.attention_decode_compressed(mixer, dims, t(x), cache, s)
    return (float(torch.linalg.norm(out - full) / torch.linalg.norm(full)),
            _recovered(cache["ck"].cpu(), cache["clogw"].cpu(), centers))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--impl", choices=("ref", "port"), required=True)
    ap.add_argument("--device", default="cpu", help="the port's device (default cpu)")
    ap.add_argument("--plain", action="store_true",
                    help="the port: kernel 2's plain version in place of the kernel")
    ap.add_argument("--method", default="lloyd,ckm")
    ap.add_argument("--hd", type=int, default=256)
    ap.add_argument("--k", type=int, default=16, help="planted centres = centroids")
    ap.add_argument("--s", type=int, default=512, help="keys")
    ap.add_argument("--ring", type=int, default=32)
    ap.add_argument("--d", type=int, default=64, help="d_model of the random attention layer")
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--seeds", default="0,1,2")
    args = ap.parse_args(argv)
    if args.plain and args.impl == "ref":
        ap.error("--plain runs the port's plain kernel version: use it with --impl port")
    dims_kw = dict(d_model=args.d, n_heads=args.heads, n_kv_heads=1, head_dim=args.hd)
    for method in args.method.split(","):
        for seed in (int(v) for v in args.seeds.split(",")):
            data = planted_case(seed, args.s, args.k, args.hd, args.d, args.heads)
            t0 = time.perf_counter()
            if args.impl == "ref":
                rel, found = ref_error(method, seed, *data, dims_kw, args.k, args.ring)
            else:
                rel, found = port_error(method, seed, *data, dims_kw, args.k, args.ring,
                                        args.device, args.plain)
            tag = f"{args.impl}{' plain' if args.plain else ''}"
            print(f"{tag} {method} hd={args.hd} K={args.k} S={args.s} ring={args.ring} "
                  f"seed={seed}: rel err {rel:.4f}, centres recovered {found}/{args.k} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)


if __name__ == "__main__":
    main()
