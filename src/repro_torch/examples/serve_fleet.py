"""Multi-tenant sketch serving: one stacked fleet, decode-on-demand
(counterpart of ``examples/serve_fleet.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_fleet
    PYTHONPATH=src python -m repro_torch.examples.serve_fleet --shards 4 [--devices N]

Runs a small fleet end-to-end: per-tenant operators from their specs, a
burst of interleaved ``(tenant, batch)`` requests folded through the routed
ingest, decode-on-demand with the (tenant, version) LRU, and evict/restore
of a cold tenant — then prints the service stats and the bitwise check of
the restored row.

Sharding flags:

``--shards P`` splits the tenant axis into P contiguous blocks of
``tenants / P`` rows (``FleetEngine(sharding="mesh")``, built from
``SketchJobSpec(...).fleet_kwargs()``); the flush then shard-routes the
interleaved requests host-side and the run prints the placement and the
per-shard request counts and throughput.  ``--devices N`` spreads the P
blocks over the first N devices of ``--device``'s type in contiguous runs
(``--devices 1`` puts every block on one card); ``--devices 0``, the
default, gives every block its own card and raises when there are fewer
than P.  On the CPU there is one device.  Blocks sharing a device show
placement and routing, not concurrency.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.core import CKMConfig, FleetEngine, fleet_specs
from repro_torch.data import synthetic
from repro_torch.launch.specs import SketchJobSpec
from repro_torch.parallel.sharding import tenant_mesh
from repro_torch.serve.fleet_service import FleetService

K, FEAT = 3, 4
M = 10 * K * FEAT
ROWS = 256  # points a request


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--tenants", type=int, default=64,
                   help="fleet size T (default 64); must be divisible by --shards")
    p.add_argument("--shards", type=int, default=1,
                   help="tenant shards P: contiguous T/P-row blocks")
    p.add_argument("--devices", type=int, default=0,
                   help="spread the P blocks over the first N devices of --device's type "
                        "(0 = one card a block; the CPU is one device)")
    p.add_argument("--requests", type=int, default=200,
                   help="interleaved (tenant, batch) requests to serve (default 200)")
    p.add_argument("--device", default=dev_mod.DEFAULT,
                   help="device type to run on (default the CUDA card; 'cpu' for the "
                        "plain kernels)")
    return p.parse_args(argv)


def placement(shards: int, devices: int, device) -> list[torch.device]:
    """The device of each of ``shards`` blocks: ``devices`` = N > 0 spreads
    them over the first N devices of ``device``'s type in contiguous runs;
    0 gives each block its own card (``tenant_mesh``'s refusal when short)."""
    dev = dev_mod.resolve(device)
    if devices < 0 or devices > shards:
        raise ValueError(f"--devices must lie in [0, --shards={shards}], got {devices}")
    if dev.type == "cpu":
        if devices > 1:
            raise ValueError(f"--devices {devices}: the CPU is one device")
        return [dev] * shards
    if devices == 0:
        return list(tenant_mesh(shards).devices)
    if devices > torch.cuda.device_count():
        raise ValueError(
            f"--devices {devices}: only {torch.cuda.device_count()} CUDA cards visible")
    return [torch.device("cuda", s * devices // shards) for s in range(shards)]


def main(argv=None) -> None:
    args = _parse(argv)
    dev = dev_mod.resolve(args.device)
    job = SketchJobSpec(n_tenants=args.tenants, tenant_shards=args.shards).validate()
    # Each tenant is an independent clustering problem: its own frequency
    # operator (rebuilt from its spec) over its own data distribution.
    specs = fleet_specs(0, job.n_tenants, "dense", M, FEAT, 1.0)
    kwargs = job.fleet_kwargs()
    if job.tenant_shards > 1:
        devs = placement(job.tenant_shards, args.devices, dev)
        kwargs["mesh"] = tenant_mesh(job.tenant_shards, job.tenant_shard_axis, devs)
        print("placement: " + ", ".join(f"shard {s} -> {d}" for s, d in enumerate(devs)))
    else:
        kwargs["device"] = dev
    engine = FleetEngine(specs, **kwargs)
    print(f"{engine} holding {engine.state_bytes() / 1024:.0f} KiB of state "
          f"on {len(set(engine.devices))} device(s)")

    decode_cfg = CKMConfig(k=K)  # decoder defaults to sketch_shift in-service
    with tempfile.TemporaryDirectory() as ckpt_dir:
        svc = FleetService(
            engine, decode_cfg, checkpoint_dir=ckpt_dir,
            **{**job.service_kwargs(), "decode_cache_entries": 16},
        )

        # A burst of interleaved requests: random tenants, each batch drawn
        # on the host from that tenant's own mixture.
        rng = np.random.default_rng(7)
        shard_requests = np.zeros(engine.tenant_shards, np.int64)
        t_serve = time.perf_counter()
        points = 0
        for step in range(args.requests):
            t = int(rng.integers(job.n_tenants))
            x = synthetic.gaussian_mixture(dev_mod.derive_seed(t, step), ROWS, k=K, n=FEAT,
                                           c=6.0, device="cpu").numpy()
            svc.submit(t, x)
            shard_requests[engine.owner_shard(t)] += 1
            points += x.shape[0]
            if step % 8 == 7:  # flush every few requests, async staging
                svc.flush(async_ingest=True)
        svc.flush()
        for d in set(engine.devices):
            dev_mod.sync(d)
        serve_s = time.perf_counter() - t_serve
        print(f"served {args.requests} requests ({points} points) in "
              f"{serve_s:.3f}s -> {points / serve_s:,.0f} points/s")
        if engine.tenant_shards > 1:
            for s in range(engine.tenant_shards):
                lo = s * engine.shard_rows
                print(f"  shard {s}: tenants [{lo}, {lo + engine.shard_rows}) on "
                      f"{engine.devices[s]} | {int(shard_requests[s])} requests | "
                      f"{shard_requests[s] * ROWS / serve_s:,.0f} points/s")

        # Decode-on-demand: only the tenants somebody asks about pay decode.
        for t in [0, 1, 2, 0, 1, 0]:
            res = svc.decode(t)
            tag = "cache hit " if res.cached else "fresh decode"
            print(f"tenant {t}: {tag} v{res.version} cost={float(res.cost):.4f}")

        # Evict a cold tenant (state row + spec -> checkpoint, row reset);
        # the next touch restores it transparently and bitwise.
        cold = 3
        before = engine.tenant_state(svc.state, cold)
        svc.evict(cold)
        restored = svc.decode(cold)  # auto-restore, then decode
        after = engine.tenant_state(svc.state, cold)
        bitwise = all(torch.equal(a, b) for a, b in zip(before, after))
        print(f"tenant {cold}: evicted -> restored bitwise={bitwise}, "
              f"decode cost={float(restored.cost):.4f}")

        s = svc.stats
        print(f"requests={s.requests} points={s.points} "
              f"flushes={s.flushes} decodes={s.decodes} "
              f"hit_rate={s.hit_rate:.2f} "
              f"evictions={s.evictions} restores={s.restores}")


if __name__ == "__main__":
    main()
