"""Serving (counterpart of ``repro.serve``): the fleet's request-facing
service, :class:`~repro_torch.serve.fleet_service.FleetService` — requests
in, centroids out on demand, cold tenants to disk and back bitwise, drifting
tenants re-decoded unattended — and ``kv_clustering``, the CKM-compressed KV
cache of the LM's long-context decode (a head's keys clustered into weighted
centroids by CKM or Lloyd-Max, decode attention over centroids plus a ring
of recent tokens)."""

from repro_torch.serve.fleet_service import (
    DecodeResult,
    FleetService,
    FleetServiceStats,
    shard_partition,
)
from repro_torch.serve.kv_clustering import (
    attention_decode_compressed,
    build_compressed_cache,
    compress_head,
    compress_kv,
)

__all__ = [
    "DecodeResult", "FleetServiceStats", "FleetService", "shard_partition",
    "attention_decode_compressed", "build_compressed_cache", "compress_head", "compress_kv",
]
