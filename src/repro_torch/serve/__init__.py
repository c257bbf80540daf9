"""Serving (counterpart of ``repro.serve``): the fleet's request-facing
service, :class:`~repro_torch.serve.fleet_service.FleetService` — requests
in, centroids out on demand, cold tenants to disk and back bitwise, drifting
tenants re-decoded unattended.  The reference's ``kv_clustering`` belongs to
the LM substrate (ROADMAP Queue 1 item 22)."""

from repro_torch.serve.fleet_service import (
    DecodeResult,
    FleetService,
    FleetServiceStats,
    shard_partition,
)

__all__ = ["DecodeResult", "FleetServiceStats", "FleetService", "shard_partition"]
