"""Mesh helpers (counterpart of ``repro.parallel``).

``sharding.axis_extent`` (the sharded SketchEngine's) and
``sharding.tenant_mesh`` (the fleet's ``sharding="mesh"``) are ported; the
parameter and cache sharding rules and ``parallel/pipeline.py`` belong to
the LM on a mesh (ROADMAP Queue 1 item 22 (b), part 2).
"""

from repro_torch.parallel.sharding import TenantMesh, axis_extent, tenant_mesh

__all__ = ["TenantMesh", "axis_extent", "tenant_mesh"]
