"""Mesh helpers (counterpart of ``repro.parallel``).

``sharding``: ``axis_extent`` (the sharded SketchEngine's), ``tenant_mesh``
(the fleet's ``sharding="mesh"``) and the LM's placement rules
(``param_specs``, ``opt_state_specs``, ``batch_specs``, ``cache_specs``,
``shard_tree`` / ``gather_tree``).  ``collectives``: the explicit,
differentiable collectives the LM on a mesh is written with.
``pipeline``: GPipe over a "pipe" axis.
"""

from repro_torch.parallel.sharding import TenantMesh, axis_extent, tenant_mesh

__all__ = ["TenantMesh", "axis_extent", "tenant_mesh"]
