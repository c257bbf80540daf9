"""Mesh helpers (counterpart of ``repro.parallel``).

Only ``sharding.axis_extent`` is ported: the sharded SketchEngine needs it.
``sharding.tenant_mesh`` waits for the fleet's ``sharding="mesh"`` (ROADMAP
Queue 1 item 16(c)); the parameter and cache sharding rules and
``parallel/pipeline.py`` belong to the LM substrate (item 22).
"""
