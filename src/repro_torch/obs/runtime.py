"""The telemetry master switch — one module-level bool, read on every hot
path (counterpart of ``repro.obs.runtime``).

Every instrumented call site guards with ``if runtime.ENABLED:`` *before*
touching any telemetry object, so the disabled path costs one module
attribute read and a branch.  Instrumentation happens at the Python dispatch
layer, never inside a captured CUDA graph: the decoders' convergence traces
are device buffers that the graphed loops write into, read on the host once
the decode is done.

Call sites must read the flag as an attribute (``runtime.ENABLED``), never
``from ... import ENABLED`` — a from-import snapshots the value at import
time and would never see :func:`enable`.
"""

from __future__ import annotations

import contextlib

__all__ = ["ENABLED", "enable", "disable", "enabled", "enabled_scope"]

ENABLED: bool = False


def enable() -> None:
    """Turn telemetry on process-wide (metrics + tracer + profiler ranges)."""
    global ENABLED
    ENABLED = True


def disable() -> None:
    """Turn telemetry off; instrumented paths fall back to the bare hot path."""
    global ENABLED
    ENABLED = False


def enabled() -> bool:
    """The current switch state (prefer attribute reads on hot paths)."""
    return ENABLED


@contextlib.contextmanager
def enabled_scope(on: bool = True):
    """Scoped enable/disable — restores the previous state on exit."""
    global ENABLED
    prev = ENABLED
    ENABLED = on
    try:
        yield
    finally:
        ENABLED = prev
