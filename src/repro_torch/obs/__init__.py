"""``repro_torch.obs`` — telemetry for the CKM stack (counterpart of
``repro.obs``, less its diagnostics).

- :mod:`repro_torch.obs.runtime` — the master switch.  Everything below is
  inert until :func:`enable` flips the module-level ``runtime.ENABLED``
  bool; the disabled hot path costs one attribute read and a branch.
- :mod:`repro_torch.obs.metrics` / :mod:`repro_torch.obs.trace` — a
  get-or-create instrument registry (counters / gauges / histograms) and a
  span tracer with JSONL export and ``torch.profiler.record_function``
  pass-through.  The instrumented call sites live in ``core/engine.py``
  (update/merge/finalize), ``core/ingest.py`` (overlap accounting) and
  ``core/ckm.py::decode_sketch`` (the decoders' convergence series).
"""

from __future__ import annotations

from repro_torch.obs import metrics, runtime, trace
from repro_torch.obs.metrics import (
    REGISTRY,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
    snapshot,
)
from repro_torch.obs.runtime import disable, enable, enabled, enabled_scope
from repro_torch.obs.trace import TRACER, Tracer, export_jsonl, point, series, span

__all__ = [
    # switch
    "enable",
    "disable",
    "enabled",
    "enabled_scope",
    # metrics
    "MetricsRegistry",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    # tracing
    "Tracer",
    "TRACER",
    "span",
    "series",
    "point",
    "export_jsonl",
    # submodules
    "metrics",
    "runtime",
    "trace",
    "reset",
]


def reset() -> None:
    """Reset the default metrics registry *and* the default tracer.

    One call returns the process to a clean-slate telemetry state (the
    switch position is left alone) — tests and benchmark trials use this
    between runs.
    """
    metrics.reset()
    trace.TRACER.reset()
