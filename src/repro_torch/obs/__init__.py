"""``repro_torch.obs`` — telemetry and sketch-health diagnostics for the CKM
stack (counterpart of ``repro.obs``).

- :mod:`repro_torch.obs.runtime` — the master switch.  Everything below is
  inert until :func:`enable` flips the module-level ``runtime.ENABLED``
  bool; the disabled hot path costs one attribute read and a branch.
- :mod:`repro_torch.obs.metrics` / :mod:`repro_torch.obs.trace` — a
  get-or-create instrument registry (counters / gauges / histograms) and a
  span tracer with JSONL export and ``torch.profiler.record_function``
  pass-through.  The instrumented call sites live in ``core/engine.py``
  (update/merge/finalize), ``core/ingest.py`` (overlap accounting) and
  ``core/ckm.py::decode_sketch`` (the decoders' convergence series) and
  ``serve/fleet_service.py`` (flushes, the decode cache, drift).
- :mod:`repro_torch.obs.diagnose` — ``ckm.diagnose(result)``: attribute a
  bad fit to sketch size m, frequency scale sigma, or the decoder; plus the
  O(m) :func:`sketch_drift` score ``FleetService.drift`` emits as a gauge.
"""

from __future__ import annotations

from repro_torch.obs import metrics, runtime, trace
from repro_torch.obs.diagnose import (
    Diagnosis,
    diagnose,
    matched_distance,
    model_sketch,
    sigma_sweep,
    sketch_drift,
)
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
    # diagnostics
    "Diagnosis",
    "diagnose",
    "sketch_drift",
    "model_sketch",
    "matched_distance",
    "sigma_sweep",
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
