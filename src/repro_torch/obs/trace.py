"""Span tracer with JSONL export and ``torch.profiler`` pass-through
(counterpart of ``repro.obs.trace``).

Three event kinds, all host-side Python (never inside a captured graph):

- **spans** — ``with trace.span("engine.update", backend="kernel"):`` records
  a ``(name, t0, duration, depth, attrs)`` event around a region of dispatch
  code, and enters a ``torch.profiler.record_function`` of the same name so
  the region shows up in a ``torch.profiler`` trace when one is active;
- **series** — a named list of floats, e.g. a decoder's per-round residual
  norms.  The values are written into a device buffer by the decoder's loop
  (the graphed loops included) and handed to the tracer after the decode;
- **points** — one-off ``(name, value, attrs)`` observations.

Like the metrics registry, the tracer is only touched behind a
``runtime.ENABLED`` guard; ``span()`` double-checks so un-guarded callers
stay correct, just not free.  Export is JSON Lines: one self-describing
object per event (``kind``/``name``/``attrs`` plus kind-specific fields),
parseable with nothing but ``json.loads`` per line.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

from repro_torch.obs import runtime

__all__ = ["Tracer", "TRACER", "span", "series", "point", "export_jsonl"]


class Tracer:
    """Append-only event log; one process-wide instance at ``trace.TRACER``."""

    def __init__(self):
        self.events: list[dict] = []
        self._depth = 0

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Record a host wall-clock span around a block of dispatch code.

        CUDA launches are asynchronous, so a span around an unsynchronised
        call measures the launch, not the device's work; paths that wait on
        the device per batch (``fit_streaming``, ``ingest_stream``) give true
        durations.  A span never synchronises by itself.
        """
        if not runtime.ENABLED:
            yield
            return
        import torch

        depth = self._depth
        self._depth += 1
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self._depth = depth
            self.events.append(
                {
                    "kind": "span",
                    "name": name,
                    "t0": t0,
                    "dur_s": time.perf_counter() - t0,
                    "depth": depth,
                    "attrs": attrs,
                }
            )

    def series(self, name: str, values, **attrs) -> None:
        """Record a convergence/trajectory series (list of floats)."""
        if not runtime.ENABLED:
            return
        self.events.append(
            {
                "kind": "series",
                "name": name,
                "values": [float(v) for v in values],
                "attrs": attrs,
            }
        )

    def point(self, name: str, value: float, **attrs) -> None:
        """Record a single observation."""
        if not runtime.ENABLED:
            return
        self.events.append(
            {
                "kind": "point",
                "name": name,
                "value": float(value),
                "attrs": attrs,
            }
        )

    def spans(self, name: str | None = None) -> list[dict]:
        """Completed span events, optionally filtered by name."""
        return [
            e
            for e in self.events
            if e["kind"] == "span" and (name is None or e["name"] == name)
        ]

    def jsonl_lines(self, metrics_snapshot: dict | None = None) -> list[str]:
        """Every event (plus an optional metrics snapshot) as JSONL lines."""
        lines = [json.dumps(e) for e in self.events]
        if metrics_snapshot is not None:
            for key, value in sorted(metrics_snapshot.items()):
                lines.append(
                    json.dumps({"kind": "metric", "name": key, "value": value})
                )
        return lines

    def export_jsonl(
        self, path, *, metrics_snapshot: dict | None = None
    ) -> Path:
        """Write the event log (and optional metrics) to a ``.jsonl`` file."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(
            "\n".join(self.jsonl_lines(metrics_snapshot)) + "\n"
        )
        return path

    def reset(self) -> None:
        self.events.clear()
        self._depth = 0


TRACER = Tracer()


@contextlib.contextmanager
def span(name: str, **attrs):
    """``with obs.span("name", k=v):`` on the default tracer."""
    with TRACER.span(name, **attrs):
        yield


def series(name: str, values, **attrs) -> None:
    """Record a series on the default tracer."""
    TRACER.series(name, values, **attrs)


def point(name: str, value: float, **attrs) -> None:
    """Record a point observation on the default tracer."""
    TRACER.point(name, value, **attrs)


def export_jsonl(path, *, with_metrics: bool = True) -> Path:
    """Export the default tracer (and, by default, the metrics snapshot)."""
    snap = None
    if with_metrics:
        from repro_torch.obs import metrics as _metrics

        snap = _metrics.snapshot()
    return TRACER.export_jsonl(path, metrics_snapshot=snap)
