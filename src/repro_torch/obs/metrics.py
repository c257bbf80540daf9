"""Metrics registry: counters, gauges and histograms (counterpart of
``repro.obs.metrics``).

Design constraints (the reference's hot-path contract):

- **Disabled = free.**  Call sites guard on ``runtime.ENABLED`` before
  touching the registry, so a disabled process never pays a dict lookup —
  only one module-attribute read per instrumented call.
- **Enabled = no churn.**  ``counter()/gauge()/histogram()`` are
  get-or-create: the first call for a ``(name, labels)`` pair allocates the
  instrument, every later call is a dict hit returning the *same* object.
  Hot paths that fire per batch (``SketchEngine.update``) resolve their
  handles once and cache them on the owning object, so the steady state is
  a plain ``float +=``.
- **Labels are identity.**  ``counter("engine.update.rows", bits="none")``
  and ``bits="1"`` are two instruments; ``snapshot()`` keys them as
  ``name{k=v,...}``.

Instruments are plain Python accumulators (no tensors): telemetry must
never put anything on a device or into a captured graph.  Increments from
the ingest producer thread interleave with the consumer's under the GIL;
get-or-create is lock-protected so two threads cannot race a first-touch
registration.
"""

from __future__ import annotations

import math
import threading
from typing import Iterator

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "reset",
]


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _format_key(name: str, label_key: tuple) -> str:
    if not label_key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in label_key) + "}"


class Counter:
    """Monotone accumulator (rows folded, cache hits, seconds stalled)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Gauge:
    """Last-write-wins instantaneous value (overlap fraction, drift score)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Streaming distribution summary: count/sum/min/max + log2 buckets.

    ``observe(v)`` is O(1) and allocation-free after the first touch of a
    bucket: values land in power-of-two buckets (index ``ceil(log2 v)``),
    enough resolution for latency work without reservoir bookkeeping.
    """

    __slots__ = ("name", "labels", "count", "total", "min", "max", "buckets")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: dict[int, int] = {}

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        idx = math.frexp(value)[1] if value > 0.0 else -1074
        self.buckets[idx] = self.buckets.get(idx, 0) + 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricsRegistry:
    """Process-wide instrument store; one lives at ``metrics.REGISTRY``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[tuple, object] = {}
        # Bumped by reset(): hot-path callers that cache instrument handles
        # (e.g. SketchEngine) compare generations to drop stale handles.
        self.generation = 0

    def _get(self, cls, name: str, labels: dict):
        lk = _label_key(labels)
        key = (cls, name, lk)
        inst = self._instruments.get(key)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(key)
                if inst is None:
                    inst = cls(name, lk)
                    self._instruments[key] = inst
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def __iter__(self) -> Iterator:
        return iter(list(self._instruments.values()))

    def __len__(self) -> int:
        return len(self._instruments)

    def snapshot(self) -> dict:
        """``{"name{labels}": value-or-summary}`` for export/assertions."""
        out: dict = {}
        for inst in self:
            key = _format_key(inst.name, inst.labels)
            if isinstance(inst, Histogram):
                out[key] = {
                    "count": inst.count,
                    "sum": inst.total,
                    "min": inst.min if inst.count else None,
                    "max": inst.max if inst.count else None,
                    "mean": inst.mean,
                }
            else:
                out[key] = inst.value
        return out

    def reset(self) -> None:
        """Drop every instrument (tests; between benchmark trials)."""
        with self._lock:
            self._instruments.clear()
            self.generation += 1


REGISTRY = MetricsRegistry()


def counter(name: str, **labels) -> Counter:
    """Get-or-create a counter on the default registry."""
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    """Get-or-create a gauge on the default registry."""
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    """Get-or-create a histogram on the default registry."""
    return REGISTRY.histogram(name, **labels)


def snapshot() -> dict:
    """Snapshot of the default registry."""
    return REGISTRY.snapshot()


def reset() -> None:
    """Reset the default registry."""
    REGISTRY.reset()
