"""Async sketch ingest: overlap batch production and the host-to-device copy
with the sketch (counterpart of ``repro.core.ingest``).

``ckm.fit_streaming`` is one pass of ``engine.update`` over a batch iterator.
Fed synchronously, its wall clock is the *sum* of host-side batch production,
the copy to the card and the sketch kernel.  The sketch is a fold over a
commutative monoid, so nothing in the result depends on when a batch was
produced, and the stages pipeline freely:

    producer thread:  source -> float32 -> pinned slot -> side-stream copy -> queue
    consumer (caller):           queue -> wait on the copy -> engine.update

On the card the producer copies each batch into a ring of ``prefetch + 2``
pinned host buffers and issues the host-to-device copy on a side
``torch.cuda.Stream``, with an event the consumer's stream waits on before
it sketches the batch: the copy of batch ``i + 1`` runs under the kernel of
batch ``i``.  A pinned slot is written only after the event of the copy that
last read it has completed.  A batch that is already a float32 tensor on the
card passes straight through, as the reference's ``device_put`` does: no
pinned slot, no copy, no event.  On the CPU the producer's placement is
``torch.as_tensor(batch, float32)``.

Both ingest modes bound the resident batches.  The sync path
(``ckm.compute_sketch_streaming``) waits on the device after every fold, so
one batch is alive at a time; the async path waits after every fold too, and
holds ``prefetch + 2`` batches at most: ``prefetch`` in the queue, one being
folded and one produced but blocked on a full queue.  The consumer keeps
each device batch referenced until the wait on its own stream after the
fold, so the side stream's allocation is not reused while the kernel reads
it.

The async path folds the same batches in the same order with the same
kernel as the sync path: the same bits (kernel 1 sums in a fixed order,
kernel 3 sums integers).  There is no fallback: if pinning, the side stream
or the copy fails, the exception reaches the consumer and the pass raises.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Iterator, Protocol, runtime_checkable

import torch

from repro_torch.obs import runtime as obs_rt

__all__ = [
    "BatchSource",
    "IngestStats",
    "prefetched",
    "ingest_stream",
]


@runtime_checkable
class BatchSource(Protocol):
    """Anything that can be iterated into ``(B_i, n)`` point batches (numpy
    arrays or tensors).  Batch sizes may be ragged; each batch must share the
    feature dimension."""

    def __iter__(self) -> Iterator[Any]: ...


@dataclasses.dataclass
class IngestStats:
    """Timing breakdown of one ingest run.

    ``produce_s`` is time spent inside the source and the placement (the
    producer thread: the copy into a pinned slot and the issue of the device
    copy), ``compute_s`` time inside ``engine.update`` and the wait after it
    (consumer), ``consumer_wait_s`` time the consumer starved on an empty
    queue, ``producer_wait_s`` time the producer blocked on a full one.
    """

    batches: int = 0
    points: int = 0
    produce_s: float = 0.0
    compute_s: float = 0.0
    consumer_wait_s: float = 0.0
    producer_wait_s: float = 0.0
    wall_s: float = 0.0

    @property
    def overlap_efficiency(self) -> float:
        """Fraction of the maximum hideable time actually hidden, in [0, 1].

        A serial loop takes ``produce_s + compute_s``; perfect overlap takes
        ``max(produce_s, compute_s)`` — the difference that *could* be hidden
        is ``min(produce_s, compute_s)``, and what *was* hidden is the serial
        total minus the measured wall clock.
        """
        hideable = min(self.produce_s, self.compute_s)
        if hideable <= 0.0 or self.wall_s <= 0.0:
            return 0.0
        hidden = self.produce_s + self.compute_s - self.wall_s
        return max(0.0, min(1.0, hidden / hideable))

    def emit_metrics(self, *, resident_batches: int | None = None) -> None:
        """Publish this run's accounting through ``repro_torch.obs.metrics``
        (called by :func:`ingest_stream` when telemetry is enabled).
        Counters accumulate across runs; the gauges describe the last run."""
        from repro_torch.obs import metrics as obs_metrics

        obs_metrics.counter("ingest.batches").inc(self.batches)
        obs_metrics.counter("ingest.points").inc(self.points)
        obs_metrics.counter("ingest.produce_s").inc(self.produce_s)
        obs_metrics.counter("ingest.compute_s").inc(self.compute_s)
        obs_metrics.counter("ingest.consumer_wait_s").inc(self.consumer_wait_s)
        obs_metrics.counter("ingest.producer_wait_s").inc(self.producer_wait_s)
        obs_metrics.counter("ingest.wall_s").inc(self.wall_s)
        obs_metrics.gauge("ingest.overlap_efficiency").set(self.overlap_efficiency)
        if resident_batches is not None:
            obs_metrics.gauge("ingest.resident_batches").set(resident_batches)


_DONE = object()


def _put_until_stopped(q: "queue.Queue", item, stop: threading.Event):
    """Enqueue ``item`` unless the consumer has already walked away."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return
        except queue.Full:
            continue


def prefetched(
    source: BatchSource,
    prefetch: int = 2,
    *,
    place=None,
    stats: IngestStats | None = None,
) -> Iterator[Any]:
    """Iterate ``source`` through a producer thread and a bounded queue.

    ``prefetch`` is the queue depth (2 = double buffering).  ``place``
    optionally maps each raw batch onto its device inside the producer, so
    the transfer overlaps the consumer's work.  An exception raised by the
    source or by ``place`` is re-raised at the consumer's next pull, and an
    early exit of the consumer (``close()``, ``break``) stops the producer.
    """
    if prefetch < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {prefetch}")
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def produce():
        try:
            it = iter(source)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)  # source generation / I-O happens here
                except StopIteration:
                    break
                if place is not None:
                    batch = place(batch)
                if stats is not None:
                    stats.produce_s += time.perf_counter() - t0
                while not stop.is_set():
                    t0 = time.perf_counter()
                    try:
                        q.put(batch, timeout=0.1)
                        if stats is not None:
                            stats.producer_wait_s += time.perf_counter() - t0
                        break
                    except queue.Full:
                        if stats is not None:
                            stats.producer_wait_s += time.perf_counter() - t0
                if stop.is_set():
                    return
            _put_until_stopped(q, _DONE, stop)
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            _put_until_stopped(q, e, stop)

    worker = threading.Thread(target=produce, name="sketch-ingest", daemon=True)
    worker.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if stats is not None:
                stats.consumer_wait_s += time.perf_counter() - t0
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        worker.join(timeout=5.0)


class _PinnedStager:
    """The producer's placement on the card: a ring of ``slots`` pinned host
    buffers, a side stream for the copies and one event per copy.

    ``__call__`` returns ``(device batch, copy event)``; the consumer's stream
    waits on the event before it reads the batch.  A slot is overwritten
    only after the event of the copy that last read it has completed.
    """

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.buffers: list[torch.Tensor | None] = [None] * slots
        self.events: list[torch.cuda.Event | None] = [None] * slots
        self.next = 0

    def __call__(self, batch):
        if isinstance(batch, torch.Tensor) and batch.is_cuda:
            return self._on_card(batch)
        return self._pinned(batch)

    def _pinned(self, batch):
        """Host data through the next pinned slot and a side-stream copy."""
        host = torch.as_tensor(batch)
        slot = self.next
        self.next = (slot + 1) % len(self.buffers)
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        buf = self.buffers[slot]
        if buf is None or buf.numel() < host.numel():
            buf = self.buffers[slot] = torch.empty(
                (host.numel(),), dtype=torch.float32, pin_memory=True
            )
        staged = buf[: host.numel()].view(host.shape)
        staged.copy_(host)  # the float32 conversion of the sync path's as_tensor
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            x = torch.empty(staged.shape, dtype=torch.float32, device=self.device)
            x.copy_(staged, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[slot] = event
        return x, event

    def _on_card(self, batch: torch.Tensor):
        """A batch already on the card passes through: a float32 batch as
        it is, with no copy and no event (the sync path's cast is a no-op
        for it); another dtype cast on the producer's stream, with an event
        the consumer waits on.  A batch on another card raises, as the
        engine's own device checks do."""
        if batch.device != self.device:
            raise ValueError(
                f"batch is a CUDA tensor on {batch.device}, but the engine runs on "
                f"{self.device}"
            )
        if batch.dtype == torch.float32:
            return batch, None
        with torch.cuda.device(self.device):
            x = batch.to(torch.float32)
            event = torch.cuda.Event()
            event.record()
        return x, event


def _place_cpu(batch):
    return torch.as_tensor(batch, dtype=torch.float32), None


def ingest_stream(
    engine,
    source: BatchSource,
    *,
    state=None,
    prefetch: int = 2,
    donate: bool | None = None,
) -> tuple[Any, IngestStats]:
    """Fold ``source`` into an engine state with production/compute overlap.

    Drives ``engine.update`` exactly like a sync loop would — same batches,
    same order, the same bits — while a producer thread keeps ``prefetch``
    batches staged on the engine's device.  Returns the final *unfinalized*
    state (callers may keep merging partials into it before ``finalize``)
    and the :class:`IngestStats` of the overlap achieved.

    ``donate=True`` updates the carried state in place (each fold's result
    is copied into the carried tensors), after copying the incoming
    ``state`` first, so the caller's tensors are never written.  The bits
    are those of the default path.
    """
    stats = IngestStats()
    if state is None:
        state = engine.init_state()
    dev = engine.device
    place = _PinnedStager(dev, prefetch + 2) if dev.type == "cuda" else _place_cpu
    donate = bool(donate)
    if donate:
        state = type(state)(*(t.clone() for t in state))

    from repro_torch.obs import trace as obs_trace

    with obs_trace.span("ingest.stream", prefetch=prefetch, donate=donate):
        t_start = time.perf_counter()
        for batch, copied in prefetched(source, prefetch, place=place, stats=stats):
            t0 = time.perf_counter()
            if copied is not None:
                torch.cuda.current_stream(dev).wait_event(copied)
            new = engine.update(state, batch)
            if donate:
                for dst, src in zip(state, new):
                    dst.copy_(src)
            else:
                state = new
            # Wait per batch: a batch is discarded once folded in.  Without
            # the wait, queued launches would keep their batches alive
            # whenever production outruns the device, and the side stream
            # could reuse a batch's memory under a running kernel.  The wait
            # is on the consumer's stream alone: the producer's next copy on
            # the side stream runs on, and compute_s stays the fold's time.
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            stats.compute_s += time.perf_counter() - t0
            stats.batches += 1
            stats.points += int(batch.shape[0])
            del batch, new
        stats.wall_s = time.perf_counter() - t_start
    if obs_rt.ENABLED:
        stats.emit_metrics(resident_batches=prefetch + 2)
    return state, stats
