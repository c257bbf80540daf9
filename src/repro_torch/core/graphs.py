"""Decoder loops replayed as CUDA graphs.

The reference compiles each decode into one XLA program (``jax.jit`` over
``fori_loop`` / ``scan``).  The port's decoders are loops of small device
operations, and run eagerly each of them costs the host a launch: a decode
kept the card busy for 5-9% of its time.  :func:`loop` runs such a loop
body on a CUDA tensor as a ``torch.cuda.CUDAGraph``, captured once and
replayed, so the host launches one graph where it launched hundreds of
operations.  On a CPU tensor, or with ``eager=True`` (for comparisons on the
card), the same body runs eagerly, step by step.

The body is ``state = body(state, inputs, row, op, const)``:

- ``state`` and ``inputs`` are tuples of tensors of fixed shapes.  The graph
  reads static copies of them: each call copies the live ``state`` in with
  ``copy_`` (and each input that is not the very tensor, unchanged, copied
  last time) and returns clones of the final state;
- ``row`` is row ``i`` of the ``sched`` table at step ``i`` (or ``None``):
  the host scalars of a data-independent schedule (Adam's bias corrections,
  FISTA's momentum), computed once in float32.  A graph reads its row from a
  device step counter, so the captured kernels see exactly the float32
  values the eager loop passes;
- ``op`` (a frequency operator, read by pointer) and ``const`` (hashable
  constants: exactly what the body reads besides its tensors) are part of
  the cache key, as are ``body``, the unroll, the tensors' shapes and dtypes
  and the schedule's shape.  A graph captures ``unroll`` steps and is
  replayed ``steps / unroll`` times; the step count itself is not in the
  key, since a graph of ``unroll`` steps is the same however often it is
  replayed (a schedule's length is).

Graphs are cached per operator (dropped when the operator is collected) or,
without one, in a module-level table, so a fit captures each body once.  The
first call of a key runs its first ``unroll`` steps eagerly, which makes the
lazy first-use work (cuBLAS handles, the Hadamard matrices, the kernels'
libraries) happen outside the capture, then captures.  Capture time is spent
inside the decode, and counted in its seconds.

Random draws stay outside the bodies, and no body reads a device value on
the host.  A body called while another graph is being captured runs inline,
eagerly, and becomes part of that graph.  A failed capture raises: there is
no quiet fallback to the eager loop.

The kernel wrappers count their launches in Python integers, which a replay
does not touch.  A graph records how far each count moved while it was
captured (and puts the counts back, since nothing was launched), and each
replay adds that much again, so the counts equal the eager loop's.
"""

from __future__ import annotations

import weakref
from typing import Callable

import torch

from repro_torch.kernels import amp_denoise as _amp
from repro_torch.kernels import assign_argmin as _assign
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fourier_sketch as _sketch
from repro_torch.kernels import freq_transform as _ft
from repro_torch.kernels import sketch_shift as _shift

Tensors = tuple[torch.Tensor, ...]

# Each kernel wrapper's launch counter, as (module, attribute).
COUNTERS = (
    (_sketch, "LAUNCHES"),
    (_sketch, "QUANTIZED_LAUNCHES"),
    (_assign, "LAUNCHES"),
    (_ft, "STRUCTURED_LAUNCHES"),
    (_ft, "QUANTIZED_STRUCTURED_LAUNCHES"),
    (_shift, "LAUNCHES"),
    (_amp, "LAUNCHES"),
    (_flash, "LAUNCHES"),
)

# Captures and replays since the counts were last reset (what a decode's
# graphs cost the host, for the smoke run's report).
CAPTURES = 0
REPLAYS = 0


class _Graph:
    """One captured body: the graph, its static buffers and the launches
    one replay makes."""

    def __init__(self, graph, state, inputs, sched, counter, launches):
        self.graph, self.state, self.inputs = graph, state, inputs
        self.sched, self.counter, self.launches = sched, counter, launches
        # The live input last copied into each static input, and its version:
        # an input the caller has not replaced or changed is not copied again.
        self.sources: list = [None] * len(inputs)
        self.versions: list = [None] * len(inputs)

    def load(self, state, inputs) -> None:
        """Copy the live state and any new or changed input into the static
        buffers."""
        for dst, src in zip(self.state, state):
            dst.copy_(src)
        for i, (dst, src) in enumerate(zip(self.inputs, inputs)):
            if self.sources[i] is not src or self.versions[i] != src._version:
                dst.copy_(src)
                self.sources[i], self.versions[i] = src, src._version


_SHARED: dict = {}
_BY_OP: dict[int, dict] = {}
_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def _cache_for(op) -> dict:
    if op is None:
        return _SHARED
    key = id(op)
    cache = _BY_OP.get(key)
    if cache is None:
        cache = _BY_OP[key] = {}
        # The graphs read the operator's tensors by pointer: they go with it.
        weakref.finalize(op, _BY_OP.pop, key, None)
    return cache


def clear() -> None:
    """Drop every cached graph (their memory pools go with them)."""
    _SHARED.clear()
    _BY_OP.clear()


def _signature(ts: Tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in ts)


def unroll_for(steps: int, cap: int) -> int:
    """The largest divisor of ``steps`` that is at most ``cap``."""
    return max(d for d in range(1, max(1, min(cap, steps)) + 1) if steps % d == 0)


def _counts() -> list[int]:
    return [getattr(mod, attr) for mod, attr in COUNTERS]


def _set_counts(values) -> None:
    for (mod, attr), v in zip(COUNTERS, values):
        setattr(mod, attr, v)


def _record(run: Callable[[], None], dev: torch.device) -> torch.cuda.CUDAGraph:
    """Capture what ``run`` enqueues as a CUDA graph, on a side stream (the
    legacy default stream cannot capture)."""
    stream = _STREAMS.get(dev)
    if stream is None:
        stream = _STREAMS[dev] = torch.cuda.Stream(dev)
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            run()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(stream)
    return graph


def _capture(body, state, inputs, sched, op, const, unroll) -> _Graph:
    global CAPTURES
    dev = state[0].device
    s_state = tuple(t.clone() for t in state)
    s_inputs = tuple(t.clone() for t in inputs)
    s_sched = None if sched is None else sched.clone()
    counter = torch.zeros((1,), dtype=torch.int64, device=dev)

    def run():
        cur = s_state
        for _ in range(unroll):
            row = None if s_sched is None else s_sched.index_select(0, counter)[0]
            cur = body(cur, s_inputs, row, op, const)
            counter.add_(1)
        for dst, src in zip(s_state, cur):
            dst.copy_(src)

    before = _counts()
    graph = _record(run, dev)
    launches = [a - b for a, b in zip(_counts(), before)]
    _set_counts(before)  # the capture launched nothing
    CAPTURES += 1
    return _Graph(graph, s_state, s_inputs, s_sched, counter, launches)


def _graphable(t: torch.Tensor) -> bool:
    """Whether a loop on ``t`` runs as a graph: a CUDA tensor, and no
    capture under way (a body inside another capture runs inline)."""
    return t.is_cuda and not torch.cuda.is_current_stream_capturing()


def loop(
    body: Callable,
    state: Tensors,
    inputs: Tensors,
    steps: int,
    *,
    sched: torch.Tensor | None = None,
    op=None,
    const=None,
    unroll: int = 1,
    eager: bool = False,
) -> Tensors:
    """``state = body(state, inputs, row, op, const)`` for ``steps`` steps,
    with ``row = sched[i]`` at step ``i``; returns the final state.

    On CUDA tensors the body runs as a cached CUDA graph of ``unroll`` steps
    (rounded down to a divisor of ``steps``), unless ``eager`` is set or a
    capture is under way; on CPU tensors it runs eagerly.
    """
    global REPLAYS

    def eager_steps(state, stop):
        for i in range(stop):
            state = tuple(body(state, inputs, None if sched is None else sched[i], op, const))
        return state

    state = tuple(state)
    if steps <= 0:
        return state
    if eager or not _graphable(state[0]):
        return eager_steps(state, steps)
    unroll = unroll_for(steps, unroll)
    key = (body, const, unroll, _signature(state), _signature(inputs),
           None if sched is None else (tuple(sched.shape), sched.dtype))
    cache = _cache_for(op)
    g = cache.get(key)
    start = 0
    if g is None:
        # The first steps run eagerly: lazy first-use work happens here, not
        # under the capture.
        state = eager_steps(state, unroll)
        start = unroll
        g = cache[key] = _capture(body, state, inputs, sched, op, const, unroll)
        if start == steps:
            return state
    g.load(state, tuple(inputs))
    if g.sched is not None:
        g.sched.copy_(sched)
    g.counter.fill_(start)
    replays = (steps - start) // unroll
    for _ in range(replays):
        g.graph.replay()
    _set_counts([c + replays * d for c, d in zip(_counts(), g.launches)])
    REPLAYS += replays
    return tuple(t.clone() for t in g.state)
