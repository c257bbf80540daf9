"""Bucketed ring-of-sketches windows: "cluster the last hour of events"
(counterpart of ``repro.core.window``).

Exponential decay (``SketchEngine(decay=...)``) down-weights the past but
never forgets it; a **window** forgets exactly.  :class:`SketchWindow` keeps
``W`` rotating *bucket* states — bucket ``b`` holds the sketch of everything
that arrived in tick-interval ``[b·bucket_ticks, (b+1)·bucket_ticks)`` — and
answers a query by merging the live buckets **on read**.  Memory is
O(W · m) and an update touches exactly one bucket.

The ring reuses slots modulo ``W``: when a new tick claims the slot of an
expired bucket, the stale state is reset to the monoid identity first, and
``read`` filters slots to the exact ``(read_tick - W, read_tick]`` tick range,
so a reused slot never leaks expired data into a query.

Everything here is monoid algebra over a wrapped
:class:`~repro_torch.core.engine.SketchEngine` **or**
:class:`~repro_torch.core.fleet.FleetEngine` (the whole fleet windows in the
same W-slot ring; per-slot states are the stacked ``(T, ...)`` states, so one
bucket update is still one fleet call; over a tenant-mesh fleet a bucket is
the engine's ``FleetShards`` and every fold routes through the engine, block
by block); the bookkeeping is host-side numpy.
Combining ``decay`` with a window gives exponential weighting inside the
window and a hard cutoff at its edge; ``read`` then advances the merged
state's clock to the query time.  ``ingest`` and the tenant-column surgery
need a fleet engine: a single engine's window refuses them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

__all__ = ["SketchWindow", "WindowState"]


@dataclasses.dataclass(frozen=True)
class WindowState:
    """Ring of ``W`` bucket states plus host-side slot bookkeeping.

    ``buckets`` is a tuple of W separate engine states, so an update rewrites
    exactly one bucket.  ``slot_tick`` records which absolute tick each slot
    holds (-1 = never used); ``head`` is the newest tick ever claimed (-1 =
    empty).
    """

    buckets: tuple[Any, ...]
    slot_tick: np.ndarray  # (W,) int64, -1 = empty slot
    head: int  # newest claimed tick, -1 = empty window


class SketchWindow:
    """A W-bucket sliding window over a sketch engine.

    Parameters
    ----------
    engine : the wrapped :class:`~repro_torch.core.engine.SketchEngine` or
        :class:`~repro_torch.core.fleet.FleetEngine`; the window inherits its
        device, operators, quantizers and decay.
    buckets : W, the window length in buckets.  A read at tick ``c`` merges
        buckets ``(c - W, c]``.
    bucket_ticks : width of one bucket on the ``t`` axis (tick
        ``floor(t / bucket_ticks)``).  With ``decay`` on the engine, ``t``
        shares the unit the engine's gamma is defined per.
    """

    def __init__(self, engine, buckets: int, *, bucket_ticks: float = 1.0):
        if buckets < 1:
            raise ValueError(f"buckets must be >= 1, got {buckets}")
        if not bucket_ticks > 0:
            raise ValueError(f"bucket_ticks must be positive, got {bucket_ticks}")
        self.engine = engine
        self.buckets = int(buckets)
        self.bucket_ticks = float(bucket_ticks)

    # -- ring bookkeeping ----------------------------------------------------

    def tick(self, t) -> int:
        """Absolute bucket index of time ``t``."""
        return int(math.floor(float(t) / self.bucket_ticks))

    def init_state(self) -> WindowState:
        """W identity buckets, nothing claimed."""
        return WindowState(
            buckets=tuple(self.engine.init_state() for _ in range(self.buckets)),
            slot_tick=np.full((self.buckets,), -1, np.int64),
            head=-1,
        )

    def _claim(self, ws: WindowState, tick: int):
        """``(ws, slot)`` for ``tick``, resetting a stale occupant; slot None
        for a tick already outside the newest possible read window
        (``tick <= head - W``): its slot belongs to a newer bucket."""
        if ws.head >= 0 and tick <= ws.head - self.buckets:
            return ws, None
        slot = tick % self.buckets
        if int(ws.slot_tick[slot]) != tick:
            bks = list(ws.buckets)
            bks[slot] = self.engine.init_state()
            st = ws.slot_tick.copy()
            st[slot] = tick
            ws = WindowState(buckets=tuple(bks), slot_tick=st, head=max(ws.head, tick))
        elif tick > ws.head:
            ws = dataclasses.replace(ws, head=tick)
        return ws, slot

    # -- monoid ops ----------------------------------------------------------

    def _fold(self, ws: WindowState, t, fold_fn):
        """Claim ``t``'s bucket and fold into it; a fold older than the whole
        ring is dropped."""
        ws, slot = self._claim(ws, self.tick(t))
        if slot is None:
            return ws
        bks = list(ws.buckets)
        bks[slot] = fold_fn(bks[slot])
        return dataclasses.replace(ws, buckets=tuple(bks))

    def _tick_kw(self, t) -> dict:
        return {} if self.engine.decay is None else {"t": float(t)}

    def update(self, ws: WindowState, batch, weights=None, *, t):
        """Fold ``batch`` at time ``t`` into its bucket (single engine:
        ``batch (B, n)``; fleet engine: an aligned block ``(T, B, n)``)."""
        return self._fold(
            ws, t, lambda b: self.engine.update(b, batch, weights, **self._tick_kw(t)))

    def ingest(self, ws: WindowState, tenant_ids, batches, weights=None, *, t):
        """Fleet request routing at time ``t`` (``FleetEngine.ingest``); all
        requests of one call share ``t`` and land in one bucket."""
        fleet = self._fleet()
        return self._fold(
            ws, t, lambda b: fleet.ingest(b, tenant_ids, batches, weights, **self._tick_kw(t)))

    def read(self, ws: WindowState, t=None):
        """Merge-on-read: the engine state of the last W buckets at ``t``.

        ``t=None`` reads at the newest claimed tick.  Buckets with tick in
        ``(read_tick - W, read_tick]`` merge in increasing-tick order from the
        engine identity (a fixed association, so repeated reads repeat their
        bits); every other slot is excluded.  With ``decay`` on the engine
        and an explicit ``t``, the merged state's clock is advanced to ``t``.
        """
        read_tick = ws.head if t is None else self.tick(t)
        live = sorted(
            (int(tk), slot)
            for slot, tk in enumerate(ws.slot_tick)
            if tk >= 0 and read_tick - self.buckets < tk <= read_tick
        )
        out = self.engine.init_state()
        for _, slot in live:
            out = self.engine.merge(out, ws.buckets[slot])
        if self.engine.decay is not None and t is not None:
            out = self.engine.decay_to(out, float(t))
        return out

    def finalize(self, ws: WindowState, t=None):
        """``read`` + engine finalize: the windowed ``(z, lower, upper)``."""
        return self.engine.finalize(self.read(ws, t))

    def state_bytes(self, ws: WindowState) -> int:
        """Resident bytes of the whole ring (W buckets; a tenant-mesh fleet's
        buckets hold one stacked state a block)."""
        from repro_torch.core.fleet import FleetShards

        states = [s for b in ws.buckets
                  for s in (b.blocks if isinstance(b, FleetShards) else (b,))]
        return sum(leaf.numel() * leaf.element_size() for st in states for leaf in st)

    # -- fleet tenant surgery ------------------------------------------------

    def _fleet(self):
        from repro_torch.core.fleet import FleetEngine

        if not isinstance(self.engine, FleetEngine):
            raise TypeError(
                f"this window wraps a {type(self.engine).__name__}; ingest and the "
                "tenant columns need a fleet engine (core.fleet.FleetEngine)"
            )
        return self.engine

    def tenant_column(self, ws: WindowState, tenant: int):
        """Tenant's per-slot rows (a tuple of W single-engine states) — what
        an eviction checkpoints beside the lifetime row."""
        fleet = self._fleet()
        return tuple(fleet.tenant_state(b, tenant) for b in ws.buckets)

    def set_tenant_column(self, ws: WindowState, tenant: int, column):
        """Write a tenant's W per-slot rows back (the restore path)."""
        fleet = self._fleet()
        if len(column) != self.buckets:
            raise ValueError(f"column has {len(column)} rows for {self.buckets} buckets")
        bks = tuple(fleet.set_tenant(b, tenant, row) for b, row in zip(ws.buckets, column))
        return dataclasses.replace(ws, buckets=bks)

    def reset_tenant(self, ws: WindowState, tenant: int):
        """Tenant's rows to the identity in every bucket; the slot
        bookkeeping is fleet-wide and other tenants keep their buckets."""
        fleet = self._fleet()
        return dataclasses.replace(
            ws, buckets=tuple(fleet.reset_tenant(b, tenant) for b in ws.buckets))

    def __repr__(self) -> str:
        return (
            f"SketchWindow(W={self.buckets}, bucket_ticks={self.bucket_ticks}"
            f", engine={self.engine!r})"
        )
