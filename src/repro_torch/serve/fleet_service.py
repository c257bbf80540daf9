"""Tenant-sharded sketch serving: ingest, decode-on-demand, evict/restore
(counterpart of ``repro.serve.fleet_service``).

``FleetService`` is the request-facing wrapper around
:class:`repro_torch.core.fleet.FleetEngine`: it buffers interleaved
``(tenant_id, batch)`` requests, flushes them into the stacked state through
the engine's routed ``ingest`` (on the card one launch of the tenant-axis
entry of kernel 1 or 3, or of kernel 4 or 5 for a structured fleet), and
serves **decode-on-demand**: a tenant's centroids are only computed when
asked for, and memoised in an LRU keyed on ``(tenant, state_version)`` —
traffic for other tenants never invalidates a cached decode, and any write
to a tenant bumps its version so a stale decode can never be served.

Async flush: ``flush(async_ingest=True)`` threads the requests through
``core.ingest.prefetched``.  On the card each host batch goes through the
ring of pinned slots and a side-stream copy of ``core.ingest``'s stager; a
group of staged batches is held until its one ``torch.stack``, so the
consumer's stream waits on every batch's copy event, and each batch is
recorded on the consumer's stream (``record_stream``) so the side stream's
allocator cannot reuse its memory while the stack may still read it.  The
same bits as a sync flush.

Cold tenants are evicted through ``checkpoint.checkpointer.Checkpointer``:
the tenant's O(m) state row plus its ``FreqOpSpec`` (the operator recipe —
never the matrix) land in an atomic per-tenant checkpoint, the row is reset
to the monoid identity, and the first request or decode that touches the
tenant again restores it transparently, bitwise.

Default decoder: ``"sketch_shift"`` (kernel 6 on the card); any registered
decoder name works.  Tenant t decodes under ``derive_seed(decode_seed, t)``.

Windowed serving: ``FleetService(window_buckets=W)`` additionally folds every
flush into a ``core.window.SketchWindow`` ring over the same engine (requests
must then carry their tick: ``submit(tenant, batch, t=...)``), and
evict/restore checkpoints the tenant's W bucket-column rows alongside the
lifetime row — bucket count/ticks are validated against the manifest meta,
and on restore only columns whose slot still holds the checkpointed tick
re-enter the ring.

Shard-aware routing: over a tenant-mesh fleet
(``FleetEngine(sharding="mesh")``, one controller, a block of tenant rows a
device), :meth:`FleetService.flush` partitions the pending requests
host-side by owning shard (:func:`shard_partition`) before grouping, and a
dispatch never spans two blocks, so each fleet ``ingest`` touches one
block's rows.  Each tenant's arrival order is kept (its shard is fixed):
the bitwise isolation contract holds; only the interleaving across shards,
which no tenant can observe, changes.  Each request is staged straight onto
its owner's device (async: one pinned ring and one consumer stream per
device); decodes, drift, evictions and restores run on the owner's device,
and a checkpoint's row moves between the host and its owner only.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from pathlib import Path
from typing import Iterable, NamedTuple

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import ckm as ckm_mod
from repro_torch.core import fleet as fleet_mod
from repro_torch.core import ingest as ingest_mod
from repro_torch.obs import runtime as obs_rt

__all__ = [
    "DecodeResult",
    "FleetServiceStats",
    "FleetService",
    "shard_partition",
]


def shard_partition(pending, owner, n_shards: int):
    """Stable host-side partition of ``(tenant, ...)`` requests by shard.

    Returns the requests regrouped shard 0 first, preserving each shard's —
    and therefore each *tenant's* — internal arrival order (``owner`` is a
    function of the tenant id alone), and the per-shard lists.
    """
    buckets: list[list] = [[] for _ in range(n_shards)]
    for req in pending:
        buckets[owner(req[0])].append(req)
    return [req for bucket in buckets for req in bucket], buckets


class DecodeResult(NamedTuple):
    """One tenant's decoded model + the cache bookkeeping around it."""

    centroids: torch.Tensor  # (K, n)
    weights: torch.Tensor  # (K,)
    cost: torch.Tensor  # sketch-domain objective of the decode
    version: int  # tenant state version the decode corresponds to
    cached: bool  # True when served from the LRU


@dataclasses.dataclass
class FleetServiceStats:
    requests: int = 0  # (tenant, batch) requests folded in
    points: int = 0  # data points folded in
    flushes: int = 0  # ingest dispatches into the stacked state
    decodes: int = 0  # decode calls answered
    decode_hits: int = 0  # served from the LRU
    decode_misses: int = 0  # freshly decoded
    decode_cache_evictions: int = 0  # LRU entries dropped at capacity
    evictions: int = 0
    restores: int = 0
    drift_redecodes: int = 0  # decodes forced by a drift_threshold breach

    @property
    def hit_rate(self) -> float:
        return self.decode_hits / self.decodes if self.decodes else 0.0


class FleetService:
    """Multi-tenant sketch service over one stacked FleetEngine state.

    Parameters
    ----------
    engine : the :class:`~repro_torch.core.fleet.FleetEngine` holding the
        fleet; the service runs each tenant on its owner's device.
    decode_config : ``CKMConfig`` used for every decode (``decoder`` defaults
        to ``"sketch_shift"`` when the caller leaves the CKMConfig default
        ``"clompr"`` untouched).
    decode_cache_entries : LRU capacity in decoded models (0 disables).
    checkpoint_dir : directory for per-tenant eviction checkpoints (required
        by :meth:`evict`).
    decode_seed : tenant t decodes under ``derive_seed(decode_seed, t)``, so
        decodes are deterministic per tenant.
    drift_threshold : optional CF-distance bound for unattended drift
        maintenance — a positive scalar or a per-tenant array of shape
        ``(n_tenants,)``.  When set, every :meth:`flush` scores the flushed
        tenants' live sketches against their *cached* decodes
        (``obs.diagnose.sketch_drift``); a tenant over its bound has its
        cache entries invalidated and is re-decoded immediately (counter
        ``fleet.redecode.drift``, gauge ``fleet.drift.threshold``).
        Tenants without a cached decode are never scored.
    window_buckets, window_bucket_ticks : ``window_buckets=W > 0`` attaches
        a W-bucket ``core.window.SketchWindow`` ring over the same engine;
        windowed submissions must pass their tick (``submit(..., t=...)``).
    """

    def __init__(
        self,
        engine: fleet_mod.FleetEngine,
        decode_config: ckm_mod.CKMConfig,
        *,
        decode_cache_entries: int = 256,
        checkpoint_dir: str | Path | None = None,
        decode_seed: int = 0,
        drift_threshold=None,
        window_buckets: int = 0,
        window_bucket_ticks: float = 1.0,
    ):
        self.engine = engine
        if decode_config.decoder == "clompr":
            decode_config = dataclasses.replace(
                decode_config, decoder="sketch_shift"
            )
        self.decode_config = decode_config
        self.state = engine.init_state()
        self.decode_cache_entries = int(decode_cache_entries)
        self.checkpoint_dir = (
            Path(checkpoint_dir) if checkpoint_dir is not None else None
        )
        self.decode_seed = int(decode_seed)
        if drift_threshold is None:
            self.drift_threshold = None
        else:
            arr = np.asarray(drift_threshold, np.float64)
            if arr.ndim == 0:
                if not arr > 0:
                    raise ValueError(
                        f"drift_threshold must be positive, got "
                        f"{drift_threshold!r}"
                    )
                self.drift_threshold = float(arr)
            else:
                if arr.shape != (engine.n_tenants,):
                    raise ValueError(
                        f"per-tenant drift_threshold must have shape "
                        f"({engine.n_tenants},), got {arr.shape}"
                    )
                if not np.all(arr > 0):
                    raise ValueError(
                        "per-tenant drift_threshold entries must all be "
                        "positive"
                    )
                self.drift_threshold = arr
        if window_buckets < 0:
            raise ValueError(
                f"window_buckets must be >= 0, got {window_buckets}"
            )
        self.window = None
        self.window_state = None
        if window_buckets:
            from repro_torch.core.window import SketchWindow

            self.window = SketchWindow(
                engine, int(window_buckets),
                bucket_ticks=float(window_bucket_ticks),
            )
            self.window_state = self.window.init_state()
        self.stats = FleetServiceStats()
        self._versions = np.zeros(engine.n_tenants, np.int64)
        self._cache: OrderedDict[tuple[int, int], DecodeResult] = OrderedDict()
        self._pending: list[tuple[int, object, float | None]] = []
        self._evicted: set[int] = set()

    # -- versions -----------------------------------------------------------

    def version(self, tenant: int) -> int:
        """Monotone per-tenant write counter — the decode-cache key half."""
        return int(self._versions[tenant])

    def _touch(self, tenants: Iterable[int]):
        for t in set(int(t) for t in tenants):
            self._versions[t] += 1

    # -- ingest -------------------------------------------------------------

    def submit(self, tenant: int, batch, t: float | None = None) -> None:
        """Queue one ``(tenant, (B, n) batch)`` request for the next flush.

        ``batch`` is a numpy array or a tensor (a float32 tensor on the
        engine's card is used as it is).  ``t`` is the request's tick for
        decay-enabled or windowed fleets; ``t=None`` folds at each tenant's
        current stamp.  Passing ``t`` without decay or a window is an error;
        a windowed service requires it."""
        tid = int(tenant)
        if not 0 <= tid < self.engine.n_tenants:
            raise ValueError(
                f"tenant {tid} out of range [0, {self.engine.n_tenants})"
            )
        if t is not None and self.engine.decay is None and self.window is None:
            raise ValueError(
                "submit(t=...) requires a decay-enabled fleet "
                "(FleetEngine(..., decay=gamma)) or a windowed service "
                "(FleetService(..., window_buckets=W))"
            )
        if t is None and self.window is not None:
            raise ValueError(
                "a windowed FleetService needs every request's tick: "
                "submit(tenant, batch, t=...)"
            )
        self._pending.append((tid, batch, None if t is None else float(t)))

    def _placed(self, pending, async_ingest: bool, prefetch: int):
        """``(tenant, float32 batch on its owner's device, tick)`` per
        request, in order; async through a producer thread (and on the card
        one pinned ring, side stream and consumer stream of ``core.ingest``
        per device)."""
        devs, rows = self.engine.devices, self.engine.shard_rows
        if not async_ingest:
            for t, b, ts in pending:
                yield t, torch.as_tensor(b, dtype=torch.float32).to(devs[t // rows]), ts
            return
        stagers = {d: ingest_mod._PinnedStager(d, prefetch + 2) if d.type == "cuda"
                   else ingest_mod._place_cpu for d in dict.fromkeys(devs)}
        consumers = {d: torch.cuda.current_stream(d) for d in stagers if d.type == "cuda"}
        for t, (x, copied), ts in ingest_mod.prefetched(
            iter(pending), prefetch,
            place=lambda req: (req[0], stagers[devs[req[0] // rows]](req[1]), req[2]),
        ):
            if copied is not None:
                # The stack reads x on the consumer's stream: wait for its
                # copy, and keep its side-stream memory until that read.
                consumer = consumers[x.device]
                consumer.wait_event(copied)
                x.record_stream(consumer)
            yield t, x, ts

    def flush(self, *, async_ingest: bool = False, prefetch: int = 2) -> int:
        """Fold every queued request into the stacked state; returns the
        number of requests folded.

        Requests are folded in arrival order (the bitwise tenant-isolation
        contract).  Consecutive requests sharing a batch shape, a tick and
        an owning shard are routed as ONE ``FleetEngine.ingest`` dispatch;
        ``async_ingest=True`` stages the next requests' copies under the
        current work (same bits).  With a tenant-mesh engine the flush is
        first partitioned by owning shard (:func:`shard_partition`); each
        tenant's order is untouched.  A windowed service additionally folds
        every dispatch into its tick's bucket.
        """
        pending, self._pending = self._pending, []
        if not pending:
            return 0
        t_flush = time.perf_counter()
        for t, _, _ in pending:
            if t in self._evicted:
                self.restore(t)
        rows = self.engine.shard_rows
        if self.engine.tenant_shards > 1:
            pending, by_shard = shard_partition(
                pending, self.engine.owner_shard, self.engine.tenant_shards
            )
            if obs_rt.ENABLED:
                from repro_torch.obs import metrics as obs_metrics

                for s, bucket in enumerate(by_shard):
                    if bucket:
                        obs_metrics.counter(
                            "fleet.flush.shard_requests", shard=s
                        ).inc(len(bucket))

        group_ids: list[int] = []
        group_batches: list[torch.Tensor] = []
        group_t: list[float | None] = [None]

        def dispatch():
            if not group_ids:
                return
            ids = np.asarray(group_ids)
            stacked = torch.stack(group_batches)
            kwargs = {}
            if self.engine.decay is not None:
                kwargs["t"] = group_t[0]
            self.state = self.engine.ingest(self.state, ids, stacked, **kwargs)
            if self.window is not None:
                self.window_state = self.window.ingest(
                    self.window_state, ids, stacked, t=group_t[0]
                )
            self.stats.flushes += 1
            group_ids.clear()
            group_batches.clear()

        from repro_torch.obs import trace as obs_trace

        with obs_trace.span(
            "fleet.flush", requests=len(pending), async_ingest=async_ingest
        ):
            for t, b, ts in self._placed(pending, async_ingest, prefetch):
                if group_batches and (
                    b.shape != group_batches[0].shape or ts != group_t[0]
                    or t // rows != group_ids[0] // rows
                ):
                    dispatch()  # ragged or block boundary: order kept
                group_ids.append(t)
                group_batches.append(b)
                group_t[0] = ts
                self.stats.requests += 1
                self.stats.points += int(b.shape[0])
            dispatch()
            if obs_rt.ENABLED:
                # Sync so the flush span/histogram measure the fold, not its
                # launch; the untelemetered path keeps dispatching.
                for dev in dict.fromkeys(self.engine.devices):
                    dev_mod.sync(dev)
        self._touch(t for t, _, _ in pending)
        if obs_rt.ENABLED:
            from repro_torch.obs import metrics as obs_metrics

            obs_metrics.histogram("fleet.flush.seconds").observe(
                time.perf_counter() - t_flush
            )
            obs_metrics.counter("fleet.flush.requests").inc(len(pending))
        if self.drift_threshold is not None:
            self.maintain(set(t for t, _, _ in pending))
        return len(pending)

    def ingest(
        self,
        tenant_ids,
        batches,
        *,
        async_ingest: bool = False,
        t: float | None = None,
    ) -> int:
        """Submit + flush in one call (aligned request arrays or lists)."""
        for tid, b in zip(tenant_ids, batches):
            self.submit(int(tid), b, t)
        return self.flush(async_ingest=async_ingest)

    def merge_partial(self, tenant: int, partial) -> None:
        """Fold an externally produced partial state (edge sketcher, another
        host's engine) into one tenant's row — monoid merge, versioned."""
        t = int(tenant)
        if t in self._evicted:
            self.restore(t)
        self.state = self.engine.merge_tenant(self.state, t, partial)
        self._touch([t])

    # -- decode-on-demand ---------------------------------------------------

    def decode(self, tenant: int, *, use_cache: bool = True) -> DecodeResult:
        """Centroids for one tenant, from its sketch alone (O(m) state read +
        one decode), memoised on ``(tenant, version)``."""
        t = int(tenant)
        if t in self._evicted:
            self.restore(t)
        self.stats.decodes += 1
        key = (t, self.version(t))
        if use_cache and key in self._cache:
            self._cache.move_to_end(key)
            self.stats.decode_hits += 1
            if obs_rt.ENABLED:
                from repro_torch.obs import metrics as obs_metrics

                obs_metrics.counter("fleet.decode.hits").inc()
            return self._cache[key]._replace(cached=True)
        self.stats.decode_misses += 1
        from repro_torch.obs import trace as obs_trace

        with obs_trace.span("fleet.decode", tenant=t, version=key[1]):
            z, lo, hi = self.engine.finalize_tenant(self.state, t)
            cents, alphas, cost = ckm_mod.decode_sketch(
                dev_mod.derive_seed(self.decode_seed, t),
                z,
                self.engine.operator(t),
                lo,
                hi,
                self.decode_config,
                device=self.engine.device_of(t),
            )
        result = DecodeResult(cents, alphas, cost, key[1], cached=False)
        if use_cache and self.decode_cache_entries > 0:
            self._cache[key] = result
            self._cache.move_to_end(key)
            while len(self._cache) > self.decode_cache_entries:
                self._cache.popitem(last=False)
                self.stats.decode_cache_evictions += 1
                if obs_rt.ENABLED:
                    from repro_torch.obs import metrics as obs_metrics

                    obs_metrics.counter("fleet.decode.cache_evictions").inc()
        if obs_rt.ENABLED:
            from repro_torch.obs import metrics as obs_metrics

            obs_metrics.counter("fleet.decode.misses").inc()
        return result

    def cache_len(self) -> int:
        return len(self._cache)

    def served_model(self, tenant: int) -> DecodeResult | None:
        """The decoded model this tenant is currently being served — its most
        recently used cache entry, at whatever state-version it was decoded.
        Returns None when the tenant has no cached decode.  Never decodes."""
        t = int(tenant)
        for ct, cv in reversed(self._cache):
            if ct == t:
                return self._cache[(ct, cv)]
        return None

    def drift(self, tenant: int) -> float:
        """O(m) sketch-space drift of one tenant: how far the live sketch has
        moved from the decoded model currently being served (with no cached
        decode, a fresh decode is taken).  Emits the ``fleet.drift{tenant=}``
        gauge when telemetry is on.

        A tenant whose sketch is all-zero — fresh, reset, or fully decayed
        (``weight_sum -> 0``) — scores a defined 0.0, and no decode is
        attempted.
        """
        from repro_torch.obs.diagnose import sketch_drift

        t = int(tenant)
        if t in self._evicted:
            self.restore(t)
        row = self.engine.tenant_state(self.state, t)
        if not float(row.weight_sum) > 0:
            if obs_rt.ENABLED:
                from repro_torch.obs import metrics as obs_metrics

                obs_metrics.gauge("fleet.drift", tenant=t).set(0.0)
            return 0.0
        served = self.served_model(t)
        if served is None:
            served = self.decode(t)
        z_live, _, _ = self.engine.finalize_tenant(self.state, t)
        score = sketch_drift(
            z_live, served.centroids, served.weights, self.engine.operator(t)
        )
        if obs_rt.ENABLED:
            from repro_torch.obs import metrics as obs_metrics

            obs_metrics.gauge("fleet.drift", tenant=t).set(score)
        return score

    # -- drift-triggered maintenance ----------------------------------------

    def threshold(self, tenant: int) -> float | None:
        """The drift bound applied to one tenant: the fleet-wide scalar, the
        tenant's entry of a per-tenant array, or None when maintenance is
        off."""
        if self.drift_threshold is None:
            return None
        if isinstance(self.drift_threshold, float):
            return self.drift_threshold
        return float(self.drift_threshold[int(tenant)])

    def maintain(self, tenants: Iterable[int] | None = None) -> int:
        """Score drift for the given tenants (default: every tenant with a
        cached decode) and re-decode the ones over ``drift_threshold``.

        On a breach the tenant's cache entries are invalidated first, so the
        forced decode can never be served from the LRU; the fresh model is
        cached at the current version and ``fleet.redecode.drift`` counts
        the event.  Only tenants with a cached decode are scored.  Returns
        the number of re-decodes.
        """
        if self.drift_threshold is None:
            return 0
        cached = {t for t, _ in self._cache}
        check = (
            sorted(cached)
            if tenants is None
            else sorted(cached & {int(t) for t in tenants})
        )
        redecoded = 0
        for t in check:
            thr = self.threshold(t)
            if obs_rt.ENABLED:
                from repro_torch.obs import metrics as obs_metrics

                obs_metrics.gauge("fleet.drift.threshold", tenant=t).set(thr)
            if self.drift(t) <= thr:
                continue
            for key in [k for k in self._cache if k[0] == t]:
                del self._cache[key]
            self.decode(t)
            redecoded += 1
            self.stats.drift_redecodes += 1
            if obs_rt.ENABLED:
                from repro_torch.obs import metrics as obs_metrics

                obs_metrics.counter("fleet.redecode.drift").inc()
        return redecoded

    # -- evict / restore ----------------------------------------------------

    def _checkpointer(self, tenant: int) -> Checkpointer:
        if self.checkpoint_dir is None:
            raise ValueError(
                "FleetService needs checkpoint_dir= to evict/restore tenants"
            )
        return Checkpointer(self.checkpoint_dir / f"tenant_{tenant:06d}")

    def evict(self, tenant: int) -> None:
        """Checkpoint a cold tenant's row (state + operator spec) and reset
        the row to the monoid identity.  A windowed service checkpoints the
        tenant's bucket-column rows alongside the lifetime row and resets
        them too."""
        t = int(tenant)
        if t in self._evicted:
            return
        spec = self.engine.specs[t]
        if spec is None:
            raise ValueError(
                f"tenant {t} has no operator spec; eviction checkpoints the "
                "spec, not the operator leaves"
            )
        row = self.engine.tenant_state(self.state, t)
        meta = {
            "tenant": t,
            "version": self.version(t),
            "freq_op_spec": list(spec),
            "quantized_bits": self.engine.bits,
            "decay": self.engine.decay,
        }
        if self.window is None:
            payload = row
        else:
            payload = {
                "row": row,
                "window": list(self.window.tenant_column(self.window_state, t)),
            }
            meta.update(
                window_buckets=self.window.buckets,
                window_bucket_ticks=self.window.bucket_ticks,
                window_slot_tick=[int(x) for x in self.window_state.slot_tick],
                window_head=int(self.window_state.head),
            )
        ckpt = self._checkpointer(t)
        ckpt.save(self.version(t), payload, meta=meta)
        self.state = self.engine.reset_tenant(self.state, t)
        if self.window is not None:
            self.window_state = self.window.reset_tenant(self.window_state, t)
        self._evicted.add(t)
        self.stats.evictions += 1
        if obs_rt.ENABLED:
            from repro_torch.obs import metrics as obs_metrics

            obs_metrics.counter("fleet.tenant.evictions").inc()

    def restore(self, tenant: int) -> None:
        """Load the latest eviction checkpoint back into the tenant's row.

        The stored spec must match the fleet's; the state row is restored
        bitwise and the version rewinds to the evicted one, so decodes
        cached before eviction become valid again.  For a windowed service a
        checkpointed bucket column re-enters the ring only if its slot still
        holds the tick it was saved under.
        """
        t = int(tenant)
        if t not in self._evicted:
            return
        ckpt = self._checkpointer(t)
        meta = ckpt.read_meta()
        like = self.engine.tenant_engine(t).init_state()
        has_window = "window_buckets" in meta
        if has_window != (self.window is not None):
            raise ValueError(
                f"tenant {t} checkpoint "
                + (
                    f"carries {meta.get('window_buckets')} window buckets "
                    "but this FleetService is not windowed"
                    if has_window
                    else "has no window buckets but this FleetService runs "
                    f"window_buckets={self.window.buckets}"
                )
            )
        if self.window is None:
            row = ckpt.restore(like)
        else:
            if int(meta["window_buckets"]) != self.window.buckets:
                raise ValueError(
                    f"tenant {t} checkpoint was written with "
                    f"window_buckets={meta['window_buckets']}, service runs "
                    f"{self.window.buckets}"
                )
            if float(meta["window_bucket_ticks"]) != self.window.bucket_ticks:
                raise ValueError(
                    f"tenant {t} checkpoint was written with "
                    f"window_bucket_ticks={meta['window_bucket_ticks']}, "
                    f"service runs {self.window.bucket_ticks}"
                )
            payload = ckpt.restore(
                {"row": like, "window": [like] * self.window.buckets}
            )
            row = payload["row"]
            column = list(self.window.tenant_column(self.window_state, t))
            for slot, tick in enumerate(meta["window_slot_tick"]):
                if int(tick) >= 0 and int(tick) == int(
                    self.window_state.slot_tick[slot]
                ):
                    column[slot] = payload["window"][slot]
            self.window_state = self.window.set_tenant_column(
                self.window_state, t, column
            )
        spec = self.engine.specs[t]
        stored = meta.get("freq_op_spec")
        if stored is not None and spec is not None:
            stored_spec = type(spec)(
                *[tuple(v) if isinstance(v, list) else v for v in stored]
            )
            if stored_spec != spec:
                raise ValueError(
                    f"tenant {t} checkpoint spec {stored_spec} does not match "
                    f"the fleet's {spec}"
                )
        if meta.get("quantized_bits") != self.engine.bits:
            raise ValueError(
                f"tenant {t} checkpoint was written at "
                f"{meta.get('quantized_bits')} bits, fleet runs "
                f"{self.engine.bits}"
            )
        if meta.get("decay") != self.engine.decay:
            raise ValueError(
                f"tenant {t} checkpoint was written with decay="
                f"{meta.get('decay')}, fleet runs decay={self.engine.decay}"
            )
        self.state = self.engine.set_tenant(self.state, t, row)
        self._versions[t] = int(meta.get("version", self.version(t)))
        self._evicted.discard(t)
        self.stats.restores += 1
        if obs_rt.ENABLED:
            from repro_torch.obs import metrics as obs_metrics

            obs_metrics.counter("fleet.tenant.restores").inc()

    @property
    def evicted(self) -> frozenset[int]:
        return frozenset(self._evicted)
