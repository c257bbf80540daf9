"""Multi-tenant fleet engine: thousands of sketch states as ONE stacked state
(counterpart of ``repro.core.fleet``, on one device).

A tenant's whole clustering state is its O(m) sketch accumulators plus the
O(1) ``FreqOpSpec`` its operator rebuilds from, so thousands of tenants fit
where one Lloyd-Max run would not.  :class:`FleetEngine` holds per-tenant
:class:`~repro_torch.core.engine.SketchEngineState` s **stacked along a
leading tenant axis** (``cos_acc (T, m)``, ``lower (T, n)``, ...) and runs
every monoid op over the whole stack at once.  The reference ``vmap`` s its
per-tenant trace; here the batch dimension is written out: the engine's
merge and finalize helpers are rank-generic, and a dense fleet's batch sums
come from the tenant-axis entries of kernels 1 and 3, one launch for the
fleet (``kernels.ops.fleet_fourier_sketch_sums``).  A structured fleet
launches kernel 4 or 5 once per tenant.

Contract: for every tenant t, ``update``/``merge``/``finalize``/``ingest``
give **bitwise** the rows of an isolated
:class:`~repro_torch.core.engine.SketchEngine` over the same operator and
quantizer (``tenant_engine(t)``), on the CPU and on the card.  On the card
each tenant's kernel sums are bitwise those of its own launch (same grid,
same reduction order); the rest is elementwise tensor algebra, and the one
transcendental of the decayed merge is taken in float64 (``engine.
_decay_factor``) so the CPU's vector and scalar paths agree.

Request routing: :meth:`FleetEngine.ingest` folds interleaved
``(tenant_ids, batches)`` requests.  All partials come from one fleet call
over per-request operators gathered by tenant id.  With unique ids each
tenant row merges its one partial: gather the rows, merge, write them back.
Duplicate ids fold in arrival order, as the reference's ordered scan does:
the k-th request of every tenant merges in round k, and rounds run in
order, so each tenant's partials combine in exactly its isolated engine's
order.

Sharding: ``sharding="none"`` only; the reference's tenant mesh waits for
its own design over the port's process groups (ROADMAP Queue 1 item 16(c)).
The reference's fleet has no telemetry hooks, and neither has this one.
"""

from __future__ import annotations

import typing
from typing import Sequence

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.core import engine as eng_mod
from repro_torch.core import freq_ops as fo
from repro_torch.core import frequencies
from repro_torch.core import quantize as qz
from repro_torch.core.engine import (
    DecayedQuantizedSketchEngineState,
    DecayedSketchEngineState,
    QuantizedSketchEngineState,
    SketchEngineState,
)
from repro_torch.kernels import ops as kops

__all__ = [
    "FLEET_BACKENDS",
    "FLEET_SHARDINGS",
    "FleetEngine",
    "fleet_specs",
    "fleet_quantizers",
    "stack_operators",
]

# The per-tenant trace the fleet batches: the engine's single-device
# backend (the reference's fleet takes "xla" and "pallas", never "sharded":
# a fleet shards tenants, not rows).
FLEET_BACKENDS = ("kernel",)

# How the stacked state is placed: "none" keeps every tenant row on one
# device; "mesh" (the reference's tenant mesh) is not ported yet.
FLEET_SHARDINGS = ("none", "mesh")

_QUANTIZED_WEIGHTS = (
    "quantized fleet states accumulate unit-weight integer counts; per-point "
    "weights are not representable"
)


def fleet_specs(
    seed: int,
    n_tenants: int,
    name: str,
    m: int,
    n: int,
    sigma2,
    *,
    dist: str = "adapted_radius",
) -> list[fo.FreqOpSpec]:
    """Independent per-tenant operator specs from one parent seed.

    Tenant t draws from ``device.derive_seed(seed, t)`` (the counterpart of
    ``fold_in``) — the list a control plane ships and :class:`FleetEngine`
    rebuilds operators from.  Nothing is drawn here: a spec is its seed.
    """
    fo.get_freq_op(name)
    if dist not in typing.get_args(frequencies.FreqDist):
        raise ValueError(f"unknown frequency distribution {dist!r}")
    return [
        fo.FreqOpSpec(name, dev_mod.derive_seed(seed, t), int(m), int(n), float(sigma2), dist)
        for t in range(n_tenants)
    ]


def fleet_quantizers(
    seed: int, n_tenants: int, m: int, spec: str, device=dev_mod.DEFAULT
) -> list[qz.SketchQuantizer] | None:
    """Per-tenant quantizers (independent dither draws, tenant t's from a CPU
    generator seeded with ``derive_seed(seed, t)``, moved to ``device``), or
    None for float."""
    if qz.parse_bits(spec) is None:
        return None
    dev = dev_mod.resolve(device)
    out = []
    for t in range(n_tenants):
        q = qz.make_quantizer(dev_mod.generator(dev_mod.derive_seed(seed, t), torch.device("cpu")),
                              m, spec)
        out.append(qz.SketchQuantizer(q.bits, q.dither.to(dev)))
    return out


def _leaves(op: fo.FrequencyOperator) -> tuple[torch.Tensor, ...]:
    if isinstance(op, fo.DenseOperator):
        return (op.w,)
    if isinstance(op, fo.StructuredOperator):
        return (op.diags, op.radii, op.rho)
    raise TypeError(
        f"the fleet has no sketch kernel for {type(op).__name__} "
        "(operator families with kernels: 'dense', 'structured')"
    )


def stack_operators(ops: Sequence[fo.FrequencyOperator]) -> fo.StackedOperator:
    """Stack the tenants' operator tensors (float32, contiguous) along a new
    leading tenant axis; every tenant must share tenant 0's family,
    ``(n, m)`` and tensor shapes."""
    flat = [_leaves(op) for op in ops]
    for t, (op, leaves) in enumerate(zip(ops[1:], flat[1:]), start=1):
        if (type(op) is not type(ops[0]) or (op.n, op.m) != (ops[0].n, ops[0].m)
                or [v.shape for v in leaves] != [v.shape for v in flat[0]]):
            raise ValueError(
                f"tenant {t} operator leaves do not match tenant 0 "
                "(all fleet tenants must share the operator family and (n, m))"
            )
    stacked = tuple(torch.stack([v.to(torch.float32) for v in vs]) for vs in zip(*flat))
    return fo.StackedOperator(ops[0].name, ops[0].n, ops[0].m, stacked)


class FleetEngine:
    """T independent sketch engines as one stacked-state engine.

    Parameters
    ----------
    operators : per-tenant frequency operators **or** their ``FreqOpSpec`` s
        (rebuilt with ``freq_ops.from_spec``), or one ``StackedOperator``.
        All tenants share the family and ``(n, m)``.
    backend : one of ``FLEET_BACKENDS`` (the engine's ``"kernel"``).
    quantizers : optional per-tenant ``SketchQuantizer`` s (one dither row
        each, one bit width) — switches to the int32 state twin.
    decay : optional per-tick decay base gamma in (0, 1], shared by every
        tenant — switches to the timestamped decayed twin (stamps ``(T,)``).
    sharding : ``"none"``; ``"mesh"`` raises until the fleet's own mesh
        design is ported (ROADMAP Queue 1 item 16(c)).
    device : where the stacked state, operators and dither live (default
        the CUDA card; raises without one unless ``device="cpu"``).
    """

    def __init__(
        self,
        operators: Sequence[fo.FrequencyOperator | fo.FreqOpSpec],
        *,
        backend: str = "kernel",
        quantizers: Sequence[qz.SketchQuantizer] | None = None,
        decay: float | None = None,
        sharding: str = "none",
        device=dev_mod.DEFAULT,
    ):
        if backend not in FLEET_BACKENDS:
            raise ValueError(f"fleet backend must be one of {FLEET_BACKENDS}, got {backend!r}")
        if sharding not in FLEET_SHARDINGS:
            raise ValueError(f"fleet sharding must be one of {FLEET_SHARDINGS}, got {sharding!r}")
        if sharding == "mesh":
            raise NotImplementedError(
                "FleetEngine(sharding='mesh') is not ported: the tenant mesh needs its "
                "own design over process groups (ROADMAP Queue 1 item 16(c)); use "
                "sharding='none'"
            )
        if decay is not None and not 0.0 < float(decay) <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay!r}")
        if not operators:
            raise ValueError("a fleet needs at least one tenant operator")
        self.device = dev_mod.resolve(device)
        if isinstance(operators, fo.StackedOperator):
            self._stacked_op = operators._replace(leaves=tuple(
                v.to(self.device, torch.float32).contiguous() for v in operators.leaves))
            self.specs: tuple[fo.FreqOpSpec | None, ...] = (None,) * operators.tenants
        else:
            ops = [fo.from_spec(o, self.device) if isinstance(o, fo.FreqOpSpec)
                   else fo.as_operator(o).to(self.device) for o in operators]
            self.specs = tuple(self._try_spec(op) for op in ops)
            self._stacked_op = stack_operators(ops)
        self.n_tenants = self._stacked_op.tenants
        self.n, self.m = self._stacked_op.n, self._stacked_op.m
        self.backend = backend
        self.sharding = sharding
        self.tenant_shards = 1
        self.decay = None if decay is None else float(decay)
        self.bits: int | None = None
        self.dither: torch.Tensor | None = None
        if quantizers is not None:
            if len(quantizers) != self.n_tenants:
                raise ValueError(f"{len(quantizers)} quantizers for {self.n_tenants} tenants")
            bits = {q.bits for q in quantizers}
            if len(bits) != 1:
                raise ValueError(f"all fleet tenants must share a bit width, got {bits}")
            self.bits = bits.pop()
            self.dither = torch.stack(
                [q.dither.to(self.device, torch.float32) for q in quantizers])
            if tuple(self.dither.shape) != (self.n_tenants, self.m):
                raise ValueError(
                    f"stacked dither shape {tuple(self.dither.shape)} != "
                    f"{(self.n_tenants, self.m)}"
                )
        self._counts: dict[int, torch.Tensor] = {}

    @staticmethod
    def _try_spec(op: fo.FrequencyOperator) -> fo.FreqOpSpec | None:
        try:
            return op.spec()
        except ValueError:
            return None

    @property
    def quantized(self) -> bool:
        return self.bits is not None

    @property
    def shard_rows(self) -> int:
        """Tenant rows per shard (all of them on one device)."""
        return self.n_tenants

    def owner_shard(self, tenant: int) -> int:
        """The shard holding ``tenant``'s row (0 on one device)."""
        t = int(tenant)
        if not 0 <= t < self.n_tenants:
            raise ValueError(f"tenant {t} out of range [0, {self.n_tenants})")
        return t // self.shard_rows

    def place_state(self, state):
        """The stacked state on the fleet's placement: the identity on one
        device."""
        return state

    # -- per-tenant views ---------------------------------------------------

    def operator(self, tenant: int) -> fo.FrequencyOperator:
        """Tenant ``tenant``'s own operator, on views of the stacked tensors
        (bitwise the operator it was built from, with its spec)."""
        return self._stacked_op.tenant(tenant, self.specs[tenant])

    def quantizer(self, tenant: int) -> qz.SketchQuantizer | None:
        if self.bits is None:
            return None
        return qz.SketchQuantizer(bits=self.bits, dither=self.dither[tenant])

    def tenant_engine(self, tenant: int) -> eng_mod.SketchEngine:
        """A plain single-tenant ``SketchEngine`` over tenant's operator and
        quantizer — the reference this fleet is held to bitwise."""
        return eng_mod.SketchEngine(
            self.operator(tenant), self.backend, device=self.device,
            quantizer=self.quantizer(tenant), decay=self.decay,
        )

    # -- stacked monoid ops -------------------------------------------------

    def init_state(self):
        """Stacked monoid identity: every tenant row is ``init_state()``."""
        t, n, m, f32, dev = self.n_tenants, self.n, self.m, torch.float32, self.device
        acc = torch.int32 if self.quantized else f32
        rest = dict(
            weight_sum=torch.zeros((t,), dtype=f32, device=dev),
            lower=torch.full((t, n), float("inf"), dtype=f32, device=dev),
            upper=torch.full((t, n), float("-inf"), dtype=f32, device=dev),
            count=torch.zeros((t,), dtype=f32, device=dev),
        )
        zeros = [torch.zeros((t, m), dtype=acc, device=dev) for _ in range(2)]
        cls = QuantizedSketchEngineState if self.quantized else SketchEngineState
        base = cls(*zeros, **rest)
        if self.decay is not None:
            base = self._lift_parts(base, torch.full((t,), float("-inf"), dtype=f32, device=dev))
        return base

    def _lift_parts(self, parts, stamps: torch.Tensor):
        """Stacked base partials as decayed states stamped ``stamps`` (one
        tick per row), as ``SketchEngine._lift_partial`` does per state."""
        gamma = torch.full_like(stamps, self.decay)
        if isinstance(parts, QuantizedSketchEngineState):
            return DecayedQuantizedSketchEngineState(
                qcos_acc=parts.qcos_acc,
                qsin_acc=parts.qsin_acc,
                dcos_acc=torch.zeros_like(parts.qcos_acc, dtype=torch.float32),
                dsin_acc=torch.zeros_like(parts.qsin_acc, dtype=torch.float32),
                weight_sum=parts.weight_sum, lower=parts.lower, upper=parts.upper,
                count=parts.count, stamp=stamps, gamma=gamma,
            )
        return DecayedSketchEngineState(*parts, stamp=stamps, gamma=gamma)

    def _count(self, rows: int, b: int) -> torch.Tensor:
        """``(rows,)`` float32 filled with ``b``: the isolated engine's
        ``count``, made once per shape."""
        key = (rows, b)
        if key not in self._counts:
            self._counts[key] = torch.full((rows,), float(b), dtype=torch.float32,
                                           device=self.device)
        return self._counts[key]

    def _parts(self, op: fo.StackedOperator, dither, x, weights):
        """Per-row partial states of ``x (R, B, n)`` against the stacked
        operator ``op`` (R rows) — what each row's isolated engine's
        ``_partial_state`` gives."""
        if isinstance(x, (list, tuple)):
            x = torch.stack([torch.as_tensor(b, dtype=torch.float32).to(self.device) for b in x])
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device).contiguous()
        if x.ndim != 3 or x.shape[-1] != self.n:
            raise ValueError(f"batches must be (T, B, {self.n}), got {tuple(x.shape)}")
        rows, b = x.shape[:2]
        lower, upper = torch.amin(x, dim=1), torch.amax(x, dim=1)
        count = self._count(rows, b)
        if self.quantized:
            if weights is not None:
                raise ValueError(_QUANTIZED_WEIGHTS)
            qcos, qsin = kops.quantized_fleet_fourier_sketch_sums(x, op, dither, self.bits)
            return QuantizedSketchEngineState(qcos, qsin, count, lower, upper, count)
        if weights is None:
            beta = torch.ones((rows, b), dtype=torch.float32, device=self.device)
            # b ones sum to exactly b in any order below 2^24: the isolated
            # engine's torch.sum of its unit weights.
            wsum = count if b <= 1 << 24 else torch.stack([torch.sum(r) for r in beta])
        else:
            beta = torch.as_tensor(weights, dtype=torch.float32).to(self.device)
            beta = beta.reshape(rows, b).contiguous()
            # Row by row: a reduction over a (rows, b) block may sum in
            # another order than the isolated engine's torch.sum of (b,).
            wsum = torch.stack([torch.sum(r) for r in beta])
        cos_s, sin_s = kops.fleet_fourier_sketch_sums(x, op, beta)
        return SketchEngineState(cos_s, sin_s, wsum, lower, upper, count)

    def _stamps(self, state, t, rows: int) -> torch.Tensor:
        """Per-row ticks: ``t`` (scalar or ``(rows,)``), or for ``t=None``
        each row's current stamp (the identity's ``-inf`` resolving to 0)."""
        if t is None:
            return torch.where(torch.isfinite(state.stamp), state.stamp,
                               torch.zeros_like(state.stamp))
        t = torch.as_tensor(t, dtype=torch.float32).to(self.device)
        return torch.broadcast_to(t, (rows,)).contiguous()

    def update(self, state, batches, weights=None, *, t=None):
        """Fold one aligned block ``batches (T, B, n)`` — one batch per tenant
        — into the stacked state; row t is bitwise what
        ``tenant_engine(t).update`` gives.  Under ``decay``, ``t`` is the
        block's tick (scalar or ``(T,)``); ``t=None`` reuses each row's
        stamp (empty rows resolve to tick 0)."""
        if t is not None and self.decay is None:
            raise ValueError(
                "update(t=...) requires a decay-enabled fleet (FleetEngine(..., decay=gamma))"
            )
        parts = self._parts(self._stacked_op, self.dither, batches, weights)
        if self.decay is not None:
            parts = self._lift_parts(parts, self._stamps(state, t, self.n_tenants))
        return eng_mod._merge_states(state, parts)

    def merge(self, a, b):
        """Stacked associative + commutative combine (the engine's merge on
        ``(T, ...)`` leaves)."""
        return eng_mod._merge_states(a, b)

    def finalize(self, state):
        """-> ``(z (T, 2m), lower (T, n), upper (T, n))``, all tenants."""
        if self.quantized:
            self._check_capacity(state)
            return eng_mod._finalize_quantized(state, self.dither, self.bits)
        return eng_mod._finalize_state(state)

    def _check_capacity(self, state) -> None:
        if not self.quantized:
            return
        cap = qz.accumulator_capacity(self.bits)
        most = float(torch.max(state.count))
        if most > cap:
            raise ValueError(
                f"quantized fleet accumulators overflow: a tenant folded {most:.0f} points "
                f"at {self.bits} bits, over the int32 capacity of {cap}"
            )

    # -- request routing ----------------------------------------------------

    def ingest(self, state, tenant_ids, batches, weights=None, *, t=None):
        """Fold interleaved requests ``(tenant_ids (R,), batches (R, B, n))``
        into the stacked state; every tenant row is bitwise its isolated
        engine's sequential ``update`` over its requests in arrival order.

        All partials come from one fleet call over the operators gathered by
        tenant id.  Unique ids: each row merges its one partial.  Duplicate
        ids: the k-th request of every tenant merges in round k, rounds in
        order.  Under ``decay``, ``t`` is the requests' tick (scalar or
        ``(R,)``); ``t=None`` stamps each request with its row's clock at
        the moment it merges (empty rows -> tick 0).
        """
        if t is not None and self.decay is None:
            raise ValueError(
                "ingest(t=...) requires a decay-enabled fleet (FleetEngine(..., decay=gamma))"
            )
        ids_host = np.asarray(
            tenant_ids.cpu() if isinstance(tenant_ids, torch.Tensor) else tenant_ids
        ).astype(np.int64)
        n_req = len(batches)
        if ids_host.ndim != 1 or ids_host.shape[0] != n_req or n_req == 0:
            raise ValueError(
                f"tenant_ids {ids_host.shape} must be (R,) matching {n_req} batches, R >= 1"
            )
        if ids_host.min() < 0 or ids_host.max() >= self.n_tenants:
            raise ValueError(f"tenant ids must lie in [0, {self.n_tenants})")
        ids = torch.from_numpy(ids_host).to(self.device)
        dither = None if self.dither is None else self.dither[ids]
        parts = self._parts(self._stacked_op.take(ids), dither, batches, weights)
        if self.decay is not None:
            # nan = "stamp me with my row's clock", resolved as each request
            # merges (-inf cannot be the sentinel: a non-empty partial
            # stamped -inf would decay to nothing on merge).
            stamps = (torch.full((n_req,), float("nan"), device=self.device) if t is None
                      else self._stamps(state, t, n_req))
            parts = self._lift_parts(parts, stamps)
        if len(np.unique(ids_host)) == n_req:
            return self._scatter_parts(state, ids, parts)
        return self._scan_parts(state, ids_host, parts)

    def _scan_parts(self, state, ids_host: np.ndarray, parts):
        """Arrival-order fold for duplicate ids: round k merges every
        tenant's k-th request (ids unique within a round), rounds in order,
        so each tenant's partials combine in its isolated engine's order."""
        rank = np.zeros(len(ids_host), np.int64)
        seen: dict[int, int] = {}
        for r, tid in enumerate(ids_host.tolist()):
            rank[r] = seen.get(tid, 0)
            seen[tid] = rank[r] + 1
        for k in range(int(rank.max()) + 1):
            sel = torch.from_numpy(np.flatnonzero(rank == k)).to(self.device)
            ids = torch.from_numpy(ids_host).to(self.device)[sel]
            state = self._scatter_parts(state, ids, type(parts)(*(leaf[sel] for leaf in parts)))
        return state

    @staticmethod
    def _scatter_parts(state, ids: torch.Tensor, parts):
        """Merge one partial into each of the rows ``ids`` (unique): gather
        the rows, merge them with the engine's merge, write them back, so
        each row gets exactly its isolated engine's merge."""
        rows = type(state)(*(leaf[ids] for leaf in state))
        if isinstance(parts, eng_mod.DECAYED_STATE_TYPES):
            clock = torch.where(torch.isfinite(rows.stamp), rows.stamp,
                                torch.zeros_like(rows.stamp))
            parts = parts._replace(stamp=torch.where(torch.isnan(parts.stamp), clock, parts.stamp))
        merged = eng_mod._merge_states(rows, parts)
        return type(state)(*(leaf.index_copy(0, ids, m) for leaf, m in zip(state, merged)))

    def decay_to(self, state, t):
        """Advance every tenant's clock to tick ``t`` (scalar or ``(T,)``)
        without folding data: a merge with stamped identities, row for row
        ``SketchEngine.decay_to``."""
        if self.decay is None:
            raise ValueError(
                "decay_to requires a decay-enabled fleet (FleetEngine(..., decay=gamma))"
            )
        empty = self.init_state()
        return eng_mod._merge_states(
            state, empty._replace(stamp=self._stamps(empty, t, self.n_tenants)))

    # -- tenant state surgery -----------------------------------------------

    def tenant_state(self, state, tenant: int):
        """Tenant ``tenant``'s row as a single-engine state (views of the
        stacked tensors; the fleet never writes a state in place)."""
        return type(state)(*(leaf[tenant] for leaf in state))

    def set_tenant(self, state, tenant: int, row):
        """The stacked state with tenant's row replaced by ``row``."""
        out = []
        for leaf, r in zip(state, row):
            leaf = leaf.clone()
            leaf[tenant] = torch.as_tensor(r, dtype=leaf.dtype).to(leaf.device)
            out.append(leaf)
        return type(state)(*out)

    def reset_tenant(self, state, tenant: int):
        """Tenant's row back to the monoid identity (post-eviction hole)."""
        return self.set_tenant(state, tenant, self.tenant_engine(tenant).init_state())

    def merge_tenant(self, state, tenant: int, partial):
        """Fold an externally produced partial into one tenant's row:
        ``row <- merge(row, partial)``."""
        row = self.tenant_state(state, tenant)
        return self.set_tenant(state, tenant, eng_mod._merge_states(row, partial))

    def finalize_tenant(self, state, tenant: int):
        """Finalize ONE tenant — O(m), the decode-on-demand path."""
        row = self.tenant_state(state, tenant)
        if self.quantized:
            self._check_capacity(state)
            return eng_mod._finalize_quantized(row, self.dither[tenant], self.bits)
        return eng_mod._finalize_state(row)

    def state_bytes(self) -> int:
        """Resident bytes of the stacked fleet state (all T tenants)."""
        return sum(leaf.numel() * leaf.element_size() for leaf in self.init_state())

    def __repr__(self) -> str:
        q = f", bits={self.bits}" if self.quantized else ""
        d = "" if self.decay is None else f", decay={self.decay}"
        return (
            f"FleetEngine(T={self.n_tenants}, n={self.n}, m={self.m}, "
            f"backend={self.backend!r}{q}{d}, device={str(self.device)!r})"
        )
