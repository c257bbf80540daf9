"""Multi-tenant fleet engine: thousands of sketch states as ONE stacked state
(counterpart of ``repro.core.fleet``, on one device).

A tenant's whole clustering state is its O(m) sketch accumulators plus the
O(1) ``FreqOpSpec`` its operator rebuilds from, so thousands of tenants fit
where one Lloyd-Max run would not.  :class:`FleetEngine` holds per-tenant
:class:`~repro_torch.core.engine.SketchEngineState` s **stacked along a
leading tenant axis** (``cos_acc (T, m)``, ``lower (T, n)``, ...) and runs
every monoid op over the whole stack at once.  The reference ``vmap`` s its
per-tenant trace; here the batch dimension is written out: the engine's
merge and finalize helpers are rank-generic, and a fleet's batch sums come
from the tenant-axis entries of kernels 1 and 3 (dense) or 4 and 5
(structured), one launch for the fleet
(``kernels.ops.fleet_fourier_sketch_sums``).

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

Tenant mesh: ``FleetEngine(sharding="mesh", mesh=tenant_mesh(p, ...))``
splits the tenant axis into p contiguous blocks of ``T / p`` rows, block s
on ``mesh.devices[s]``, under one controller, as the reference's
shard-mapped fleet does.  No torch tensor spans devices, so each block is an
ordinary ``sharding="none"`` fleet on its device, with its slice of the
stacked operator, the dither and the count cache, and the sharded state is a
:class:`FleetShards` of p stacked states.  Every method routes to the
owning blocks: ``update`` cuts a ``(T, B, n)`` batch by block (views on one
device) and moves each cut only to its owner; ``ingest`` partitions the
requests by owner, each tenant's in arrival order, so no scatter spans
blocks; the tenant surgery goes to the owner.  Nothing crosses devices on
the hot path and no ``torch.distributed`` call is made.  Each block runs the
single-device code above, so every row is bitwise the unsharded fleet's.
:func:`gather_rows` concatenates per-block states or outputs onto one device
where a caller wants the global view.  The reference's
``mesh_update_hlo`` (it reads XLA HLO) has no counterpart.
The reference's fleet has no telemetry hooks, and neither has this one.
"""

from __future__ import annotations

import dataclasses
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
    "FleetShards",
    "TenantMeshFleet",
    "fleet_specs",
    "fleet_quantizers",
    "gather_rows",
    "stack_operators",
]

# The per-tenant trace the fleet batches: the engine's single-device
# backend (the reference's fleet takes "xla" and "pallas", never "sharded":
# a fleet shards tenants, not rows).
FLEET_BACKENDS = ("kernel",)

# How the stacked state is placed: "none" keeps every tenant row on one
# device; "mesh" splits the tenant axis into contiguous blocks, one a device
# of a parallel.sharding.TenantMesh.
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
    sharding : ``"none"`` (every row on ``device``) or ``"mesh"`` (contiguous
        blocks of rows, one a device of ``mesh``; the engine is then a
        :class:`TenantMeshFleet`).
    mesh : with ``"mesh"``, a ``parallel.sharding.TenantMesh``; default
        ``tenant_mesh(tenant_shards, tenant_shard_axis)``, the first
        ``tenant_shards`` cards (every visible card when that is None too).
    tenant_shards : with ``"mesh"``, the block count; must match the mesh's
        ``tenant_shard_axis`` extent and divide the tenant count.
    tenant_shard_axis : the mesh axis the tenant axis maps onto
        (``SketchJobSpec.tenant_shard_axis``).
    device : with ``"none"``, where the stacked state, operators and dither
        live (default the CUDA card; raises without one unless
        ``device="cpu"``).  With ``"mesh"`` the mesh names the devices.
    """

    def __new__(cls, *args, sharding: str = "none", **kwargs):
        if cls is FleetEngine and sharding == "mesh":
            return super().__new__(TenantMeshFleet)
        return super().__new__(cls)

    def __init__(
        self,
        operators: Sequence[fo.FrequencyOperator | fo.FreqOpSpec],
        *,
        backend: str = "kernel",
        quantizers: Sequence[qz.SketchQuantizer] | None = None,
        decay: float | None = None,
        sharding: str = "none",
        mesh=None,
        tenant_shards: int | None = None,
        tenant_shard_axis: str = "tenant",
        device=None,
    ):
        self._check_args(operators, backend, decay, sharding, mesh, tenant_shards)
        self.device = dev_mod.resolve(device)
        self.devices = (self.device,)
        self.mesh = None
        self.tenant_shard_axis = str(tenant_shard_axis)
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
        self.sharding = "none"
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
    def _check_args(operators, backend, decay, sharding, mesh, tenant_shards) -> None:
        if backend not in FLEET_BACKENDS:
            raise ValueError(f"fleet backend must be one of {FLEET_BACKENDS}, got {backend!r}")
        if sharding not in FLEET_SHARDINGS:
            raise ValueError(f"fleet sharding must be one of {FLEET_SHARDINGS}, got {sharding!r}")
        if sharding == "none" and (mesh is not None or tenant_shards not in (None, 1)):
            raise ValueError("mesh=/tenant_shards= require FleetEngine(sharding='mesh')")
        if decay is not None and not 0.0 < float(decay) <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay!r}")
        if not operators:
            raise ValueError("a fleet needs at least one tenant operator")

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
        """The shard whose contiguous block holds ``tenant``'s row (0 on one
        device) — what ``serve.fleet_service`` partitions requests by."""
        t = int(tenant)
        if not 0 <= t < self.n_tenants:
            raise ValueError(f"tenant {t} out of range [0, {self.n_tenants})")
        return t // self.shard_rows

    def device_of(self, tenant: int) -> torch.device:
        """The device holding ``tenant``'s row, operator and dither."""
        return self.devices[self.owner_shard(tenant)]

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
        if isinstance(t, (int, float, np.integer, np.floating)):
            # A fill, not a copy: a copy from pageable host memory first waits
            # for the stream, which would serialise the host and the card.
            return torch.full((rows,), float(t), dtype=torch.float32, device=self.device)
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


@dataclasses.dataclass(frozen=True, eq=False)
class FleetShards:
    """Per-block values of a tenant-mesh fleet, block s on the mesh's device
    s: the stacked states of ``T / p`` rows each, or one output of
    ``finalize`` (``(T / p, 2m)`` z blocks, ...).  :func:`gather_rows` gives
    the global view."""

    blocks: tuple


def gather_rows(x, device):
    """``x``'s rows concatenated in tenant order onto ``device``: a
    :class:`FleetShards` of states gives one stacked state, of tensors one
    tensor; a tuple of them (``finalize``'s ``(z, lower, upper)``) a tuple.
    A one-device value is moved as it is.  For tests and callers that want
    the global view; the fleet's hot path never gathers."""
    dev = dev_mod.resolve(device)
    if isinstance(x, FleetShards):
        first = x.blocks[0]
        if isinstance(first, torch.Tensor):
            return torch.cat([b.to(dev) for b in x.blocks])
        return type(first)(*(torch.cat([leaf.to(dev) for leaf in leaves])
                             for leaves in zip(*x.blocks)))
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return tuple(gather_rows(v, dev) for v in x)
    return type(x)(*(leaf.to(dev) for leaf in x))


def _cut(x, lo: int, hi: int):
    """Rows ``[lo, hi)`` of a per-tenant argument (tensor, array or list; a
    slice of a tensor is a view); None stays None."""
    return None if x is None else x[lo:hi]


def _cut_tick(t, lo: int, hi: int):
    """A tick argument for rows ``[lo, hi)``: a scalar as it is, a per-row
    vector cut."""
    if t is None or (t.ndim if isinstance(t, torch.Tensor) else np.ndim(t)) == 0:
        return t
    return t[lo:hi]


def _permuted(x, perm: np.ndarray, on_device: dict):
    """``x`` (per-request: tensor, array or list; None stays None) in the
    order ``perm``; a tensor is gathered on its own device, where ``perm``
    is copied once (``on_device`` caches the copies)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        if x.device not in on_device:
            on_device[x.device] = torch.from_numpy(perm).to(x.device)
        return x[on_device[x.device]]
    if isinstance(x, np.ndarray):
        return x[perm]
    return [x[i] for i in perm.tolist()]


class TenantMeshFleet(FleetEngine):
    """``FleetEngine(sharding="mesh")``: p blocks of ``T / p`` contiguous
    tenant rows, block s an ordinary ``sharding="none"`` fleet on
    ``mesh.devices[s]`` (``blocks[s]``), under one controller.  States and
    ``finalize`` outputs are :class:`FleetShards`; every method routes to the
    owning blocks, and each block runs the single-device fleet's code, so
    row t is bitwise the unsharded fleet's row t."""

    def __init__(
        self,
        operators: Sequence[fo.FrequencyOperator | fo.FreqOpSpec],
        *,
        backend: str = "kernel",
        quantizers: Sequence[qz.SketchQuantizer] | None = None,
        decay: float | None = None,
        sharding: str = "mesh",
        mesh=None,
        tenant_shards: int | None = None,
        tenant_shard_axis: str = "tenant",
        device=None,
    ):
        from repro_torch.parallel.sharding import TenantMesh, axis_extent, tenant_mesh

        self._check_args(operators, backend, decay, sharding, mesh, tenant_shards)
        if sharding != "mesh":
            raise ValueError(f"a TenantMeshFleet takes sharding='mesh', got {sharding!r}")
        if device is not None:
            raise ValueError(
                "FleetEngine(sharding='mesh') places its blocks on the mesh's devices: pass "
                "mesh=tenant_mesh(p, devices=[...]) in place of device="
            )
        axis = self.tenant_shard_axis = str(tenant_shard_axis)
        if mesh is None:
            # Every visible card by default; with none, tenant_mesh(1) refuses.
            cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
            mesh = tenant_mesh(tenant_shards if tenant_shards is not None else max(cards, 1),
                               axis=axis)
        if not isinstance(mesh, TenantMesh):
            raise TypeError(
                f"the fleet's mesh is a parallel.sharding.TenantMesh (one controller, a "
                f"device a block), got {type(mesh).__name__}"
            )
        if axis not in mesh.mesh_dim_names:
            raise ValueError(
                f"mesh axes {mesh.mesh_dim_names} do not include the tenant shard axis {axis!r}"
            )
        p = axis_extent(mesh, (axis,))
        if tenant_shards is not None and int(tenant_shards) != p:
            raise ValueError(
                f"tenant_shards={tenant_shards} but the mesh's {axis!r} axis has {p} devices"
            )
        stacked = isinstance(operators, fo.StackedOperator)
        n_tenants = operators.tenants if stacked else len(operators)
        if n_tenants % p:
            raise ValueError(
                f"n_tenants={n_tenants} is not divisible by tenant_shards={p}; every shard "
                "must hold an equal contiguous block of tenant rows"
            )
        if quantizers is not None and len(quantizers) != n_tenants:
            raise ValueError(f"{len(quantizers)} quantizers for {n_tenants} tenants")
        rows = n_tenants // p
        blocks = []
        for s, dev in enumerate(mesh.devices):
            lo, hi = s * rows, (s + 1) * rows
            ops = (operators._replace(leaves=tuple(v[lo:hi] for v in operators.leaves))
                   if stacked else operators[lo:hi])
            blocks.append(FleetEngine(ops, backend=backend, quantizers=_cut(quantizers, lo, hi),
                                      decay=decay, device=dev))
        first = blocks[0]
        for s, blk in enumerate(blocks[1:], start=1):
            a, b = blk._stacked_op, first._stacked_op
            if (a.name, a.n, a.m) != (b.name, b.n, b.m) or [v.shape[1:] for v in a.leaves] != [
                    v.shape[1:] for v in b.leaves]:
                raise ValueError(
                    f"tenant {s * rows} operator leaves do not match tenant 0 "
                    "(all fleet tenants must share the operator family and (n, m))"
                )
            if blk.bits != first.bits:
                raise ValueError(
                    f"all fleet tenants must share a bit width, got {{{first.bits}, {blk.bits}}}")
        self.blocks = tuple(blocks)
        self.mesh = mesh
        self.devices = mesh.devices
        self.device = None  # no one device: see device_of
        self.specs = tuple(spec for blk in blocks for spec in blk.specs)
        self.n_tenants, self.n, self.m = n_tenants, first.n, first.m
        self.backend = backend
        self.sharding = "mesh"
        self.tenant_shards = p
        self.decay = first.decay
        self.bits = first.bits
        self.dither = None if first.dither is None else FleetShards(
            tuple(blk.dither for blk in blocks))

    @property
    def shard_rows(self) -> int:
        """Tenant rows per shard."""
        return self.n_tenants // self.tenant_shards

    def _owner(self, tenant: int) -> tuple[FleetEngine, int, int]:
        """``(block engine, shard, local row)`` of ``tenant``."""
        s = self.owner_shard(tenant)
        return self.blocks[s], s, int(tenant) - s * self.shard_rows

    def _bounds(self, s: int) -> tuple[int, int]:
        return s * self.shard_rows, (s + 1) * self.shard_rows

    def _check_sharded(self, state) -> None:
        if not isinstance(state, FleetShards) or len(state.blocks) != self.tenant_shards:
            raise TypeError(
                f"a tenant-mesh fleet's state is a FleetShards of {self.tenant_shards} blocks "
                f"(init_state or place_state), got {type(state).__name__}"
            )

    def place_state(self, state):
        """A one-device stacked state of T rows as the sharded state: rows
        ``[s·T/p, (s+1)·T/p)`` on device s (views where they already lie
        there).  A ``FleetShards`` has each block moved to its device."""
        if isinstance(state, FleetShards):
            self._check_sharded(state)
            return FleetShards(tuple(type(b)(*(leaf.to(dev) for leaf in b))
                                     for b, dev in zip(state.blocks, self.devices)))
        if state.count.shape[0] != self.n_tenants:
            raise ValueError(
                f"a stacked state of {state.count.shape[0]} rows for {self.n_tenants} tenants")
        return FleetShards(tuple(
            type(state)(*(leaf[lo:hi].to(dev) for leaf in state))
            for (lo, hi), dev in zip(map(self._bounds, range(self.tenant_shards)),
                                     self.devices)))

    # -- per-tenant views ---------------------------------------------------

    def operator(self, tenant: int) -> fo.FrequencyOperator:
        """Tenant's operator, on views of its block's stacked tensors."""
        blk, _, row = self._owner(tenant)
        return blk.operator(row)

    def quantizer(self, tenant: int) -> qz.SketchQuantizer | None:
        blk, _, row = self._owner(tenant)
        return blk.quantizer(row)

    def tenant_engine(self, tenant: int) -> eng_mod.SketchEngine:
        """Tenant's isolated ``SketchEngine``, on its owner's device."""
        blk, _, row = self._owner(tenant)
        return blk.tenant_engine(row)

    # -- stacked monoid ops, block by block ----------------------------------

    def init_state(self):
        return FleetShards(tuple(blk.init_state() for blk in self.blocks))

    def update(self, state, batches, weights=None, *, t=None):
        """``FleetEngine.update`` block by block: block s folds rows
        ``[s·T/p, (s+1)·T/p)`` of ``batches`` (a view of a tensor), moved
        only to its own device; one fleet launch a block."""
        if t is not None and self.decay is None:
            raise ValueError(
                "update(t=...) requires a decay-enabled fleet (FleetEngine(..., decay=gamma))"
            )
        self._check_sharded(state)
        if len(batches) != self.n_tenants:
            raise ValueError(
                f"batches must be (T, B, {self.n}) with T = {self.n_tenants}, got "
                f"{len(batches)} tenant batches"
            )
        out = []
        for s, (blk, st) in enumerate(zip(self.blocks, state.blocks)):
            lo, hi = self._bounds(s)
            out.append(blk.update(st, _cut(batches, lo, hi), _cut(weights, lo, hi),
                                  t=_cut_tick(t, lo, hi)))
        return FleetShards(tuple(out))

    def merge(self, a, b):
        self._check_sharded(a)
        self._check_sharded(b)
        return FleetShards(tuple(blk.merge(x, y)
                                 for blk, x, y in zip(self.blocks, a.blocks, b.blocks)))

    def finalize(self, state):
        """-> ``(z, lower, upper)``, each a ``FleetShards`` of the blocks'
        ``(T / p, ...)`` outputs on their devices."""
        self._check_sharded(state)
        outs = [blk.finalize(st) for blk, st in zip(self.blocks, state.blocks)]
        return tuple(FleetShards(tuple(o[i] for o in outs)) for i in range(3))

    def decay_to(self, state, t):
        if self.decay is None:
            raise ValueError(
                "decay_to requires a decay-enabled fleet (FleetEngine(..., decay=gamma))"
            )
        self._check_sharded(state)
        return FleetShards(tuple(
            blk.decay_to(st, _cut_tick(t, *self._bounds(s)))
            for s, (blk, st) in enumerate(zip(self.blocks, state.blocks))))

    # -- request routing ----------------------------------------------------

    def ingest(self, state, tenant_ids, batches, weights=None, *, t=None):
        """``FleetEngine.ingest`` by owner: the requests of block s (each
        tenant's in arrival order) fold into block s alone, so no scatter
        spans blocks.  Requests already grouped by owner (a shard-routed
        flush's) are cut into views; others are first grouped by one stable
        gather on the batches' device."""
        if t is not None and self.decay is None:
            raise ValueError(
                "ingest(t=...) requires a decay-enabled fleet (FleetEngine(..., decay=gamma))"
            )
        self._check_sharded(state)
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
        owners = ids_host // self.shard_rows
        tick_vector = t is not None and (
            t.ndim if isinstance(t, torch.Tensor) else np.ndim(t)) > 0
        if np.any(np.diff(owners) < 0):
            # Group the requests by owner (stable: each tenant's order is
            # kept) with one gather, so each block takes a contiguous run.
            perm, on_device = np.argsort(owners, kind="stable"), {}
            ids_host, owners = ids_host[perm], owners[perm]
            batches = _permuted(batches, perm, on_device)
            weights = _permuted(weights, perm, on_device)
            if tick_vector:
                t = _permuted(t, perm, on_device)
        bounds = np.searchsorted(owners, np.arange(self.tenant_shards + 1))
        out = list(state.blocks)
        for s in np.unique(owners).tolist():
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            out[s] = self.blocks[s].ingest(
                out[s], ids_host[lo:hi] - s * self.shard_rows, _cut(batches, lo, hi),
                _cut(weights, lo, hi), t=_cut_tick(t, lo, hi))
        return FleetShards(tuple(out))

    # -- tenant state surgery, on the owner -----------------------------------

    def tenant_state(self, state, tenant: int):
        self._check_sharded(state)
        blk, s, row = self._owner(tenant)
        return blk.tenant_state(state.blocks[s], row)

    def _with_block(self, state, s: int, block):
        blocks = list(state.blocks)
        blocks[s] = block
        return FleetShards(tuple(blocks))

    def set_tenant(self, state, tenant: int, row):
        """The sharded state with tenant's row replaced by ``row`` (moved to
        the owner's device); the other blocks are shared, not copied."""
        self._check_sharded(state)
        blk, s, r = self._owner(tenant)
        return self._with_block(state, s, blk.set_tenant(state.blocks[s], r, row))

    def reset_tenant(self, state, tenant: int):
        self._check_sharded(state)
        blk, s, r = self._owner(tenant)
        return self._with_block(state, s, blk.reset_tenant(state.blocks[s], r))

    def merge_tenant(self, state, tenant: int, partial):
        self._check_sharded(state)
        blk, s, r = self._owner(tenant)
        return self._with_block(state, s, blk.merge_tenant(state.blocks[s], r, partial))

    def finalize_tenant(self, state, tenant: int):
        self._check_sharded(state)
        blk, s, r = self._owner(tenant)
        return blk.finalize_tenant(state.blocks[s], r)

    def state_bytes(self) -> int:
        """Resident bytes of all p blocks' states."""
        return sum(blk.state_bytes() for blk in self.blocks)

    def __repr__(self) -> str:
        q = f", bits={self.bits}" if self.quantized else ""
        d = "" if self.decay is None else f", decay={self.decay}"
        devs = ", ".join(str(dev) for dev in self.devices)
        return (
            f"FleetEngine(T={self.n_tenants}, n={self.n}, m={self.m}, "
            f"backend={self.backend!r}{q}{d}, shards={self.tenant_shards}x{self.shard_rows}rows"
            f"(axis={self.tenant_shard_axis!r}), devices=[{devs}])"
        )
