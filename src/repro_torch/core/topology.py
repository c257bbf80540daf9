"""Pluggable reduction topologies for the SketchEngine's monoid ``merge``
(counterpart of ``repro.core.topology``).

The engine's contract (``core/engine.py``) is that partial sketch states form
a commutative monoid: any merge schedule — flat all-reduce, binary tree,
ring token passing, stragglers folded in whenever they arrive — yields the
same finalized sketch.  This module makes the schedule a registered object:

- **host level** — :func:`reduce_states` folds a list of partial states with
  the engine's ``merge`` following a named schedule; :class:`StragglerMerger`
  is the online variant that absorbs partials in arrival order.  The plans
  are the reference's, copied exactly.
- **device level** — :func:`axis_reduce` is the collective the sharded
  backend calls, over the process groups of a ``torch.distributed``
  ``DeviceMesh``'s named axes: ``allreduce`` is ``dist.all_reduce``,
  ``tree`` a butterfly of pairwise exchanges (``batch_isend_irecv``),
  ``ring`` token passing around the axis.  The port is SPMD, one process
  per device: each rank reduces its own partial, and every rank ends with
  the same bits (the counterpart of ``shard_map``'s replicated output).

Numerics: integer states (the quantized path) reduce bitwise identically
under every topology.  Float states agree to roundoff: the schedules
re-associate sums.  Within one reduction every rank holds the same bits:
``allreduce`` and the butterfly give them by construction (partners combine
the same two operands, and IEEE addition is commutative); the ring's ranks
fold in different rotations, so it ends with a broadcast from the axis's
rank 0, as the reference's unchecked ``out_specs=P()`` reads device 0's copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "Topology",
    "TOPOLOGIES",
    "register_topology",
    "get_topology",
    "available_topologies",
    "merge_schedule",
    "reduce_states",
    "StragglerMerger",
    "axis_reduce",
    "axis_broadcast",
    "wire_cost_model",
    "fleet_wire_cost_model",
]

# Elementwise combine ops a reduction may carry.  "sum" is the monoid's
# accumulator add; "min"/"max" merge the box bounds harvested in the same pass.
_COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}
_REDUCE_OP = {
    torch.add: dist.ReduceOp.SUM,
    torch.minimum: dist.ReduceOp.MIN,
    torch.maximum: dist.ReduceOp.MAX,
}


@dataclasses.dataclass(frozen=True)
class Topology:
    """A named merge schedule.

    ``plan(n)`` returns the host-level schedule as rounds of ``(dst, src)``
    merges over ``n`` partial states: within a round, merges touch disjoint
    states; ``dst`` accumulates ``src`` and the result ends up at
    ``root(n)``.  ``device_reduce(x, group, combine)`` performs the
    equivalent collective over one process group and returns the result,
    the same bits on every rank of the group, without writing ``x``.
    """

    name: str
    plan: Callable[[int], list[list[tuple[int, int]]]]
    device_reduce: Callable[[torch.Tensor, Any, Callable], torch.Tensor]
    root: Callable[[int], int] = lambda n: 0


TOPOLOGIES: dict[str, Topology] = {}


def register_topology(topo: Topology) -> Topology:
    """Add a topology to the registry (name collisions are an error)."""
    if topo.name in TOPOLOGIES:
        raise ValueError(f"topology {topo.name!r} already registered")
    TOPOLOGIES[topo.name] = topo
    return topo


def get_topology(name: str) -> Topology:
    if name not in TOPOLOGIES:
        raise ValueError(
            f"unknown reduce topology {name!r}; registered: "
            f"{available_topologies()}"
        )
    return TOPOLOGIES[name]


def available_topologies() -> tuple[str, ...]:
    return tuple(sorted(TOPOLOGIES))


# ---------------------------------------------------------------------------
# Host-level plans
# ---------------------------------------------------------------------------


def _flat_plan(n: int) -> list[list[tuple[int, int]]]:
    """All-reduce stand-in on the host: one accumulator, everyone folds in."""
    return [[(0, i)] for i in range(1, n)]


def _tree_plan(n: int) -> list[list[tuple[int, int]]]:
    """Balanced binary tree: ceil(log2 n) rounds of disjoint pairwise merges."""
    rounds: list[list[tuple[int, int]]] = []
    step = 1
    while step < n:
        rnd = [
            (dst, dst + step)
            for dst in range(0, n - step, 2 * step)
        ]
        if rnd:
            rounds.append(rnd)
        step *= 2
    return rounds


def _ring_plan(n: int) -> list[list[tuple[int, int]]]:
    """Token passing: rank i hands its accumulated token to rank i+1."""
    return [[(i + 1, i)] for i in range(n - 1)]


def merge_schedule(n: int, topology: str) -> list[list[tuple[int, int]]]:
    """The host-level schedule ``topology`` uses to reduce ``n`` partials."""
    if n < 1:
        raise ValueError(f"need at least one partial state, got n={n}")
    return get_topology(topology).plan(n)


def reduce_states(
    merge: Callable[[Any, Any], Any],
    states: Sequence[Any],
    topology: str = "allreduce",
    order: Sequence[int] | None = None,
) -> Any:
    """Fold partial states with ``merge`` following a named schedule.

    ``order`` optionally permutes the states first — the arrival order of
    delayed stragglers.  By the monoid laws every (topology, order) pair
    produces the same result: bitwise for integer states, to roundoff for
    float.
    """
    states = list(states)
    if order is not None:
        if sorted(order) != list(range(len(states))):
            raise ValueError(f"order must permute range({len(states)})")
        states = [states[i] for i in order]
    if not states:
        raise ValueError("need at least one partial state")
    topo = get_topology(topology)
    slots: list[Any] = list(states)
    for rnd in topo.plan(len(states)):
        for dst, src in rnd:
            slots[dst] = merge(slots[dst], slots[src])
    return slots[topo.root(len(states))]


class StragglerMerger:
    """Online, arrival-order fold — the straggler-tolerant merge.

    Partial states are absorbed the moment they arrive (``add``), in any
    order, and the result is the same monoid reduction.  ``identity`` is the
    engine's ``init_state()``.
    """

    def __init__(self, merge: Callable[[Any, Any], Any], identity: Any):
        self._merge = merge
        self._acc = identity
        self.arrived = 0

    def add(self, state: Any) -> "StragglerMerger":
        self._acc = self._merge(self._acc, state)
        self.arrived += 1
        return self

    def result(self) -> Any:
        return self._acc


# ---------------------------------------------------------------------------
# Device-level collectives over a process group
# ---------------------------------------------------------------------------


def _exchange(x: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send ``x`` to group rank ``to`` and return the tensor received from
    group rank ``frm`` (same shape and dtype).

    Gloo's point-to-point ops read and write host memory only (handed a
    CUDA tensor, its TCP transport fails with "Bad address"), so on a gloo
    group a CUDA operand travels through a host copy; gloo's ``all_reduce``
    and ``broadcast`` stage CUDA tensors themselves.  NCCL sends device
    memory.
    """
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    out = (x.cpu() if staged else x).contiguous()
    buf = torch.empty_like(out)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, out, dist.get_global_rank(group, to), group),
        dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, frm), group),
    ])
    for req in reqs:
        req.wait()
    return buf.to(x.device) if staged else buf


def _allreduce_device(x: torch.Tensor, group, combine) -> torch.Tensor:
    out = x.clone()  # all_reduce works in place; the caller's tensor stays
    dist.all_reduce(out, op=_REDUCE_OP[combine], group=group)
    return out


def _tree_device(x: torch.Tensor, group, combine) -> torch.Tensor:
    """Butterfly (recursive doubling): log2 p pairwise exchanges.

    Every step XORs the partner index, so all ranks take part in every hop
    and partners combine the same two operands: the same bits everywhere,
    for min/max bound merges as for sums.
    """
    p = dist.get_world_size(group)
    if p & (p - 1):
        raise ValueError(
            f"tree (butterfly) reduction needs a power-of-two axis size, got "
            f"{p}; use 'ring' or 'allreduce' for this mesh"
        )
    rank = dist.get_rank(group)
    step = 1
    while step < p:
        peer = rank ^ step
        x = combine(x, _exchange(x, peer, peer, group))
        step *= 2
    return x


def _ring_device(x: torch.Tensor, group, combine) -> torch.Tensor:
    """Ring token passing: p-1 neighbour hops, each carries the running fold.

    Unchunked (the whole state is the token): per-rank traffic is (p-1)·S;
    see :func:`wire_cost_model`.  Each rank's fold is a different rotation
    of the operands, so float sums differ in the last bits across ranks:
    the ring ends with a broadcast of group rank 0's fold.
    """
    p = dist.get_world_size(group)
    if p == 1:
        return x
    rank = dist.get_rank(group)
    acc = x
    for _ in range(p - 1):
        acc = combine(_exchange(acc, (rank + 1) % p, (rank - 1) % p, group), x)
    return _broadcast(acc, group)


def _broadcast(x: torch.Tensor, group) -> torch.Tensor:
    """Group rank 0's ``x`` on every rank of ``group`` (a new tensor)."""
    out = x.clone()
    dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
    return out


register_topology(
    Topology("allreduce", _flat_plan, _allreduce_device)
)
register_topology(Topology("tree", _tree_plan, _tree_device))
register_topology(
    Topology("ring", _ring_plan, _ring_device, root=lambda n: n - 1)
)


def _axes(axis_names: Sequence[str] | str) -> tuple[str, ...]:
    return (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)


def axis_reduce(
    x: torch.Tensor,
    mesh,
    axis_names: Sequence[str] | str,
    topology: str = "allreduce",
    op: str = "sum",
) -> torch.Tensor:
    """Reduce this rank's ``x`` over the ``mesh`` axes ``axis_names``.

    The counterpart of the reference's in-``shard_map`` ``axis_reduce``:
    ``mesh`` is a ``torch.distributed`` ``DeviceMesh``, each axis name maps
    to ``mesh.get_group(name)``, and ``op`` is ``"sum"``, ``"min"`` or
    ``"max"``.  Several axes reduce one after another, one collective per
    axis — a ``("pod", "data")`` reduction is a within-pod pass followed by
    a cross-pod pass, the hierarchical schedule.  Returns the same bits on
    every rank; ``x`` itself is never written (a one-rank ``tree`` or
    ``ring`` returns it as it is).
    """
    if op not in _COMBINE:
        raise ValueError(f"op must be one of {sorted(_COMBINE)}, got {op!r}")
    topo = get_topology(topology)
    for ax in _axes(axis_names):
        x = topo.device_reduce(x, mesh.get_group(ax), _COMBINE[op])
    return x


def axis_broadcast(x: torch.Tensor, mesh, axis_names: Sequence[str] | str) -> torch.Tensor:
    """The ``x`` of the rank at coordinate 0 of every axis in ``axis_names``,
    on every rank: one broadcast per axis, each from the axis's rank 0.
    Returns a new tensor (``x`` is not written).  The port's own helper,
    for what the reference's single controller holds once: the sigma^2
    sample and the decoded centroids (``core/ckm.py``)."""
    for ax in _axes(axis_names):
        x = _broadcast(x, mesh.get_group(ax))
    return x


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------


def wire_cost_model(state_bytes: int, p: int, topology: str) -> dict:
    """Per-device bytes sent and serialized hop count for a p-way merge.

    The alpha-beta model of one S-byte monoid state reduced over p links:

    ==========  =======================  ==================
    topology    bytes sent / device      serialized hops
    ==========  =======================  ==================
    allreduce   2·S·(p-1)/p              2·(p-1)   (ring reduce-scatter + all-gather)
    tree        S·log2(p)                log2(p)
    ring        S·(p-1)                  p-1       (unchunked token)
    ==========  =======================  ==================
    """
    get_topology(topology)  # validate the name
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    if p == 1:
        return {"topology": topology, "p": 1, "bytes_per_device": 0, "hops": 0}
    if topology == "allreduce":
        bytes_dev = 2.0 * state_bytes * (p - 1) / p
        hops = 2 * (p - 1)
    elif topology == "tree":
        hops = max(1, math.ceil(math.log2(p)))
        bytes_dev = float(state_bytes * hops)
    elif topology == "ring":
        bytes_dev = float(state_bytes * (p - 1))
        hops = p - 1
    else:  # a user-registered topology: no closed form — report unknowns
        return {"topology": topology, "p": p, "bytes_per_device": None,
                "hops": None}
    return {
        "topology": topology,
        "p": p,
        "bytes_per_device": bytes_dev,
        "hops": hops,
    }


def fleet_wire_cost_model(
    row_bytes: int,
    n_tenants: int,
    tenant_shards: int,
    topology: str = "tree",
) -> dict:
    """Wire cost of a tenant-sharded fleet's data paths.

    Every tenant's whole state lives on one shard, so the serving hot path
    (update / ingest / finalize) moves zero bytes between shards
    (``steady_state_bytes``).  What remains is the control plane, per tenant
    row of ``row_bytes``: a checkpoint moves one row between the host and
    its owning shard (``checkpoint_bytes``, one hop); a broadcast to every
    shard is the reverse of ``merge_schedule``'s plan — each of the
    ``p - 1`` non-root shards receives the row once, over the plan's rounds.
    ``rows_per_shard`` / ``shard_state_bytes`` give the residency of the
    contiguous-block placement.
    """
    get_topology(topology)  # validate the name
    p = int(tenant_shards)
    if p < 1:
        raise ValueError(f"tenant_shards must be >= 1, got {tenant_shards}")
    if n_tenants < 1 or n_tenants % p:
        raise ValueError(
            f"n_tenants={n_tenants} must be a positive multiple of "
            f"tenant_shards={p} (contiguous equal blocks per shard)"
        )
    rows = n_tenants // p
    return {
        "topology": topology,
        "tenant_shards": p,
        "rows_per_shard": rows,
        "row_bytes": int(row_bytes),
        "shard_state_bytes": int(row_bytes) * rows,
        "steady_state_bytes": 0,
        "checkpoint_bytes": int(row_bytes),
        "checkpoint_hops": 1,
        "broadcast_bytes_total": float(row_bytes * (p - 1)),
        "broadcast_hops": len(merge_schedule(p, topology)) if p > 1 else 0,
    }
