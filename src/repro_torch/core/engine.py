"""Streaming, mergeable SketchEngine — counterpart of ``repro.core.engine``
(float and quantized states, one backend).

The sketch is a *linear* summary, so its partial sums form a commutative
monoid: any split of the data over batches and any order of combining the
partials give the same sketch.

``SketchEngineState(cos_acc, sin_acc, weight_sum, lower, upper, count)``:

- identity:   ``init_state()`` (zero sums, ``+inf/-inf`` bounds),
- ``update``: fold one weighted batch into a state (one pass, O(m) memory),
- ``merge``:  elementwise combine — associative and commutative,
- ``finalize``: ``z = [sum b cos, -sum b sin] / sum b`` plus the CLOMPR box
  bounds ``(lower, upper)`` harvested in the same pass.

Quantized states (QCKM): ``SketchEngine(quantizer=...)`` (a
``core.quantize.SketchQuantizer``) swaps the state for
``QuantizedSketchEngineState``, whose trig accumulators hold **int32 sums of
the universal-quantization codes** of the dithered phases.  The monoid is the
same (identity zeros, merge elementwise add/min/max), now exact: integer sums
make merge bitwise associative and commutative and any split of the data
bitwise invariant.  Only unit weights are representable (weights raise), and
``finalize`` checks the folded count against the int32 capacity
(``quantize.accumulator_capacity``) before it dequantizes.

Backend: ``"kernel"`` — the batch sums go through ``kernels.ops``, which runs
the fused CUDA kernel of the operator's family (dense or structured, float or
quantized) on a CUDA tensor and its plain PyTorch version on a CPU tensor.
It is the counterpart of the reference's ``"pallas"`` backend.  An operator
family with no kernel is refused when the engine is built.

Backend ``"sharded"`` (``mesh=``, a ``torch.distributed`` ``DeviceMesh``):
SPMD, one process per device.  Each rank passes its own rows to ``update``
(``shard_points`` cuts this rank's block out of a global batch), sketches
them through the same kernels, and the partial's sums, weight, count and
bounds are reduced over ``data_axes`` with ``core.topology.axis_reduce``
under ``reduce_topology``: the engine's ``merge`` as a collective.  The
reduced partial is the same on every rank (the counterpart of the
reference's replicated ``out_specs=P()``), and a quantized partial reduces
its int32 code sums as integers.  A rank may hold no rows: it contributes
the identity and still joins every collective.  There is no padding: the
reference pads ragged batches for ``shard_map``, the port splits them.

Decayed states: ``SketchEngine(decay=gamma)`` (0 < gamma <= 1) swaps the
state for its time-decayed twin.  Each state carries ``stamp``, the tick of
its newest contribution (``-inf`` for the identity), and merging scales the
older operand's trig and weight sums by ``gamma**dt`` first, so the
finalized sketch is ``sum_i gamma**(T - t_i) part_i / sum_i gamma**(T - t_i)
w_i``.  Same-stamp merges are bitwise the undecayed merge (every factor is
exactly 1.0).  On the quantized twin the int32 code sums are never scaled:
the newest-stamp segment stays an exact integer sum and decay moves older
segments into float ``dcos_acc``/``dsin_acc``.  Bounds and ``count`` stay
lifetime.  The batch partial still comes from the kernel (1, 3, 4 or 5); the
decay is plain tensor algebra on (m,) vectors.

Telemetry: with ``repro_torch.obs`` enabled, ``update``, ``merge`` and
``finalize`` record spans and the ``engine.*`` counters; disabled, they run
no telemetry code at all.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch import device as dev_mod
from repro_torch.core import freq_ops as fo
from repro_torch.core import quantize as qz
from repro_torch.core import topology as topo
from repro_torch.kernels import ops as kops
from repro_torch.obs import runtime as obs_rt
from repro_torch.parallel.sharding import axis_extent

__all__ = [
    "SketchEngineState",
    "QuantizedSketchEngineState",
    "DecayedSketchEngineState",
    "DecayedQuantizedSketchEngineState",
    "SketchEngine",
    "BACKENDS",
]

BACKENDS = ("kernel", "sharded")


class SketchEngineState(NamedTuple):
    """Commutative-monoid accumulator of the one-pass sketch statistics."""

    cos_acc: torch.Tensor  # (m,) f32 — sum_l beta_l cos(w^T y_l), unnormalised
    sin_acc: torch.Tensor  # (m,) f32 — sum_l beta_l sin(w^T y_l), unnormalised
    weight_sum: torch.Tensor  # () f32 — sum of weights folded in so far
    lower: torch.Tensor  # (n,) f32 — running per-coordinate min
    upper: torch.Tensor  # (n,) f32 — running per-coordinate max
    count: torch.Tensor  # () f32 — number of points folded in


class QuantizedSketchEngineState(NamedTuple):
    """QCKM twin of :class:`SketchEngineState`: integer code accumulators.

    Same monoid, exact: the codes are a deterministic function of each point
    and the per-frequency dither, so any batching of the same points gives
    the same integers.  Unit weights only: ``weight_sum == count``.
    """

    qcos_acc: torch.Tensor  # (m,) i32 — sum_l Q(cos(w^T y_l + xi))
    qsin_acc: torch.Tensor  # (m,) i32 — sum_l Q(sin(w^T y_l + xi))
    weight_sum: torch.Tensor  # () f32 — == count (unit weights only)
    lower: torch.Tensor  # (n,) f32 — running per-coordinate min
    upper: torch.Tensor  # (n,) f32 — running per-coordinate max
    count: torch.Tensor  # () f32 — number of points folded in


class DecayedSketchEngineState(NamedTuple):
    """Time-decayed twin of :class:`SketchEngineState`.

    ``cos_acc/sin_acc/weight_sum`` are held in the units of ``stamp`` (the
    tick of the newest contribution): at any moment they equal
    ``sum_i gamma**(stamp - t_i) * contribution_i``.  ``lower/upper`` stay
    the lifetime envelope and ``count`` the raw folded-point total.
    ``gamma`` rides the state so the merge is self-describing.
    """

    cos_acc: torch.Tensor  # (m,) f32 — decayed sum of beta_l cos(w^T y_l)
    sin_acc: torch.Tensor  # (m,) f32 — decayed sum of beta_l sin(w^T y_l)
    weight_sum: torch.Tensor  # () f32 — decayed mass sum_i gamma^dt_i * w_i
    lower: torch.Tensor  # (n,) f32 — lifetime per-coordinate min
    upper: torch.Tensor  # (n,) f32 — lifetime per-coordinate max
    count: torch.Tensor  # () f32 — raw number of points folded (undecayed)
    stamp: torch.Tensor  # () f32 — tick of the newest fold; -inf = identity
    gamma: torch.Tensor  # () f32 — decay base per tick


class DecayedQuantizedSketchEngineState(NamedTuple):
    """Decay + quantization: exact int32 codes, decay in a float side-scale.

    ``qcos/qsin_acc`` hold the exact int32 code sums of the newest-stamp
    segment (same-tick merges add integers: bitwise split-invariant), while
    ``dcos/dsin_acc`` carry every older segment as float32 code mass with
    its decay factors applied.  A merge that advances the stamp folds the
    older operand's whole content into the side channel through one
    ``gamma**dt`` multiply; finalize dequantizes the sum of both segments.
    """

    qcos_acc: torch.Tensor  # (m,) i32 — exact code sums of the newest segment
    qsin_acc: torch.Tensor  # (m,) i32
    dcos_acc: torch.Tensor  # (m,) f32 — decayed older code mass
    dsin_acc: torch.Tensor  # (m,) f32
    weight_sum: torch.Tensor  # () f32 — decayed effective count
    lower: torch.Tensor  # (n,) f32 — lifetime per-coordinate min
    upper: torch.Tensor  # (n,) f32 — lifetime per-coordinate max
    count: torch.Tensor  # () f32 — raw number of points folded (undecayed)
    stamp: torch.Tensor  # () f32 — tick of the newest fold; -inf = identity
    gamma: torch.Tensor  # () f32 — decay base per tick


DECAYED_STATE_TYPES = (DecayedSketchEngineState, DecayedQuantizedSketchEngineState)


class _EngineInstruments(NamedTuple):
    """Per-engine cached metric handles (resolved once per registry
    generation, so the enabled steady state is plain ``float +=``)."""

    gen: int
    update_calls: object
    update_rows: object
    merge_calls: object
    finalize_calls: object
    state_bytes: object


def _state_nbytes(state) -> int:
    """Bytes of a state's tensors — what a partial ships on merge."""
    return sum(t.numel() * t.element_size() for t in state)


def _decay_factor(gamma: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """``gamma**dt`` with the identity edge cases pinned.

    ``dt`` is ``nan`` when both operands are the ``stamp=-inf`` identity and
    ``inf`` when the identity folds into a stamped state; both must behave as
    "no decay of nothing".  ``dt <= 0`` (the newest operand, or
    identity-identity) gives exactly 1.0, so same-stamp merges stay bitwise
    the undecayed merge.
    """
    positive = dt > 0
    safe = torch.where(positive, dt, torch.zeros_like(dt))
    # The power in float64, rounded once to float32: on the CPU, float32
    # pow takes another code path for a vector than for a scalar, and the
    # two differ in the last bit; in float64 the difference does not reach
    # the rounding, so a fleet's stacked factors are its isolated engines'.
    power = torch.pow(gamma.double(), safe.double()).to(dt.dtype)
    return torch.where(positive, power, torch.ones_like(dt))


def _merge_decayed(a, b):
    # Rank-generic: a single state's stamp is 0-d, a fleet's (T,); each
    # per-state scalar meets the (..., m) accumulators through [..., None].
    t = torch.maximum(a.stamp, b.stamp)
    fa = _decay_factor(a.gamma, t - a.stamp)
    fb = _decay_factor(b.gamma, t - b.stamp)
    common = dict(
        weight_sum=fa * a.weight_sum + fb * b.weight_sum,
        lower=torch.minimum(a.lower, b.lower),
        upper=torch.maximum(a.upper, b.upper),
        count=a.count + b.count,
        stamp=t,
        gamma=torch.maximum(a.gamma, b.gamma),
    )
    fa, fb = fa[..., None], fb[..., None]
    if isinstance(a, DecayedSketchEngineState):
        return DecayedSketchEngineState(
            cos_acc=fa * a.cos_acc + fb * b.cos_acc,
            sin_acc=fa * a.sin_acc + fb * b.sin_acc,
            **common,
        )
    # Segment by stamp: the operand(s) at the new stamp keep their int32
    # codes exact; an older operand folds entirely (ints + side channel)
    # into the float side channel through one gamma**dt multiply.
    a_new, b_new = (a.stamp >= t)[..., None], (b.stamp >= t)[..., None]

    def ints(new, q):
        return torch.where(new, q, torch.zeros_like(q))

    def side(new, f, q, d):
        return torch.where(new, d, f * (d + q.to(torch.float32)))

    return DecayedQuantizedSketchEngineState(
        qcos_acc=ints(a_new, a.qcos_acc) + ints(b_new, b.qcos_acc),
        qsin_acc=ints(a_new, a.qsin_acc) + ints(b_new, b.qsin_acc),
        dcos_acc=side(a_new, fa, a.qcos_acc, a.dcos_acc) + side(b_new, fb, b.qcos_acc, b.dcos_acc),
        dsin_acc=side(a_new, fa, a.qsin_acc, a.dsin_acc) + side(b_new, fb, b.qsin_acc, b.dsin_acc),
        **common,
    )


def _merge_states(a, b):
    if type(a) is not type(b):
        raise TypeError(
            f"cannot merge mismatched state flavours: "
            f"{type(a).__name__} vs {type(b).__name__}"
        )
    if isinstance(a, DECAYED_STATE_TYPES):
        return _merge_decayed(a, b)
    if isinstance(a, QuantizedSketchEngineState):
        return QuantizedSketchEngineState(
            qcos_acc=a.qcos_acc + b.qcos_acc,
            qsin_acc=a.qsin_acc + b.qsin_acc,
            weight_sum=a.weight_sum + b.weight_sum,
            lower=torch.minimum(a.lower, b.lower),
            upper=torch.maximum(a.upper, b.upper),
            count=a.count + b.count,
        )
    return SketchEngineState(
        cos_acc=a.cos_acc + b.cos_acc,
        sin_acc=a.sin_acc + b.sin_acc,
        weight_sum=a.weight_sum + b.weight_sum,
        lower=torch.minimum(a.lower, b.lower),
        upper=torch.maximum(a.upper, b.upper),
        count=a.count + b.count,
    )


def _normalize(cos_acc, sin_acc, weight_sum) -> torch.Tensor:
    """``z = [cos, -sin] / weight_sum``, rank-generic (``(m,)`` sums with a
    0-d weight, or a fleet's ``(T, m)`` with ``(T,)``).

    An empty stream (or an all-zero-weight shard) has nothing to average:
    it gives the zero sketch rather than accumulator/denom garbage.  The
    tiny denom floor alone is not enough — cos_acc can be exactly 0 while a
    negative-weight cancellation leaves weight_sum at -0.0 or ~1e-38.
    """
    denom = torch.clamp(weight_sum, min=1e-30)[..., None]
    z = torch.cat([cos_acc, -sin_acc], dim=-1) / denom
    return torch.where(weight_sum[..., None] > 0, z, torch.zeros_like(z))


def _finalize_state(state: SketchEngineState):
    return _normalize(state.cos_acc, state.sin_acc, state.weight_sum), state.lower, state.upper


def _finalize_quantized(state, dither: torch.Tensor, bits: int):
    """Dequantize and normalise a quantized state (single, or stacked with
    a ``(T, m)`` dither)."""
    qcos, qsin = state.qcos_acc, state.qsin_acc
    if isinstance(state, DecayedQuantizedSketchEngineState):
        # The E[sign] correction is linear in the code sums, so it applies to
        # the combined (exact newest segment + decayed older mass) total.
        # With an empty side channel this is bitwise the undecayed path:
        # ``q.float() + 0.0`` is the float the int path converts to.
        qcos = qcos.to(torch.float32) + state.dcos_acc
        qsin = qsin.to(torch.float32) + state.dsin_acc
    cos_acc, sin_acc = qz.dequantize_sums(qcos, qsin, dither, bits)
    return _normalize(cos_acc, sin_acc, state.weight_sum), state.lower, state.upper


def _kernel_operator(op: fo.FrequencyOperator) -> fo.FrequencyOperator:
    """``op`` with the float32 contiguous tensors its family's kernels take;
    raises for a family that has no kernel."""
    if isinstance(op, fo.DenseOperator):
        return fo.DenseOperator(op.w.to(torch.float32).contiguous())
    if isinstance(op, fo.StructuredOperator):
        return fo.StructuredOperator(
            op.diags.to(torch.float32).contiguous(), op.radii.to(torch.float32).contiguous(),
            op.rho, op.n, op.m,
        )
    raise TypeError(
        f"the 'kernel' backend has no sketch kernel for {type(op).__name__} "
        "(operator families with kernels: 'dense', 'structured')"
    )


def _check_mesh(mesh, data_axes: tuple[str, ...], device: torch.device) -> None:
    """Refuse a sharded engine that could not reduce: no process group, a
    mesh on another device type, or a data axis the mesh lacks."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "backend='sharded' needs an initialised torch.distributed process "
            "group (dist.init_process_group, then init_device_mesh)"
        )
    if mesh.device_type != device.type:
        raise ValueError(
            f"the mesh's device type {mesh.device_type!r} is not the engine's "
            f"device {str(device)!r}"
        )
    missing = [a for a in data_axes if a not in (mesh.mesh_dim_names or ())]
    if missing:
        raise ValueError(
            f"data axes {missing} are not axes of the mesh {mesh.mesh_dim_names}"
        )


def rank_block(x: torch.Tensor, mesh, data_axes) -> torch.Tensor:
    """This rank's block of ``x``'s leading axis, split by ``torch.tensor_split``
    over the extent of ``data_axes``; the block index is the rank's
    coordinates on those axes, the first axis major (the reference's
    ``P(data_axes)`` placement).  Ranks that differ only on other axes get
    the same block."""
    idx = 0
    for a in data_axes:
        idx = idx * axis_extent(mesh, (a,)) + mesh.get_local_rank(a)
    return torch.tensor_split(x, axis_extent(mesh, data_axes))[idx]


class SketchEngine:
    """Streaming/mergeable sketch computation.

    Parameters
    ----------
    w : the frequency operator (``freq_ops.make_operator("dense", ...)``) or a
        raw ``(n, m)`` tensor; it is moved to ``device``.
    backend : one of ``BACKENDS``.
    device : where the state lives and the batches are sketched (default the
        CUDA card; raises without one unless ``device="cpu"``).
    quantizer : optional ``core.quantize.SketchQuantizer`` — switches to the
        integer QCKM state; its ``(m,)`` dither is moved to ``device``.
    decay : optional per-tick decay base ``gamma`` in (0, 1] — switches to the
        time-decayed state: ``update`` takes a keyword ``t``, merging scales
        the older operand by ``gamma**dt`` first (see the module doc).
        ``decay=1.0`` keeps timestamps and decays nothing.
    mesh : the ``DeviceMesh`` of the ``"sharded"`` backend (required there);
        its device type must be the engine's, and the process group must be
        initialised.
    data_axes : the mesh axes the rows are split over; any other axis holds
        replicas.
    reduce_topology : the merge schedule of the sharded backend's collective
        and of :meth:`reduce_partials` — any name registered in
        ``core.topology`` (``"allreduce"`` | ``"tree"`` | ``"ring"``).  Every
        schedule gives the same sketch (bitwise on the quantized path); the
        choice trades wire bytes against hops (``topology.wire_cost_model``).
    """

    def __init__(
        self,
        w,
        backend: str = "kernel",
        *,
        device=dev_mod.DEFAULT,
        mesh=None,
        data_axes=("data",),
        quantizer: qz.SketchQuantizer | None = None,
        reduce_topology: str = "allreduce",
        decay: float | None = None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if backend == "sharded" and mesh is None:
            raise ValueError("backend='sharded' requires a mesh")
        if decay is not None and not 0.0 < float(decay) <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay!r}")
        topo.get_topology(reduce_topology)  # fail fast on unknown names
        self.device = dev_mod.resolve(device)
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.reduce_topology = reduce_topology
        if backend == "sharded":
            _check_mesh(mesh, self.data_axes, self.device)
        op = fo.as_operator(w).to(self.device)
        self.freq_op = op
        self.n, self.m = op.n, op.m
        self.backend = backend
        # The operator as its family's kernel takes it (never materialised).
        self._kop = _kernel_operator(op)
        if quantizer is not None:
            if tuple(quantizer.dither.shape) != (self.m,):
                raise ValueError(
                    f"quantizer dither shape {tuple(quantizer.dither.shape)} != (m,)="
                    f"({self.m},)"
                )
            quantizer = qz.SketchQuantizer(
                quantizer.bits, quantizer.dither.to(self.device, torch.float32).contiguous()
            )
        self.quantizer = quantizer
        self.decay = None if decay is None else float(decay)
        self._obs_h: _EngineInstruments | None = None

    def _obs(self) -> _EngineInstruments:
        """Resolve (or re-resolve after a registry reset) the engine's
        cached instrument handles.  Only reached when telemetry is on."""
        from repro_torch.obs import metrics as obs_metrics

        h = self._obs_h
        gen = obs_metrics.REGISTRY.generation
        if h is None or h.gen != gen:
            bits = str(self.quantizer.bits) if self.quantizer is not None else "none"
            labels = dict(backend=self.backend, bits=bits)
            h = self._obs_h = _EngineInstruments(
                gen=gen,
                update_calls=obs_metrics.counter("engine.update.calls", **labels),
                update_rows=obs_metrics.counter("engine.update.rows", **labels),
                merge_calls=obs_metrics.counter("engine.merge.calls", **labels),
                finalize_calls=obs_metrics.counter("engine.finalize.calls", **labels),
                state_bytes=obs_metrics.gauge("engine.state.bytes", **labels),
            )
        return h

    # -- monoid ops ---------------------------------------------------------

    def init_state(self):
        """The monoid identity: merge(init_state(), s) == s for any s."""
        f32, dev = torch.float32, self.device

        def zeros_m(dtype):
            return torch.zeros((self.m,), dtype=dtype, device=dev)

        rest = dict(
            weight_sum=torch.zeros((), dtype=f32, device=dev),
            lower=torch.full((self.n,), float("inf"), dtype=f32, device=dev),
            upper=torch.full((self.n,), float("-inf"), dtype=f32, device=dev),
            count=torch.zeros((), dtype=f32, device=dev),
        )
        if self.decay is not None:
            rest.update(
                stamp=torch.full((), float("-inf"), dtype=f32, device=dev),
                gamma=torch.full((), self.decay, dtype=f32, device=dev),
            )
            if self.quantizer is not None:
                return DecayedQuantizedSketchEngineState(
                    qcos_acc=zeros_m(torch.int32), qsin_acc=zeros_m(torch.int32),
                    dcos_acc=zeros_m(f32), dsin_acc=zeros_m(f32), **rest,
                )
            return DecayedSketchEngineState(cos_acc=zeros_m(f32), sin_acc=zeros_m(f32), **rest)
        if self.quantizer is not None:
            return QuantizedSketchEngineState(
                qcos_acc=zeros_m(torch.int32), qsin_acc=zeros_m(torch.int32), **rest
            )
        return SketchEngineState(cos_acc=zeros_m(f32), sin_acc=zeros_m(f32), **rest)

    def _lift_partial(self, part, t: torch.Tensor):
        """A base (undecayed) batch partial as a decayed state at tick ``t``:
        the bridge between the batch kernels, which know nothing of time,
        and the timestamped merge."""
        stamp = t.to(self.device, torch.float32)
        gamma = torch.full_like(stamp, self.decay)
        if isinstance(part, QuantizedSketchEngineState):
            return DecayedQuantizedSketchEngineState(
                qcos_acc=part.qcos_acc,
                qsin_acc=part.qsin_acc,
                dcos_acc=torch.zeros_like(part.qcos_acc, dtype=torch.float32),
                dsin_acc=torch.zeros_like(part.qsin_acc, dtype=torch.float32),
                weight_sum=part.weight_sum, lower=part.lower, upper=part.upper,
                count=part.count, stamp=stamp, gamma=gamma,
            )
        return DecayedSketchEngineState(*part, stamp=stamp, gamma=gamma)

    def _partial_state(self, batch: torch.Tensor, weights: torch.Tensor | None):
        """One batch -> one undecayed partial state (update before its merge)."""
        x = torch.as_tensor(batch, dtype=torch.float32).to(self.device).contiguous()
        if x.ndim != 2 or x.shape[1] != self.n:
            raise ValueError(f"batch must be (B, {self.n}), got {tuple(x.shape)}")
        if self.quantizer is not None:
            if weights is not None:
                raise ValueError(
                    "quantized sketch states accumulate unit-weight integer "
                    "counts; per-point weights are not representable"
                )
            return self._quantized_batch_state(x)
        if weights is None:
            weights = torch.ones((x.shape[0],), dtype=torch.float32, device=self.device)
        else:
            weights = torch.as_tensor(weights, dtype=torch.float32).to(self.device)
            weights = weights.reshape(-1).contiguous()
        return self._batch_state(x, weights)

    def update(self, state, batch: torch.Tensor, weights: torch.Tensor | None = None, *,
               t=None):
        """Fold ``batch: (B, n)`` into ``state``; ``weights`` default to 1 per
        point, so streaming batches of any size weight points equally.  A
        quantized engine takes no weights (``ValueError``).

        Under ``decay``, ``t`` is the batch's tick: older state content is
        scaled by ``gamma**(t - state.stamp)`` as it merges.  ``t=None``
        reuses the state's stamp (no time advance; the empty state resolves
        to tick 0).  ``t`` without ``decay`` raises.
        """
        if t is not None and self.decay is None:
            raise ValueError(
                "update(t=...) requires a decay-enabled engine (SketchEngine(decay=gamma))"
            )
        if not obs_rt.ENABLED:
            part = self._partial_state(batch, weights)
            if self.decay is not None:
                part = self._lift_partial(part, self._resolve_t(state, t))
            return _merge_states(state, part)
        from repro_torch.obs import trace as obs_trace

        h = self._obs()
        with obs_trace.span("engine.update", backend=self.backend):
            part = self._partial_state(batch, weights)
            if self.decay is not None:
                part = self._lift_partial(part, self._resolve_t(state, t))
            with obs_trace.span("engine.merge", backend=self.backend):
                out = _merge_states(state, part)
        h.update_calls.inc()
        h.update_rows.inc(float(batch.shape[0]))
        h.merge_calls.inc()
        h.state_bytes.set(_state_nbytes(out))
        return out

    def _resolve_t(self, state, t) -> torch.Tensor:
        """``t`` as a 0-d float32 tensor on the device; ``t=None`` -> the
        state's own stamp, the identity's ``-inf`` resolving to tick 0 (a
        non-empty partial stamped ``-inf`` would decay to nothing in any
        later merge)."""
        if t is None:
            return torch.where(torch.isfinite(state.stamp), state.stamp,
                               torch.zeros_like(state.stamp))
        if isinstance(t, torch.Tensor):
            return t.to(self.device, torch.float32).reshape(())
        return torch.full((), float(t), dtype=torch.float32, device=self.device)

    def decay_to(self, state, t):
        """Advance a decayed state's clock to tick ``t`` without folding data:
        the trig and weight sums scale by ``gamma**(t - stamp)``.  Done as a
        merge with an empty state stamped ``t``, so it commutes with every
        other monoid op; a ``t`` at or before the stamp is a bitwise no-op."""
        if self.decay is None:
            raise ValueError(
                "decay_to requires a decay-enabled engine (SketchEngine(decay=gamma))"
            )
        empty = self.init_state()
        return _merge_states(state, empty._replace(stamp=self._resolve_t(empty, t)))

    def merge(self, a, b):
        """Associative + commutative combine of two partial states of one
        flavour (mismatched flavours raise ``TypeError``)."""
        if not obs_rt.ENABLED:
            return _merge_states(a, b)
        from repro_torch.obs import trace as obs_trace

        h = self._obs()
        with obs_trace.span("engine.merge", backend=self.backend):
            out = _merge_states(a, b)
        h.merge_calls.inc()
        return out

    def reduce_partials(self, states, topology: str | None = None):
        """Reduce many partial states through a named merge schedule — the
        host-level counterpart of the sharded backend's collective: partials
        built anywhere are folded with ``merge`` following the engine's
        ``reduce_topology`` (or ``topology``).  Any schedule and any arrival
        order give the same state — bitwise for quantized int32 partials."""
        return topo.reduce_states(self.merge, states, topology or self.reduce_topology)

    def finalize(self, state):
        """-> ``(z stacked-real (2m,), lower (n,), upper (n,))``.

        A quantized state is dequantized here (E[sign] correction and dither
        rotation, ``quantize.dequantize_sums``), after the folded count is
        checked against the int32 capacity: beyond it the integer sums would
        have wrapped.
        """
        if not obs_rt.ENABLED:
            return self._finalize_impl(state)
        from repro_torch.obs import trace as obs_trace

        h = self._obs()
        with obs_trace.span("engine.finalize", backend=self.backend):
            out = self._finalize_impl(state)
        h.finalize_calls.inc()
        return out

    def _finalize_impl(self, state):
        if self.quantizer is None:
            # Duck-typed over the float flavours: the decayed state has the
            # same accumulator fields.
            return _finalize_state(state)
        bits = self.quantizer.bits
        cap = qz.accumulator_capacity(bits)
        if float(state.count) > cap:
            raise ValueError(
                f"quantized accumulators overflow: {float(state.count):.0f} points "
                f"folded at {bits} bits exceeds the int32 capacity of {cap} points "
                "(quantize.accumulator_capacity)"
            )
        return _finalize_quantized(state, self.quantizer.dither, bits)

    def sketch(self, x: torch.Tensor, weights: torch.Tensor | None = None):
        """One-shot ``(z, lower, upper)`` — init/update/finalize in one call."""
        return self.finalize(self.update(self.init_state(), x, weights))

    def sketch_stream(self, batches: Iterable[torch.Tensor], *, async_ingest: bool = False,
                      prefetch: int = 2):
        """One pass over an iterator of ``(B_i, n)`` batches -> (z, lo, hi).

        ``async_ingest=True`` routes the pass through
        ``core.ingest.ingest_stream``: a producer thread keeps ``prefetch``
        batches staged on the device (pinned buffers and a side stream on
        the card), so batch production and the copy overlap the sketch.
        Same batches, same order: the same bits.
        """
        if async_ingest:
            from repro_torch.core import ingest as ingest_mod

            state, _ = ingest_mod.ingest_stream(self, batches, prefetch=prefetch)
            return self.finalize(state)
        state = self.init_state()
        for batch in batches:
            state = self.update(state, batch)
        return self.finalize(state)

    def shard_points(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous block of a global ``(N, n)`` batch that every
        rank holds: the blocks of ``torch.tensor_split`` over the data-axis
        extent (ragged N is fine; a block may be empty), in the order of the
        rank's coordinates on ``data_axes``."""
        if self.mesh is None:
            raise ValueError("shard_points needs the 'sharded' backend's mesh")
        return rank_block(x, self.mesh, self.data_axes)

    def _reduce(self, v: torch.Tensor, op: str) -> torch.Tensor:
        return topo.axis_reduce(v, self.mesh, self.data_axes, self.reduce_topology, op)

    def _sharded_bounds(self, x: torch.Tensor):
        """``(lower, upper)`` over every rank's rows in one collective: the min
        of ``[lower, -upper]`` (negation is exact); an empty shard gives
        ``+inf`` for both halves, the identity."""
        n = self.n
        if x.shape[0]:
            local = torch.cat([torch.amin(x, dim=0), -torch.amax(x, dim=0)])
        else:
            local = torch.full((2 * n,), float("inf"), dtype=torch.float32, device=self.device)
        b = self._reduce(local, "min")
        return b[:n], -b[n:]

    def _sharded_batch_state(self, x: torch.Tensor, weights: torch.Tensor) -> SketchEngineState:
        """Sketch this rank's rows (kernel 1 or 4 on the card), then reduce the
        trig sums, the weight sum and the count in one sum collective and the
        bounds in one min collective over the data axes."""
        m = self.m
        if x.shape[0]:
            cos_s, sin_s = kops.fourier_sketch_sums(x, self._kop, weights)
            rows = torch.tensor([float(x.shape[0])], dtype=torch.float32, device=self.device)
            local = torch.cat([cos_s, sin_s, torch.sum(weights)[None], rows])
        else:  # no rows here: the identity, and still every collective
            local = torch.zeros((2 * m + 2,), dtype=torch.float32, device=self.device)
        sums = self._reduce(local, "sum")
        lo, hi = self._sharded_bounds(x)
        return SketchEngineState(sums[:m], sums[m : 2 * m], sums[2 * m], lo, hi, sums[2 * m + 1])

    def _sharded_quantized_batch_state(self, x: torch.Tensor) -> QuantizedSketchEngineState:
        """The bandwidth-aware twin: the int32 code sums and the row count
        reduce as integers (bitwise under every topology), the bounds as
        above.  ``finalize`` checks the reduced, global count."""
        q, m = self.quantizer, self.m
        if x.shape[0]:
            qcos, qsin = kops.quantized_fourier_sketch_sums(x, self._kop, q.dither, q.bits)
            rows = torch.tensor([x.shape[0]], dtype=torch.int32, device=self.device)
            local = torch.cat([qcos, qsin, rows])
        else:
            local = torch.zeros((2 * m + 1,), dtype=torch.int32, device=self.device)
        ints = self._reduce(local, "sum")
        lo, hi = self._sharded_bounds(x)
        n_pts = ints[2 * m].to(torch.float32)
        return QuantizedSketchEngineState(ints[:m], ints[m : 2 * m], n_pts, lo, hi, n_pts)

    def _batch_state(self, x: torch.Tensor, weights: torch.Tensor) -> SketchEngineState:
        if self.backend == "sharded":
            return self._sharded_batch_state(x, weights)
        cos_s, sin_s = kops.fourier_sketch_sums(x, self._kop, weights)
        return SketchEngineState(
            cos_acc=cos_s,
            sin_acc=sin_s,
            weight_sum=torch.sum(weights),
            lower=torch.amin(x, dim=0),
            upper=torch.amax(x, dim=0),
            count=torch.tensor(float(x.shape[0]), dtype=torch.float32, device=self.device),
        )

    def _quantized_batch_state(self, x: torch.Tensor) -> QuantizedSketchEngineState:
        if self.backend == "sharded":
            return self._sharded_quantized_batch_state(x)
        q = self.quantizer
        qcos, qsin = kops.quantized_fourier_sketch_sums(x, self._kop, q.dither, q.bits)
        n_pts = torch.tensor(float(x.shape[0]), dtype=torch.float32, device=self.device)
        return QuantizedSketchEngineState(
            qcos_acc=qcos,
            qsin_acc=qsin,
            weight_sum=n_pts,
            lower=torch.amin(x, dim=0),
            upper=torch.amax(x, dim=0),
            count=n_pts,
        )
