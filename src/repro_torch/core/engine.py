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
family with no kernel is refused when the engine is built.  The reference's
``"sharded"`` backend, the decayed state transforms, topology schedules and
telemetry spans are not ported yet.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch

from repro_torch import device as dev_mod
from repro_torch.core import freq_ops as fo
from repro_torch.core import quantize as qz
from repro_torch.kernels import ops as kops

__all__ = ["SketchEngineState", "QuantizedSketchEngineState", "SketchEngine", "BACKENDS"]

BACKENDS = ("kernel",)


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


def _merge_states(a, b):
    if type(a) is not type(b):
        raise TypeError(
            f"cannot merge mismatched state flavours: "
            f"{type(a).__name__} vs {type(b).__name__}"
        )
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


def _finalize_state(state: SketchEngineState):
    # An empty stream (or an all-zero-weight shard) has nothing to average:
    # return the zero sketch rather than accumulator/denom garbage.  The tiny
    # denom floor alone is not enough — cos_acc can be exactly 0 while a
    # negative-weight cancellation leaves weight_sum at -0.0 or ~1e-38.
    denom = torch.clamp(state.weight_sum, min=1e-30)
    z = torch.cat([state.cos_acc, -state.sin_acc]) / denom
    z = torch.where(state.weight_sum > 0, z, torch.zeros_like(z))
    return z, state.lower, state.upper


def _finalize_quantized(state: QuantizedSketchEngineState, dither: torch.Tensor, bits: int):
    cos_acc, sin_acc = qz.dequantize_sums(state.qcos_acc, state.qsin_acc, dither, bits)
    denom = torch.clamp(state.weight_sum, min=1e-30)
    z = torch.cat([cos_acc, -sin_acc]) / denom
    # Same guard as the float path: an empty quantized stream finalizes to
    # the zero sketch.
    z = torch.where(state.weight_sum > 0, z, torch.zeros_like(z))
    return z, state.lower, state.upper


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
    """

    def __init__(
        self,
        w,
        backend: str = "kernel",
        *,
        device=dev_mod.DEFAULT,
        quantizer: qz.SketchQuantizer | None = None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.device = dev_mod.resolve(device)
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

    def init_state(self) -> SketchEngineState | QuantizedSketchEngineState:
        """The monoid identity: merge(init_state(), s) == s for any s."""
        f32, dev = torch.float32, self.device
        if self.quantizer is not None:
            return QuantizedSketchEngineState(
                qcos_acc=torch.zeros((self.m,), dtype=torch.int32, device=dev),
                qsin_acc=torch.zeros((self.m,), dtype=torch.int32, device=dev),
                weight_sum=torch.zeros((), dtype=f32, device=dev),
                lower=torch.full((self.n,), float("inf"), dtype=f32, device=dev),
                upper=torch.full((self.n,), float("-inf"), dtype=f32, device=dev),
                count=torch.zeros((), dtype=f32, device=dev),
            )
        return SketchEngineState(
            cos_acc=torch.zeros((self.m,), dtype=f32, device=dev),
            sin_acc=torch.zeros((self.m,), dtype=f32, device=dev),
            weight_sum=torch.zeros((), dtype=f32, device=dev),
            lower=torch.full((self.n,), float("inf"), dtype=f32, device=dev),
            upper=torch.full((self.n,), float("-inf"), dtype=f32, device=dev),
            count=torch.zeros((), dtype=f32, device=dev),
        )

    def update(self, state, batch: torch.Tensor, weights: torch.Tensor | None = None):
        """Fold ``batch: (B, n)`` into ``state``; ``weights`` default to 1 per
        point, so streaming batches of any size weight points equally.  A
        quantized engine takes no weights (``ValueError``)."""
        x = torch.as_tensor(batch, dtype=torch.float32).to(self.device).contiguous()
        if x.ndim != 2 or x.shape[1] != self.n:
            raise ValueError(f"batch must be (B, {self.n}), got {tuple(x.shape)}")
        if self.quantizer is not None:
            if weights is not None:
                raise ValueError(
                    "quantized sketch states accumulate unit-weight integer "
                    "counts; per-point weights are not representable"
                )
            return _merge_states(state, self._quantized_batch_state(x))
        if weights is None:
            weights = torch.ones((x.shape[0],), dtype=torch.float32, device=self.device)
        else:
            weights = torch.as_tensor(weights, dtype=torch.float32).to(self.device)
            weights = weights.reshape(-1).contiguous()
        return _merge_states(state, self._batch_state(x, weights))

    def merge(self, a, b):
        """Associative + commutative combine of two partial states of one
        flavour (mismatched flavours raise ``TypeError``)."""
        return _merge_states(a, b)

    def finalize(self, state):
        """-> ``(z stacked-real (2m,), lower (n,), upper (n,))``.

        A quantized state is dequantized here (E[sign] correction and dither
        rotation, ``quantize.dequantize_sums``), after the folded count is
        checked against the int32 capacity: beyond it the integer sums would
        have wrapped.
        """
        if self.quantizer is None:
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

    def sketch_stream(self, batches: Iterable[torch.Tensor]):
        """One pass over an iterator of ``(B_i, n)`` batches -> (z, lo, hi)."""
        state = self.init_state()
        for batch in batches:
            state = self.update(state, batch)
        return self.finalize(state)

    def _batch_state(self, x: torch.Tensor, weights: torch.Tensor) -> SketchEngineState:
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
