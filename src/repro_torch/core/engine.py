"""Streaming, mergeable SketchEngine — counterpart of ``repro.core.engine``
(float state, one backend).

The sketch is a *linear* summary, so its partial sums form a commutative
monoid: any split of the data over batches and any order of combining the
partials give the same sketch.

``SketchEngineState(cos_acc, sin_acc, weight_sum, lower, upper, count)``:

- identity:   ``init_state()`` (zero sums, ``+inf/-inf`` bounds),
- ``update``: fold one weighted batch into a state (one pass, O(m) memory),
- ``merge``:  elementwise combine — associative and commutative,
- ``finalize``: ``z = [sum b cos, -sum b sin] / sum b`` plus the CLOMPR box
  bounds ``(lower, upper)`` harvested in the same pass.

Backend: ``"kernel"`` — the batch sums go through
``kernels.ops.fourier_sketch_sums``, which runs the fused CUDA kernel on a
CUDA tensor and its plain PyTorch version on a CPU tensor.  It is the
counterpart of the reference's ``"pallas"`` backend; the reference's
``"sharded"`` backend, the quantized and decayed state transforms, topology
schedules and telemetry spans are not ported yet.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch

from repro_torch import device as dev_mod
from repro_torch.core import freq_ops as fo
from repro_torch.kernels import ops as kops

__all__ = ["SketchEngineState", "SketchEngine", "BACKENDS"]

BACKENDS = ("kernel",)


class SketchEngineState(NamedTuple):
    """Commutative-monoid accumulator of the one-pass sketch statistics."""

    cos_acc: torch.Tensor  # (m,) f32 — sum_l beta_l cos(w^T y_l), unnormalised
    sin_acc: torch.Tensor  # (m,) f32 — sum_l beta_l sin(w^T y_l), unnormalised
    weight_sum: torch.Tensor  # () f32 — sum of weights folded in so far
    lower: torch.Tensor  # (n,) f32 — running per-coordinate min
    upper: torch.Tensor  # (n,) f32 — running per-coordinate max
    count: torch.Tensor  # () f32 — number of points folded in


def _merge_states(a: SketchEngineState, b: SketchEngineState) -> SketchEngineState:
    if type(a) is not type(b):
        raise TypeError(
            f"cannot merge mismatched state flavours: "
            f"{type(a).__name__} vs {type(b).__name__}"
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


class SketchEngine:
    """Streaming/mergeable sketch computation.

    Parameters
    ----------
    w : the frequency operator (``freq_ops.make_operator("dense", ...)``) or a
        raw ``(n, m)`` tensor; it is moved to ``device``.
    backend : one of ``BACKENDS``.
    device : where the state lives and the batches are sketched (default the
        CUDA card; raises without one unless ``device="cpu"``).
    """

    def __init__(self, w, backend: str = "kernel", *, device=dev_mod.DEFAULT):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.device = dev_mod.resolve(device)
        op = fo.as_operator(w).to(self.device)
        self.freq_op = op
        self.n, self.m = op.n, op.m
        self.backend = backend
        # The kernel takes the dense matrix; it is materialised once here.
        self._w = op.materialize().to(torch.float32).contiguous()

    def init_state(self) -> SketchEngineState:
        """The monoid identity: merge(init_state(), s) == s for any s."""
        f32, dev = torch.float32, self.device
        return SketchEngineState(
            cos_acc=torch.zeros((self.m,), dtype=f32, device=dev),
            sin_acc=torch.zeros((self.m,), dtype=f32, device=dev),
            weight_sum=torch.zeros((), dtype=f32, device=dev),
            lower=torch.full((self.n,), float("inf"), dtype=f32, device=dev),
            upper=torch.full((self.n,), float("-inf"), dtype=f32, device=dev),
            count=torch.zeros((), dtype=f32, device=dev),
        )

    def update(
        self,
        state: SketchEngineState,
        batch: torch.Tensor,
        weights: torch.Tensor | None = None,
    ) -> SketchEngineState:
        """Fold ``batch: (B, n)`` into ``state``; ``weights`` default to 1 per
        point, so streaming batches of any size weight points equally."""
        x = torch.as_tensor(batch, dtype=torch.float32).to(self.device).contiguous()
        if x.ndim != 2 or x.shape[1] != self.n:
            raise ValueError(f"batch must be (B, {self.n}), got {tuple(x.shape)}")
        if weights is None:
            weights = torch.ones((x.shape[0],), dtype=torch.float32, device=self.device)
        else:
            weights = torch.as_tensor(weights, dtype=torch.float32).to(self.device)
            weights = weights.reshape(-1).contiguous()
        return _merge_states(state, self._batch_state(x, weights))

    def merge(self, a: SketchEngineState, b: SketchEngineState) -> SketchEngineState:
        """Associative + commutative combine of two partial states."""
        return _merge_states(a, b)

    def finalize(self, state: SketchEngineState):
        """-> ``(z stacked-real (2m,), lower (n,), upper (n,))``."""
        return _finalize_state(state)

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
        cos_s, sin_s = kops.fourier_sketch_sums(x, self._w, weights)
        return SketchEngineState(
            cos_acc=cos_s,
            sin_acc=sin_s,
            weight_sum=torch.sum(weights),
            lower=torch.amin(x, dim=0),
            upper=torch.amax(x, dim=0),
            count=torch.tensor(float(x.shape[0]), dtype=torch.float32, device=self.device),
        )
