"""Activation-space monitoring via streaming sketches (counterpart of
``repro.train.monitor``).

Every train step folds a mean-pooled final-hidden-state batch into an O(m)
sketch (kernel 4 on the card at d_model >= 512, kernel 1 below).  Offline,
at checkpoint boundaries, CKM decodes K centroids from the sketch alone: a
cluster-level picture of the representation space over time, without ever
storing activations.

Drift between two windows = mean matched-centroid displacement, weighted by
mixture mass: an early warning for representation collapse or data shifts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.core import ckm as ckm_mod
from repro_torch.core import distributed_sketch as ds
from repro_torch.core import freq_ops as fo


@dataclasses.dataclass
class ActivationMonitor:
    dim: int  # d_model
    k: int = 8
    m: int | None = None
    sigma2: float = 1.0
    seed: int = 17
    # Frequency-operator family (core.freq_ops registry).  None resolves by
    # d_model: "structured" at dim >= 512 (a 2k-dim residual stream must not
    # materialise the (dim, m) dense matrix: O(m) signs and radii instead),
    # the paper's "dense" below that, where the matrix is small and fastest.
    freq_op: str | None = None
    device: str | torch.device = dev_mod.DEFAULT

    def __post_init__(self):
        self.device = dev_mod.resolve(self.device)
        self.m_ = self.m or 4 * self.k * self.dim
        if self.freq_op is None:
            self.freq_op = "structured" if self.dim >= 512 else "dense"
        # A spec-carrying operator: checkpoints and peers need only op.spec().
        self.freqs = fo.seeded_operator(self.freq_op, self.seed, self.m_, self.dim,
                                        self.sigma2, device=self.device)

    def init_state(self) -> ds.SketchState:
        return ds.init_state(self.m_, self.dim, self.device)

    def update(self, state: ds.SketchState, pooled: torch.Tensor) -> ds.SketchState:
        """Fold (B, d) pooled hiddens (detached) into the sketch."""
        return ds.update(state, pooled.detach().to(torch.float32), self.freqs)

    def decode(self, state: ds.SketchState, seed: int | None = None) -> ckm_mod.CKMResult:
        seed = seed if seed is not None else dev_mod.derive_seed(self.seed, 1)
        z, lo, hi = ds.finalize(state)
        cfg = ckm_mod.CKMConfig(
            k=self.k, m=self.m_, atom_steps=150, joint_steps=100, final_steps=300
        )
        cents, alphas, cost = ckm_mod.decode_sketch(seed, z, self.freqs, lo, hi, cfg,
                                                    device=self.device)
        return ckm_mod.CKMResult(
            cents, alphas, cost,
            torch.tensor(self.sigma2, dtype=torch.float32, device=self.device),
            self.freqs, z, (lo, hi),
        )

    def sketch_drift(self, state: ds.SketchState, result: ckm_mod.CKMResult) -> float:
        """O(m) drift of the live window against a decoded snapshot: the
        distance between the current state's sketch and ``result``'s
        re-sketched centroids (``repro_torch.obs.diagnose.sketch_drift``).
        No decode needed, so it can run every window where :meth:`decode`
        and :meth:`drift` run at checkpoint boundaries.  Sets the
        ``monitor.sketch_drift`` gauge when telemetry is enabled."""
        from repro_torch.obs import runtime as obs_rt
        from repro_torch.obs.diagnose import sketch_drift

        z_live, _, _ = ds.finalize(state)
        score = sketch_drift(z_live, result.centroids, result.weights, self.freqs)
        if obs_rt.ENABLED:
            from repro_torch.obs import metrics as obs_metrics

            obs_metrics.gauge("monitor.sketch_drift").set(score)
        return score

    @staticmethod
    def drift(prev: ckm_mod.CKMResult, cur: ckm_mod.CKMResult) -> float:
        """Mass-weighted mean displacement between matched centroid sets."""
        a, b, wa = (np.asarray(t.detach().to("cpu")) if isinstance(t, torch.Tensor)
                    else np.asarray(t)
                    for t in (prev.centroids, cur.centroids, prev.weights))
        d = np.linalg.norm(a[:, None] - b[None], axis=-1)
        moved, used = 0.0, d.copy()
        for _ in range(a.shape[0]):
            i, j = np.unravel_index(np.argmin(used), used.shape)
            moved += wa[i] * d[i, j]
            used[i, :] = np.inf
            used[:, j] = np.inf
        return float(moved / max(wa.sum(), 1e-9))
