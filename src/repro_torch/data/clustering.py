"""Compressive data clustering for pipeline balancing (counterpart of
``repro.data.clustering``).

An ingestion tier cannot afford a second pass over the corpus to cluster
document embeddings, but it can afford an O(m) mergeable sketch per worker
(the paper's central object).  ``CompressiveBalancer``

1. folds document-embedding batches into a streaming ``SketchState`` (one
   per worker; merged with ``distributed_sketch.merge``), through kernel 1
   on the card,
2. decodes K domain centroids with CKM from the sketch alone,
3. reads each cluster's mass off the decoded mixture weights alpha, and
4. emits rebalanced sampling weights (inverse-propensity toward uniform).

No raw data is retained beyond a small reservoir of rows: the paper's
"sketch-then-discard" contract applied to a data pipeline.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.core import ckm as ckm_mod
from repro_torch.core import distributed_sketch as ds
from repro_torch.core import freq_ops as fo
from repro_torch.core import frequencies as fq


def _host(x) -> np.ndarray:
    """Rows as a float32 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu")
    return np.asarray(x, np.float32)


@dataclasses.dataclass
class CompressiveBalancer:
    """Streaming sketch of document embeddings -> cluster-balanced weights.

    The operator is drawn from ``seed`` (``freq_ops.seeded_operator``, so it
    carries its spec), sigma^2 from ``derive_seed(seed, 7)`` on the first
    batch and each decode from ``derive_seed(seed, 1)`` unless a seed is
    given; the reservoir draws from numpy's ``default_rng(seed + 13)``, as
    the reference's does.
    """

    k: int
    dim: int
    m: int | None = None
    sigma2: float | None = None  # None: estimated on the FIRST batch (paper's
    # small-sketch regression on a data fraction, §3.3 step 1)
    # The sigma^2 estimator targets GMM decoding, where the model absorbs the
    # cluster envelope e^{-R^2 sigma_c^2/2}.  K-means decodes Diracs: at the
    # GMM scale CLOMPR explains a wide cluster better with two split atoms
    # than with one, which under imbalance outweighs the small clusters.
    # Boosting sigma^2 (lowering the frequencies) to where the envelope is
    # nearly flat removes the incentive; separability is unaffected while
    # the separation is much larger than a cluster's spread.
    freq_scale_boost: float = 6.0
    seed: int = 0
    # A small reservoir kept beside the sketch: CLOMPR's step-1 ascent starts
    # from sampled points (paper §4.2 "Sample" init).  One pass, O(reservoir)
    # memory: the compressive contract is kept.
    reservoir: int = 256
    device: str | torch.device = dev_mod.DEFAULT

    def __post_init__(self):
        self.device = dev_mod.resolve(self.device)
        self.m_ = self.m or 10 * self.k * self.dim
        self.state = ds.init_state(self.m_, self.dim, self.device)
        self.freqs = None
        self._seen = 0
        self._rng = np.random.default_rng(self.seed + 13)
        self._reservoir = np.zeros((self.reservoir, self.dim), np.float32)
        if self.sigma2 is not None:
            self._draw(float(self.sigma2))

    def _draw(self, sigma2: float):
        self.sigma2 = sigma2
        self.freqs = fo.seeded_operator("dense", self.seed, self.m_, self.dim, sigma2,
                                        device=self.device)

    def _reservoir_update(self, embeds: np.ndarray):
        for row in embeds:
            if self._seen < self.reservoir:
                self._reservoir[self._seen] = row
            else:
                j = self._rng.integers(0, self._seen + 1)
                if j < self.reservoir:
                    self._reservoir[j] = row
            self._seen += 1

    def update(self, embeds):
        """Fold one batch of document embeddings (B, dim) into the sketch."""
        host = _host(embeds)
        x = torch.from_numpy(host).to(self.device)
        if self.freqs is None:
            gen = dev_mod.generator(dev_mod.derive_seed(self.seed, 7), self.device)
            s2 = fq.estimate_sigma2(gen, x, device=self.device)
            self._draw(float(s2) * self.freq_scale_boost)
        self.state = ds.update(self.state, x, self.freqs)
        self._reservoir_update(host)

    def merge(self, other: "CompressiveBalancer"):
        self.state = ds.merge(self.state, other.state)

    def cluster(self, seed: int | None = None) -> ckm_mod.CKMResult:
        """Decode centroids and mixture weights from the sketch (reservoir
        inits for step 1: paper §4.2's Sample strategy)."""
        seed = seed if seed is not None else dev_mod.derive_seed(self.seed, 1)
        z, lo, hi = ds.finalize(self.state)
        cfg = ckm_mod.CKMConfig(k=self.k, m=self.m_, init="kpp", atom_restarts=4)
        x_init = torch.from_numpy(self._reservoir[: min(self._seen, self.reservoir)].copy())
        cents, alphas, cost = ckm_mod.decode_sketch(
            seed, z, self.freqs, lo, hi, cfg, x_init=x_init, device=self.device
        )
        return ckm_mod.CKMResult(
            cents, alphas, cost,
            torch.tensor(self.sigma2, dtype=torch.float32, device=self.device), self.freqs, z,
            (lo, hi),
        )

    def balanced_weights(self, result: ckm_mod.CKMResult | None = None) -> np.ndarray:
        """Per-cluster sampling weights pushing the stream toward uniform."""
        result = result or self.cluster()
        alpha = np.maximum(_host(result.weights), 1e-6)
        w = 1.0 / alpha
        return w / w.sum()

    def assign_clusters(self, embeds, result: ckm_mod.CKMResult) -> torch.Tensor:
        """Each row's nearest decoded centroid (kernel 2 on the card)."""
        x = torch.from_numpy(_host(embeds)).to(self.device)
        return ckm_mod.predict(x, result.centroids, device=self.device)
