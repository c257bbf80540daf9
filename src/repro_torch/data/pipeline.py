"""Deterministic data pipeline (counterpart of ``repro.data.pipeline``).

Fault-tolerance contract: batches are a pure function of (seed, step) — a
restart from step k reproduces the exact token stream with no iterator state
to checkpoint, and any worker can regenerate any step's batch.

- ``SyntheticLM``: a zipf-ish token stream with planted cluster structure in
  a "document embedding" side channel (what the compressive balancer,
  ``data/clustering.py``, sketches).  Its draws are numpy's, in the
  reference's order, so its batches are bitwise the reference's;
  ``set_domain_weights`` re-weights the domains it samples.
- ``chunked`` and ``with_latency``: stream helpers for the sketch side.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    n_domains: int = 8  # planted "topic" clusters for the CKM demo
    embed_dim: int = 16  # document-embedding side channel


class SyntheticLM:
    """Batch = f(seed, step): deterministic and restartable.  Batches are
    tensors on ``device``."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, data: DataConfig,
                 device=dev_mod.DEFAULT):
        self.cfg = cfg
        self.shape = shape
        self.data = data
        self.device = dev_mod.resolve(device)
        rng = np.random.default_rng(data.seed)
        # Per-domain unigram tables (zipf with domain-specific permutations)
        # and domain embedding centroids (the ground truth the balancer
        # should recover).
        v = cfg.vocab_size
        base = 1.0 / (np.arange(1, v + 1) ** 1.1)
        self.domain_perm = np.stack([rng.permutation(v) for _ in range(data.n_domains)])
        self.base_p = base / base.sum()
        self.domain_centroids = rng.normal(
            size=(data.n_domains, data.embed_dim)
        ).astype(np.float32) * 3.0
        self.domain_weights = np.full(data.n_domains, 1.0 / data.n_domains)

    def set_domain_weights(self, w: np.ndarray):
        w = np.maximum(np.asarray(w, np.float64), 1e-9)
        self.domain_weights = w / w.sum()

    def batch_numpy(self, step: int) -> dict:
        """The global batch for ``step`` as numpy arrays (tokens, labels,
        the frontend's inputs, ``_doc_embeds`` and ``_domains``)."""
        cfg, shape = self.cfg, self.shape
        rng = np.random.default_rng((self.data.seed, step))
        b = shape.global_batch
        s_text = shape.seq_len - (cfg.frontend_len if cfg.frontend == "vision" else 0)
        domains = rng.choice(self.data.n_domains, size=b, p=self.domain_weights)
        # Tokens: domain-permuted zipf draws (cheap, deterministic).
        u = rng.random((b, s_text + 1))
        cdf = np.cumsum(self.base_p)
        ranks = np.searchsorted(cdf, u).clip(max=cfg.vocab_size - 1)
        tokens = np.take_along_axis(
            self.domain_perm[domains][:, None, :].reshape(b, -1),
            ranks.reshape(b, -1),
            axis=1,
        ).reshape(b, s_text + 1).astype(np.int32)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if cfg.frontend in ("vision", "audio"):
            key = "patches" if cfg.frontend == "vision" else "frames"
            batch[key] = rng.normal(size=(b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        # Document-embedding side channel (noisy domain centroid): consumed
        # by the compressive balancer, not by the model.
        batch["_doc_embeds"] = self.domain_centroids[domains] + rng.normal(
            size=(b, self.data.embed_dim)
        ).astype(np.float32)
        batch["_domains"] = domains.astype(np.int32)
        return batch

    def batch(self, step: int) -> dict:
        """The global batch for ``step``: ``batch_numpy``'s arrays as
        tensors on the source's device."""
        return {k: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for k, a in self.batch_numpy(step).items()}

    def iter(self, start_step: int) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1

    def embedding_stream(self, start_step: int, steps: int) -> Iterator[torch.Tensor]:
        """Document-embedding batches only — a point stream for the streaming
        ``SketchEngine`` / ``ckm.fit_streaming`` (each batch is f(seed,
        step), so the stream is restartable)."""
        for step in range(start_step, start_step + steps):
            yield self.batch(step)["_doc_embeds"]


def chunked(x, size: int) -> Iterator[torch.Tensor]:
    """View an in-memory ``(N, n)`` array as a batch iterator of ``size``-row
    chunks (last chunk ragged) — adapts a dataset to the one-pass streaming
    API (a ``core.ingest.BatchSource``)."""
    if size <= 0:
        raise ValueError(f"chunk size must be positive, got {size}")
    for i in range(0, x.shape[0], size):
        yield x[i : i + size]


def with_latency(source, seconds: float) -> Iterator[torch.Tensor]:
    """Model a host-I/O-bound ``BatchSource``: each batch costs ``seconds``
    of producer time before it is yielded (disk read, network fetch,
    decode), the regime that async ingest (``core.ingest``) hides under the
    sketch."""
    if seconds < 0:
        raise ValueError(f"latency must be >= 0, got {seconds}")
    for batch in source:
        time.sleep(seconds)
        yield batch
