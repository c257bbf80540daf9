"""Stream helpers for the sketch side (counterpart of
``repro.data.pipeline.chunked`` and ``with_latency``).

The reference module's LM sources (``SyntheticLM``, ``MixtureSource``)
belong to the LM substrate and are not ported.
"""

from __future__ import annotations

import time
from typing import Iterator

import torch


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
