"""Compressive K-means — the user-facing API (paper §3.3), counterpart of
``repro.core.ckm``.

The pipeline is the paper's four steps:

1. choose a frequency scale sigma^2 on a small fraction of the data
   (``frequencies.estimate_sigma2``),
2. draw the frequency operator for ``m`` frequencies from the adapted-radius
   distribution (``core.freq_ops``, ``"dense"``),
3. compute the sketch ``z = Sk(X, 1/N)`` in one pass through
   ``core.engine.SketchEngine`` (the fused CUDA kernel on the card), together
   with the box bounds ``l, u``,
4. decode K centroids from the sketch with a registered decoder (CLOMPR).

Replicates run one after another and the one with the lowest sketch-domain
cost (4) wins — the SSE is not available once the data is discarded.

Randomness: a fit takes an integer ``seed``.  :func:`stream_keys` fans it out
into the sketch pass's three generators ``(sigma2, frequencies, dither)``,
and replicate ``r`` of a decode draws from ``derive_seed(seed, r)``, so the
replicate streams for R replicates are a prefix of those for R' > R.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple

import torch

from repro_torch import device as dev_mod
from repro_torch.core import decoders as dec_mod
from repro_torch.core import freq_ops as fo
from repro_torch.core import frequencies as freq_mod
from repro_torch.core.decoders import CLOMPRConfig
from repro_torch.core.engine import SketchEngine
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class CKMConfig:
    """The fields of the reference's ``CKMConfig`` that this port honours."""

    k: int
    m: int | None = None  # sketch size; default m = 10*K*n
    freq_dist: freq_mod.FreqDist = "adapted_radius"
    freq_op: str = "dense"  # frequency operator family (core.freq_ops)
    replicates: int = 1
    sigma2: float | None = None  # None -> estimate from a data fraction
    sigma2_sample: int = 2048
    init: str = "range"
    atom_steps: int = 300
    joint_steps: int = 200
    nnls_iters: int = 150
    atom_lr: float = 0.05
    joint_lr: float = 0.02
    atom_restarts: int = 1
    final_steps: int = 1000
    merge_radius_scale: float = 2.5
    # Sketch-computation backend (core.engine.BACKENDS): "kernel", the fused
    # CUDA kernel (plain PyTorch version on the CPU).
    sketch_backend: str = "kernel"
    decoder: str = "clompr"

    def sketch_size(self, n: int) -> int:
        return self.m if self.m is not None else 10 * self.k * n

    def clompr_config(self) -> CLOMPRConfig:
        return CLOMPRConfig(
            k=self.k,
            atom_steps=self.atom_steps,
            joint_steps=self.joint_steps,
            nnls_iters=self.nnls_iters,
            atom_lr=self.atom_lr,
            joint_lr=self.joint_lr,
            init=self.init,  # type: ignore[arg-type]
            atom_restarts=self.atom_restarts,
            final_steps=self.final_steps,
            merge_radius_scale=self.merge_radius_scale,
        )


class CKMResult(NamedTuple):
    centroids: torch.Tensor  # (K, n)
    weights: torch.Tensor  # (K,) — mixture weights alpha, sum to 1
    cost: torch.Tensor  # sketch-domain objective (4) of the selected replicate
    sigma2: torch.Tensor
    freq_op: fo.FrequencyOperator
    sketch: torch.Tensor  # stacked-real (2m,)
    bounds: tuple[torch.Tensor, torch.Tensor]

    @property
    def frequencies(self) -> torch.Tensor:
        """The ``(n, m)`` frequency matrix."""
        return self.freq_op.materialize()


def stream_keys(
    seed: int, device=dev_mod.DEFAULT
) -> tuple[torch.Generator, torch.Generator, torch.Generator]:
    """The sketch pass's three generators ``(sigma2, frequencies, dither)``,
    each seeded from its own child of ``seed``.  The dither stream is unused
    until the quantized sketch is ported; it exists so that enabling it will
    not perturb the other two."""
    dev = dev_mod.resolve(device)
    return tuple(dev_mod.generator(dev_mod.derive_seed(seed, i), dev) for i in range(3))


def make_engine(w, cfg: CKMConfig, device=dev_mod.DEFAULT) -> SketchEngine:
    """The SketchEngine for ``cfg`` on ``device``."""
    return SketchEngine(w, cfg.sketch_backend, device=device)


def _draw_freqs(seed: int, sample: torch.Tensor, n: int, cfg: CKMConfig, dev):
    """Steps 1–2 on a data sample: scale estimation + operator construction."""
    g_sig, g_freq, _ = stream_keys(seed, dev)
    if cfg.sigma2 is None:
        take = min(cfg.sigma2_sample, sample.shape[0])
        sigma2 = freq_mod.estimate_sigma2(g_sig, sample[:take], device=dev)
    else:
        sigma2 = torch.tensor(cfg.sigma2, dtype=torch.float32, device=dev)
    op = fo.make_operator(
        cfg.freq_op, g_freq, cfg.sketch_size(n), n, sigma2, dist=cfg.freq_dist,
        device=dev,
    )
    return op, sigma2


def _f32_on(x, dev) -> torch.Tensor:
    """``x`` as a contiguous float32 tensor on ``dev``."""
    return torch.as_tensor(x, dtype=torch.float32).to(dev).contiguous()


def compute_sketch(seed: int, x: torch.Tensor, cfg: CKMConfig, device=dev_mod.DEFAULT):
    """Steps 1–3 -> ``(z, op, sigma2, (lower, upper))``."""
    dev = dev_mod.resolve(device)
    x = _f32_on(x, dev)
    op, sigma2 = _draw_freqs(seed, x, x.shape[1], cfg, dev)
    z, lo, hi = make_engine(op, cfg, dev).sketch(x)
    return z, op, sigma2, (lo, hi)


def compute_sketch_streaming(
    seed: int, batches: Iterable[torch.Tensor], cfg: CKMConfig, device=dev_mod.DEFAULT
):
    """One-pass sketch of a batch iterator.

    The first batch doubles as the sigma^2-estimation sample; every batch —
    the first included — is folded into the engine state, and the device is
    waited on after each fold so a batch may be dropped the moment it is in
    (the O(m)-memory contract).  Returns ``(z, op, sigma2, (lower, upper),
    first_batch)``.
    """
    dev = dev_mod.resolve(device)
    it = iter(batches)
    try:
        first = _f32_on(next(it), dev)
    except StopIteration:
        raise ValueError("compute_sketch_streaming needs at least one batch") from None
    op, sigma2 = _draw_freqs(seed, first, first.shape[1], cfg, dev)
    eng = make_engine(op, cfg, dev)
    state = eng.update(eng.init_state(), first)
    for batch in it:
        state = eng.update(state, batch)
        dev_mod.sync(dev)
    z, lo, hi = eng.finalize(state)
    return z, op, sigma2, (lo, hi), first


def decode_sketch(
    seed: int,
    z: torch.Tensor,
    w,
    lower: torch.Tensor,
    upper: torch.Tensor,
    cfg: CKMConfig,
    x_init: torch.Tensor | None = None,
    device=dev_mod.DEFAULT,
):
    """Step 4: decode with ``cfg.decoder``; of ``cfg.replicates`` runs, the one
    with the lowest cost (4) wins (the first on ties), so more replicates can
    never return a higher cost."""
    dev = dev_mod.resolve(device)
    w = fo.as_operator(w).to(dev)
    z, lower, upper = (_f32_on(t, dev) for t in (z, lower, upper))
    if x_init is not None:
        x_init = _f32_on(x_init, dev)
    decode = dec_mod.get_decoder(cfg.decoder)
    best = None
    for r in range(cfg.replicates):
        gen = dev_mod.generator(dev_mod.derive_seed(seed, r), dev)
        out = decode(gen, z, w, lower, upper, cfg, x_init)
        if best is None or float(out[2]) < float(best[2]):
            best = out
    return best


def fit(seed: int, x: torch.Tensor, cfg: CKMConfig, device=dev_mod.DEFAULT) -> CKMResult:
    """End-to-end compressive K-means on an in-memory dataset."""
    dev = dev_mod.resolve(device)
    x = _f32_on(x, dev)
    z, op, sigma2, (lo, hi) = compute_sketch(dev_mod.derive_seed(seed, 0), x, cfg, dev)
    x_init = x if cfg.init in ("sample", "kpp") else None
    cents, alphas, cost = decode_sketch(
        dev_mod.derive_seed(seed, 1), z, op, lo, hi, cfg, x_init, dev
    )
    return CKMResult(cents, alphas, cost, sigma2, op, z, (lo, hi))


def fit_streaming(
    seed: int, batches: Iterable[torch.Tensor], cfg: CKMConfig, device=dev_mod.DEFAULT
) -> CKMResult:
    """End-to-end CKM over an iterator of ``(B_i, n)`` batches: one pass, O(m)
    memory.  The "sample"/"kpp" inits draw from the first batch only."""
    dev = dev_mod.resolve(device)
    z, op, sigma2, (lo, hi), first = compute_sketch_streaming(
        dev_mod.derive_seed(seed, 0), batches, cfg, dev
    )
    x_init = first if cfg.init in ("sample", "kpp") else None
    cents, alphas, cost = decode_sketch(
        dev_mod.derive_seed(seed, 1), z, op, lo, hi, cfg, x_init, dev
    )
    return CKMResult(cents, alphas, cost, sigma2, op, z, (lo, hi))


# ---------------------------------------------------------------------------
# Evaluation helpers (need data access — used for experiments only)
# ---------------------------------------------------------------------------


def sse(x: torch.Tensor, centroids: torch.Tensor, device=dev_mod.DEFAULT) -> torch.Tensor:
    """Sum of squared errors (1): ``sum_i min_k ||x_i - c_k||^2``, through the
    assign-argmin kernel (accumulated in float64, returned as float32)."""
    dev = dev_mod.resolve(device)
    _, mind2 = kops.assign_argmin(_f32_on(x, dev), _f32_on(centroids, dev))
    return torch.sum(mind2, dtype=torch.float64).to(torch.float32)


def predict(x: torch.Tensor, centroids: torch.Tensor, device=dev_mod.DEFAULT) -> torch.Tensor:
    """Hard assignment of each point to its nearest centroid (int64 labels)."""
    dev = dev_mod.resolve(device)
    labels, _ = kops.assign_argmin(_f32_on(x, dev), _f32_on(centroids, dev))
    return labels.to(torch.int64)
