"""Compressive K-means — the user-facing API (paper §3.3), counterpart of
``repro.core.ckm``.

The pipeline is the paper's four steps:

1. choose a frequency scale sigma^2 on a small fraction of the data
   (``frequencies.estimate_sigma2``),
2. draw the frequency operator for ``m`` frequencies from the adapted-radius
   distribution (``core.freq_ops``: ``"dense"`` or ``"structured"``),
3. compute the sketch ``z = Sk(X, 1/N)`` in one pass through
   ``core.engine.SketchEngine`` (the operator family's fused CUDA kernel on
   the card), together with the box bounds ``l, u`` — float, or quantized
   to integer codes (QCKM, ``CKMConfig.sketch_quantization``) and
   dequantized before decoding,
4. decode K centroids from the sketch with a registered decoder (CLOMPR).

Replicates run one after another and the one with the lowest sketch-domain
cost (4) wins — the SSE is not available once the data is discarded.

Sharded fits (``sketch_backend="sharded"``, ``mesh=`` a ``DeviceMesh``): SPMD,
one process per device, each passing its own rows (or batches).  The sigma^2
sample is the first ``min(sigma2_sample, rows)`` rows of the mesh's rank 0
(the global first rows, which lie in its block), broadcast to every rank, so
every rank draws the same sigma^2 and operator; the sketch reduces over the
mesh's data axes; the decode runs once, on rank 0, and its centroids,
weights and cost are broadcast.  Every rank returns the same ``CKMResult``.
The ``"sample"``/``"kpp"`` inits draw from rank 0's own rows.

Randomness: a fit takes an integer ``seed``.  :func:`stream_keys` fans it out
into the sketch pass's three generators ``(sigma2, frequencies, dither)`` —
so turning quantization on does not move sigma^2 or the frequencies —
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
from repro_torch.core import quantize as qz
from repro_torch.core import topology as topo
from repro_torch.core.decoders import AMPConfig, CLOMPRConfig, SketchShiftConfig
from repro_torch.core.engine import SketchEngine
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class CKMConfig:
    """The fields of the reference's ``CKMConfig`` that this port honours.

    ``shift_impl`` and ``amp_impl`` have no counterpart (the tensor's device
    picks the kernel or its plain version).
    """

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
    # CUDA kernel (plain PyTorch version on the CPU), or "sharded", the same
    # kernels on each rank's rows and a reduction over a DeviceMesh passed to
    # fit()/compute_sketch() as mesh=.
    sketch_backend: str = "kernel"
    # Cross-device merge schedule of the sharded backend (and of host-level
    # reduce_partials): any name registered in core.topology — "allreduce"
    # (native all_reduce), "tree" (butterfly, log2 p hops), "ring" (token
    # passing).  Every topology produces the same sketch (bitwise when
    # quantized); the choice trades wire bytes vs hop count.
    reduce_topology: str = "allreduce"
    # Streaming ingest mode for fit_streaming: "sync" feeds the engine batch
    # by batch; "async" overlaps batch production and the host-to-device copy
    # with the sketch through core.ingest (a producer thread, pinned buffers
    # and a side stream on the card, ingest_prefetch batches staged).  The
    # same bits either way.
    ingest: str = "sync"
    ingest_prefetch: int = 2
    # Universal quantization of the sketch (QCKM): "none" | "1bit" | "<b>bit".
    # Per-point contributions become integer codes of the dithered phase,
    # summed in int32; finalize dequantizes (E[sign] correction) before the
    # decoder sees the sketch (see core.quantize).
    sketch_quantization: str = "none"
    # Exponential time decay of the sketch state (None = lifetime average): a
    # gamma in (0, 1] switches the engine to the timestamped state, whose
    # merges scale older content by gamma**dt (core.engine, core.window).
    decay: float | None = None
    # Sketch decoder (core.decoders registry): "clompr" (paper Algorithm 1),
    # "sketch_shift" (mean shift on the residual sketched density) or "amp"
    # (CL-AMP joint message passing, accurate at small m).
    decoder: str = "clompr"
    # sketch_shift knobs (nnls_iters, joint_lr and init above are shared).
    shift_candidates: int = 8  # mean-shift swarm size per cluster (P = 8*K)
    shift_steps: int = 150  # fixed-point iterations per round
    shift_step_scale: float = 1.0  # multiplier on the natural step h^2
    shift_polish_steps: int = 400  # joint (C, alpha) Adam after the rounds
    # Mode-harvest dedup radius in units of 1/median||omega|| (one kernel
    # std), deliberately tighter than clompr's merge_radius_scale.
    shift_dedup_scale: float = 1.0
    # amp (CL-AMP) knobs (nnls_iters, joint_lr and init above are shared).
    amp_iters: int = 300  # GAMP iterations
    amp_damp: float = 0.3  # damping on the message updates (1 = undamped)
    amp_polish_steps: int = 600  # joint (C, alpha) Adam after the loop
    # Decoder convergence tracing: the decoder also returns its per-iteration
    # trajectory (CLOMPR and sketch_shift: residual norms; amp: unexplained
    # energy and posterior variance), and decode_sketch emits the selected
    # replicate's series through repro_torch.obs.trace.  decode_sketch turns
    # it on by itself when telemetry is enabled.  The centroids are bitwise
    # those of an untraced decode.
    trace_convergence: bool = False

    def sketch_size(self, n: int) -> int:
        return self.m if self.m is not None else 10 * self.k * n

    def sketch_shift_config(self) -> SketchShiftConfig:
        return SketchShiftConfig(
            k=self.k,
            candidates=max(self.shift_candidates * self.k, self.k),
            shift_steps=self.shift_steps,
            step_scale=self.shift_step_scale,
            nnls_iters=self.nnls_iters,
            polish_steps=self.shift_polish_steps,
            polish_lr=self.joint_lr,
            init=self.init,
            dedup_radius_scale=self.shift_dedup_scale,
            trace=self.trace_convergence,
        )

    def amp_config(self) -> AMPConfig:
        return AMPConfig(
            k=self.k,
            iters=self.amp_iters,
            damp=self.amp_damp,
            nnls_iters=self.nnls_iters,
            polish_steps=self.amp_polish_steps,
            polish_lr=self.joint_lr,
            init=self.init,
            trace=self.trace_convergence,
        )

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
            trace=self.trace_convergence,
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
    each seeded from its own child of ``seed``, so a quantized run draws the
    same sigma^2 and frequencies as its float twin."""
    dev = dev_mod.resolve(device)
    return tuple(dev_mod.generator(dev_mod.derive_seed(seed, i), dev) for i in range(3))


def make_quantizer(seed: int, cfg: CKMConfig, m: int, device=dev_mod.DEFAULT):
    """The sketch quantizer for ``cfg`` (or ``None`` for the float path),
    drawn only from the dither generator of :func:`stream_keys`."""
    if qz.parse_bits(cfg.sketch_quantization) is None:
        return None
    _, _, g_dither = stream_keys(seed, device)
    return qz.make_quantizer(g_dither, m, cfg.sketch_quantization)


def make_engine(w, cfg: CKMConfig, device=dev_mod.DEFAULT, quantizer=None,
                mesh=None) -> SketchEngine:
    """The SketchEngine for ``cfg`` on ``device`` — backend, quantization,
    decay and the merge topology are config flags; ``mesh`` is the sharded
    backend's."""
    return SketchEngine(w, cfg.sketch_backend, device=device, mesh=mesh,
                        quantizer=quantizer, reduce_topology=cfg.reduce_topology,
                        decay=cfg.decay)


def _from_root(t: torch.Tensor | None, mesh, dtype, tail: tuple[int, ...], dev) -> torch.Tensor:
    """Rank 0's ``t`` (leading length, then ``tail``) on every rank of
    ``mesh``, as ``dtype``; other ranks pass ``None``.  The length travels
    first."""
    root = t is not None
    size = torch.tensor([t.shape[0] if root else 0], dtype=torch.int64, device=dev)
    size = topo.axis_broadcast(size, mesh, mesh.mesh_dim_names)
    buf = (t.to(dtype).contiguous() if root
           else torch.empty((int(size[0]), *tail), dtype=dtype, device=dev))
    return topo.axis_broadcast(buf, mesh, mesh.mesh_dim_names)


def _is_root(mesh) -> bool:
    return all(mesh.get_local_rank(a) == 0 for a in mesh.mesh_dim_names)


def _sigma2_sample(x: torch.Tensor, cfg: CKMConfig, mesh, dev) -> torch.Tensor:
    """The rows sigma^2 is estimated from: ``x`` itself on one device; on a
    mesh, rank 0's first ``min(sigma2_sample, rows)`` rows, on every rank."""
    if cfg.sketch_backend != "sharded" or cfg.sigma2 is not None:
        return x
    if mesh is None:
        raise ValueError("sketch_backend='sharded' requires a mesh")
    rows = x[: cfg.sigma2_sample] if _is_root(mesh) else None
    return _from_root(rows, mesh, torch.float32, (x.shape[1],), dev)


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


def compute_sketch(seed: int, x: torch.Tensor, cfg: CKMConfig, device=dev_mod.DEFAULT,
                   mesh=None):
    """Steps 1–3 -> ``(z, op, sigma2, (lower, upper))``.  Sharded: ``x`` is
    this rank's rows, and the result is the whole mesh's, on every rank."""
    dev = dev_mod.resolve(device)
    x = _f32_on(x, dev)
    op, sigma2 = _draw_freqs(seed, _sigma2_sample(x, cfg, mesh, dev), x.shape[1], cfg, dev)
    quantizer = make_quantizer(seed, cfg, op.m, dev)
    z, lo, hi = make_engine(op, cfg, dev, quantizer, mesh).sketch(x)
    return z, op, sigma2, (lo, hi)


def compute_sketch_streaming(
    seed: int, batches: Iterable[torch.Tensor], cfg: CKMConfig, device=dev_mod.DEFAULT,
    mesh=None,
):
    """One-pass sketch of a batch iterator.

    The first batch doubles as the sigma^2-estimation sample; every batch —
    the first included — is folded into the engine state, and the device is
    waited on after each fold so a batch may be dropped the moment it is in
    (the O(m)-memory contract).  ``cfg.ingest="async"`` folds the batches
    after the first through ``core.ingest.ingest_stream`` (same batches,
    same order, the same bits).  Returns ``(z, op, sigma2, (lower, upper),
    first_batch)``.  Sharded: the batches are this rank's, sigma^2 comes
    from rank 0's first batch, and every rank must fold the same number of
    batches (an empty one where it has no rows).
    """
    if cfg.ingest not in ("sync", "async"):
        raise ValueError(f"CKMConfig.ingest must be 'sync' or 'async', got {cfg.ingest!r}")
    dev = dev_mod.resolve(device)
    it = iter(batches)
    try:
        first = _f32_on(next(it), dev)
    except StopIteration:
        raise ValueError("compute_sketch_streaming needs at least one batch") from None
    op, sigma2 = _draw_freqs(seed, _sigma2_sample(first, cfg, mesh, dev), first.shape[1],
                             cfg, dev)
    eng = make_engine(op, cfg, dev, make_quantizer(seed, cfg, op.m, dev), mesh)
    state = eng.update(eng.init_state(), first)
    if cfg.ingest == "async":
        from repro_torch.core import ingest as ingest_mod

        state, _ = ingest_mod.ingest_stream(eng, it, state=state, prefetch=cfg.ingest_prefetch)
    else:
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
    *,
    eager: bool = False,
):
    """Step 4: decode with ``cfg.decoder``; of ``cfg.replicates`` runs, the one
    with the lowest cost (4) wins (the first on ties), so more replicates can
    never return a higher cost.  On the card the decoders' loops run as CUDA
    graphs; ``eager`` runs them eagerly (for comparisons only).

    Convergence tracing: with ``cfg.trace_convergence`` set, or telemetry
    enabled (``repro_torch.obs``), the decoder runs with its ``trace`` flag
    on and the selected replicate's series are emitted as
    ``decoder.<name>.<series>`` events on the default tracer.  The return
    contract stays ``(centroids, weights, cost)``.
    """
    from repro_torch.obs import runtime as obs_rt

    dev = dev_mod.resolve(device)
    if obs_rt.ENABLED and not cfg.trace_convergence:
        cfg = dataclasses.replace(cfg, trace_convergence=True)
    w = fo.as_operator(w).to(dev)
    z, lower, upper = (_f32_on(t, dev) for t in (z, lower, upper))
    if x_init is not None:
        x_init = _f32_on(x_init, dev)
    decode = dec_mod.get_decoder(cfg.decoder)
    best = None
    for r in range(cfg.replicates):
        gen = dev_mod.generator(dev_mod.derive_seed(seed, r), dev)
        out = decode(gen, z, w, lower, upper, cfg, x_init, eager=eager)
        if best is None or float(out[2]) < float(best[2]):
            best = out
    # A tracing decoder returns (cents, alphas, cost, {series}).
    if len(best) == 4 and obs_rt.ENABLED:
        from repro_torch.obs import trace as obs_trace

        for name, vals in best[3].items():
            obs_trace.series(f"decoder.{cfg.decoder}.{name}", vals.tolist(),
                             decoder=cfg.decoder)
    return best[:3]


def _decode_once(seed, z, op, lo, hi, cfg: CKMConfig, x_init, dev, mesh):
    """Step 4 of a fit: on one device, ``decode_sketch``; sharded, the decode
    runs on the mesh's rank 0 and its ``(centroids, weights, cost)`` are
    broadcast, so every rank returns the same bits."""
    if cfg.sketch_backend != "sharded":
        return decode_sketch(seed, z, op, lo, hi, cfg, x_init, dev)
    packed = None
    if _is_root(mesh):
        cents, alphas, cost = decode_sketch(seed, z, op, lo, hi, cfg, x_init, dev)
        packed = torch.cat([cents.reshape(-1), alphas, cost.reshape(1)])
    packed = _from_root(packed, mesh, torch.float32, (), dev)
    n = lo.shape[0]
    k = (packed.shape[0] - 1) // (n + 1)
    return packed[: k * n].reshape(k, n), packed[k * n : k * n + k], packed[-1]


def fit(seed: int, x: torch.Tensor, cfg: CKMConfig, device=dev_mod.DEFAULT,
        mesh=None) -> CKMResult:
    """End-to-end compressive K-means on an in-memory dataset (sharded: this
    rank's rows; see the module doc)."""
    dev = dev_mod.resolve(device)
    x = _f32_on(x, dev)
    z, op, sigma2, (lo, hi) = compute_sketch(dev_mod.derive_seed(seed, 0), x, cfg, dev, mesh)
    x_init = x if cfg.init in ("sample", "kpp") else None
    cents, alphas, cost = _decode_once(
        dev_mod.derive_seed(seed, 1), z, op, lo, hi, cfg, x_init, dev, mesh
    )
    return CKMResult(cents, alphas, cost, sigma2, op, z, (lo, hi))


def fit_streaming(
    seed: int, batches: Iterable[torch.Tensor], cfg: CKMConfig, device=dev_mod.DEFAULT,
    mesh=None,
) -> CKMResult:
    """End-to-end CKM over an iterator of ``(B_i, n)`` batches: one pass, O(m)
    memory.  The "sample"/"kpp" inits draw from the first batch only (rank
    0's, sharded)."""
    dev = dev_mod.resolve(device)
    z, op, sigma2, (lo, hi), first = compute_sketch_streaming(
        dev_mod.derive_seed(seed, 0), batches, cfg, dev, mesh
    )
    x_init = first if cfg.init in ("sample", "kpp") else None
    cents, alphas, cost = _decode_once(
        dev_mod.derive_seed(seed, 1), z, op, lo, hi, cfg, x_init, dev, mesh
    )
    return CKMResult(cents, alphas, cost, sigma2, op, z, (lo, hi))


def diagnose(result: CKMResult, **kwargs):
    """Attribute a (possibly bad) fit to sketch size m, frequency scale
    sigma, or the decoder — ``repro_torch.obs.diagnose.diagnose`` at the
    pipeline API (``ckm.diagnose(ckm.fit(...))``).  Data-free: the probe
    decodes run on the result's own sketch, on its device; see
    :mod:`repro_torch.obs.diagnose` for the parameters and the verdicts.
    """
    from repro_torch.obs.diagnose import diagnose as obs_diagnose

    return obs_diagnose(result, **kwargs)


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
