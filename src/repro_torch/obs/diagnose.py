"""Sketch-health diagnostics: blame the sketch, the scale, or the decoder
(counterpart of ``repro.obs.diagnose``).

"When compressive learning fails" (Schellekens & Jacques, 2020) observes
that a bad compressive fit has exactly three root causes, and that they are
distinguishable *from the sketch alone*:

- **sketch size m too small** — the inverse problem is under-determined:
  probe decodes from disjoint frequency subsets of the same sketch land on
  wildly different centroid sets.
- **frequency scale mis-set** — the CF moduli ``|psi(w_j)|`` are ~1 across
  frequencies (sigma^2 over-estimated) or at the empirical noise floor
  (sigma^2 under-estimated).  O(m) to test.
- **decoder failure** — a cheap, well-converged probe decode
  (``sketch_shift``, kernel 6 on the card) reaches a materially lower sketch
  residual than the result's.

:func:`diagnose` runs those three probes on a ``ckm.CKMResult`` (data-free;
pass ``sample=`` to add the re-sketching :func:`sigma_sweep`, kernel 1 on
the card) and returns a :class:`Diagnosis`.  The verdict's precedence lives
in :func:`verdict_of`, a pure function of the scores.

:func:`sketch_drift` is the O(m) drift score ``FleetService.drift`` emits.

Randomness: the reference's PRNG ``key`` is an integer ``seed``.  The probe
decode draws from ``derive_seed(seed, 0)``; the half-sketch split from a CPU
generator seeded with ``derive_seed(seed, 1)`` (the same halves on every
device), and half ``s`` decodes under ``derive_seed(derive_seed(seed, 1), s)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as dev_mod

__all__ = [
    "Diagnosis",
    "diagnose",
    "model_sketch",
    "sketch_drift",
    "matched_distance",
    "sigma_sweep",
]

VERDICTS = ("ok", "sketch_size", "frequency_scale", "decoder")


@dataclasses.dataclass
class Diagnosis:
    """Outcome of :func:`diagnose` — one verdict, with its evidence.

    ``verdict`` is one of ``VERDICTS``; ``scores`` holds the scalar evidence
    (residuals, CF moduli, subset disagreement); ``details`` the per-probe
    sweep tables; ``recommendation`` a one-line operator hint.
    """

    verdict: str
    scores: dict
    details: dict
    recommendation: str

    @property
    def ok(self) -> bool:
        return self.verdict == "ok"


def model_sketch(centroids, weights, w) -> torch.Tensor:
    """Re-sketch a decoded model: ``sum_k alpha_k A delta_{c_k}`` (2m,), on
    the centroids' device."""
    from repro_torch.core import freq_ops as fo
    from repro_torch.core import sketch as sk

    c = torch.as_tensor(centroids, dtype=torch.float32)
    op = fo.as_operator(w).to(c.device)
    a = torch.as_tensor(weights, dtype=torch.float32).to(c.device)
    return a @ sk.atoms(c, op)


def sketch_drift(z_live, centroids, weights, w) -> float:
    """O(m) drift score: ``||z_live - z_model|| / ||z_live||`` between a
    live window's sketch and the decoded model's re-sketched centroids.

    Scale-free: ~0 on a stationary stream, O(1) once the stream moves away
    from the decoded model.  An all-zero live sketch (an empty or fully
    decayed state) scores a defined 0.0, not 0/0.
    """
    z_model = model_sketch(centroids, weights, w)
    z_live = torch.as_tensor(z_live, dtype=torch.float32).to(z_model.device)
    num = torch.linalg.vector_norm(z_live - z_model)
    den = torch.linalg.vector_norm(z_live)
    return float(torch.where(den > 0, num / torch.clamp(den, min=1e-12), 0.0))


def matched_distance(a, b, weights_a=None) -> float:
    """Greedy-matched mean displacement between two centroid sets.

    Repeatedly pair the globally closest remaining (a_i, b_j), optionally
    weighting each pair by ``weights_a[i]`` (uniform when omitted).
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    wa = (
        np.full((a.shape[0],), 1.0 / a.shape[0])
        if weights_a is None
        else np.asarray(weights_a, np.float64)
    )
    d = np.linalg.norm(a[:, None] - b[None], axis=-1)
    moved, used = 0.0, d.copy()
    for _ in range(a.shape[0]):
        i, j = np.unravel_index(np.argmin(used), used.shape)
        moved += wa[i] * d[i, j]
        used[i, :] = np.inf
        used[:, j] = np.inf
    return float(moved / max(wa.sum(), 1e-9))


def _rel_residual(z, centroids, weights, w) -> float:
    z = torch.as_tensor(z, dtype=torch.float32)
    r = z - model_sketch(centroids, weights, w).to(z.device)
    denom = torch.clamp(torch.linalg.vector_norm(z), min=1e-12)
    return float(torch.linalg.vector_norm(r) / denom)


def _default_probe_config(k: int, probe_budget: float):
    from repro_torch.core import ckm as ckm_mod

    s = max(probe_budget, 0.05)
    return ckm_mod.CKMConfig(
        k=k,
        decoder="sketch_shift",
        shift_steps=max(int(150 * s), 10),
        shift_polish_steps=max(int(400 * s), 20),
        nnls_iters=max(int(150 * s), 10),
    )


def _subsketch(z, w_mat, idx):
    """Restrict a stacked-real sketch and a dense ``(n, m)`` frequency matrix
    to a subset of frequencies — a valid smaller sketch of the same data."""
    m = w_mat.shape[1]
    z_sub = torch.cat([z[:m][idx], z[m:][idx]])
    return z_sub, w_mat[:, idx]


def _cf_profile(z, norms) -> tuple[float, float, float]:
    """``(mean, low-band, high-band)`` CF modulus of a stacked-real sketch;
    the bands split the frequencies at the median of ``norms``."""
    from repro_torch.core import sketch as sk
    from repro_torch.core.decoders.common import median

    moduli = torch.abs(sk.to_complex(z))
    med = median(norms)
    zero = torch.zeros_like(moduli)
    low = float(torch.mean(torch.where(norms <= med, moduli, zero))) * 2.0
    high = float(torch.mean(torch.where(norms > med, moduli, zero))) * 2.0
    return float(torch.mean(moduli)), low, high


def sigma_sweep(
    sample,
    result,
    *,
    seed: int | None = None,
    factors=(0.1, 1.0, 10.0),
    m_probe: int | None = None,
) -> list[dict]:
    """Re-sketch ``sample`` at ``sigma2 = factor * result.sigma2`` and report
    each scale's CF-modulus health, on the result's device.

    Operator ``i`` is drawn from ``derive_seed(seed, i)``; the sketch goes
    through ``SketchEngine`` (kernel 1 on the card).  Returns one row per
    factor: ``{factor, sigma2, mean_modulus, healthy}``, healthy meaning the
    moduli land in the informative mid-band.
    """
    from repro_torch.core import freq_ops as fo
    from repro_torch.core import sketch as sk
    from repro_torch.core.engine import SketchEngine

    seed = 0 if seed is None else int(seed)
    dev = result.sketch.device
    x = torch.as_tensor(sample, dtype=torch.float32).to(dev).contiguous()
    n = x.shape[1]
    m = int(m_probe) if m_probe is not None else int(result.freq_op.m)
    rows = []
    for i, factor in enumerate(factors):
        sigma2 = float(result.sigma2) * float(factor)
        op = fo.make_operator(
            "dense", dev_mod.generator(dev_mod.derive_seed(seed, i), dev), m, n,
            torch.tensor(sigma2, dtype=torch.float32, device=dev), device=dev,
        )
        z, _, _ = SketchEngine(op, device=dev).sketch(x)
        mod = float(torch.mean(torch.abs(sk.to_complex(z))))
        rows.append(
            {
                "factor": float(factor),
                "sigma2": sigma2,
                "mean_modulus": mod,
                "healthy": bool(0.05 <= mod <= 0.9),
            }
        )
    return rows


def verdict_of(
    scores: dict,
    *,
    modulus_high: float = 0.9,
    modulus_low: float = 0.05,
    decoder_blame_ratio: float = 1.5,
    decoder_blame_margin: float = 0.05,
    disagreement_threshold: float = 0.1,
) -> tuple[str, str | None, str]:
    """``(verdict, sigma direction, recommendation)`` from the scores
    ``mean_modulus``, ``rel_residual``, ``probe_rel_residual`` and
    ``subsketch_disagreement`` alone.

    Precedence: ``frequency_scale`` (the sketch itself is uninformative),
    then ``decoder`` (the sketch supports a better fit than the one
    reported), then ``sketch_size`` (no decode from this few frequencies is
    identifiable), else ``ok``.  The direction is ``"sigma2_too_large"``,
    ``"sigma2_too_small"`` or None.
    """
    mean_mod = scores["mean_modulus"]
    rel_res, rel_res_probe = scores["rel_residual"], scores["probe_rel_residual"]
    disagreement = scores["subsketch_disagreement"]
    direction = None
    if mean_mod > modulus_high:
        direction = "sigma2_too_large"
    elif mean_mod < modulus_low:
        direction = "sigma2_too_small"
    decoder_blamed = (
        rel_res > rel_res_probe * decoder_blame_ratio
        and rel_res > rel_res_probe + decoder_blame_margin
    )
    if direction is not None:
        return "frequency_scale", direction, (
            "decrease sigma2 (frequencies sample the flat top of the "
            "characteristic function)"
            if direction == "sigma2_too_large"
            else "increase sigma2 (frequencies sample past the CF decay "
            "— the sketch is at the noise floor)"
        )
    if decoder_blamed:
        return "decoder", direction, (
            "re-decode with a larger iteration budget or another "
            f"registered decoder (probe reached {rel_res_probe:.3f} "
            f"relative residual vs the result's {rel_res:.3f})"
        )
    if disagreement > disagreement_threshold:
        return "sketch_size", direction, (
            "increase m (disjoint half-sketch decodes disagree by "
            f"{disagreement:.2f} of the box diagonal — the inverse "
            "problem is not identifiable at this sketch size)"
        )
    return "ok", direction, "no failure signature detected"


def diagnose(
    result,
    *,
    seed: int | None = None,
    probe=None,
    sample=None,
    probe_budget: float = 1.0,
    modulus_high: float = 0.9,
    modulus_low: float = 0.05,
    decoder_blame_ratio: float = 1.5,
    decoder_blame_margin: float = 0.05,
    disagreement_threshold: float = 0.1,
) -> Diagnosis:
    """Attribute a (possibly bad) compressive fit to m, sigma, or the decoder.

    Parameters
    ----------
    result : a ``ckm.CKMResult`` (the sketch, operator, bounds and decoded
        model it carries are all the evidence needed — no data access).  The
        probes run on the device of its sketch.
    seed : integer seed of the probe decodes and the half split (default 0).
    probe : optional ``CKMConfig`` for the probe decoder (default: a
        ``sketch_shift`` config scaled by ``probe_budget``).
    sample : optional ``(N, n)`` data sample; adds the re-sketching
        :func:`sigma_sweep` rows to ``details``.
    probe_budget : scale on the default probe's iteration budgets.
    modulus_high / modulus_low : the CF-modulus band outside which the
        frequency scale is declared mis-set (low is meaningful only above
        the empirical noise floor ~``1/sqrt(2N)``).
    decoder_blame_ratio / decoder_blame_margin : the probe must beat the
        result's relative residual by both this factor and this absolute
        margin to blame the decoder.
    disagreement_threshold : box-normalised matched-centroid disagreement
        between disjoint half-sketch decodes above which m is blamed.

    Returns a :class:`Diagnosis`; the verdict's precedence is
    :func:`verdict_of`'s.  The half-sketch probes decode on dense ``(n,
    m/2)`` matrices cut from ``op.materialize()``.
    """
    from repro_torch.core import ckm as ckm_mod
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import runtime as obs_rt
    from repro_torch.obs import trace as obs_trace

    seed = 0 if seed is None else int(seed)
    z = result.sketch.to(torch.float32)
    dev = z.device
    op = result.freq_op
    lo, hi = result.bounds
    k = int(result.centroids.shape[0])
    m = int(op.m)
    box_diag = float(torch.clamp(torch.linalg.vector_norm(hi - lo), min=1e-12))
    if probe is None:
        probe = _default_probe_config(k, probe_budget)

    with obs_trace.span("ckm.diagnose", m=m, k=k):
        # -- 1. CF-modulus health: O(m), no decode needed. ------------------
        mean_mod, low_band, high_band = _cf_profile(z, op.col_norms())

        # -- 2. Decoder probe: can a converged cheap decode beat the result?
        rel_res = _rel_residual(z, result.centroids, result.weights, op)
        seed_probe, seed_sub = dev_mod.derive_seed(seed, 0), dev_mod.derive_seed(seed, 1)
        p_cents, p_alpha, _ = ckm_mod.decode_sketch(seed_probe, z, op, lo, hi, probe,
                                                    device=dev)
        rel_res_probe = _rel_residual(z, p_cents, p_alpha, op)

        # -- 3. m sweep: probe decodes from disjoint half-sketches. ---------
        w_mat = op.materialize()
        perm = torch.randperm(m, generator=torch.Generator().manual_seed(seed_sub)).to(dev)
        half = max(m // 2, 1)
        halves = []
        for s in range(2):
            idx = perm[s * half : (s + 1) * half]
            z_s, w_s = _subsketch(z, w_mat, idx)
            c_s, a_s, _ = ckm_mod.decode_sketch(
                dev_mod.derive_seed(seed_sub, s), z_s, w_s, lo, hi, probe, device=dev
            )
            halves.append(
                {
                    "m": int(idx.shape[0]),
                    "centroids": c_s.cpu().numpy(),
                    "rel_residual": _rel_residual(z_s, c_s, a_s, w_s),
                }
            )
        disagreement = matched_distance(
            halves[0]["centroids"], halves[1]["centroids"]
        ) / box_diag

        scores = {
            "rel_residual": rel_res,
            "probe_rel_residual": rel_res_probe,
            "mean_modulus": mean_mod,
            "subsketch_disagreement": disagreement,
            "m_per_kn": m / max(k * int(op.n), 1),
        }
        verdict, direction, recommendation = verdict_of(
            scores, modulus_high=modulus_high, modulus_low=modulus_low,
            decoder_blame_ratio=decoder_blame_ratio,
            decoder_blame_margin=decoder_blame_margin,
            disagreement_threshold=disagreement_threshold,
        )
        details: dict = {
            "sigma_profile": {
                "mean_modulus": mean_mod,
                "low_band_modulus": low_band,
                "high_band_modulus": high_band,
                "direction": direction,
            },
            "m_sweep": [
                {"m": h["m"], "rel_residual": h["rel_residual"]} for h in halves
            ],
        }
        if sample is not None:
            details["sigma_sweep"] = sigma_sweep(sample, result, seed=seed)

    if obs_rt.ENABLED:
        obs_metrics.gauge("diagnose.rel_residual").set(rel_res)
        obs_metrics.gauge("diagnose.subsketch_disagreement").set(disagreement)
        obs_metrics.gauge("diagnose.mean_modulus").set(mean_mod)
        obs_metrics.counter("diagnose.verdicts", verdict=verdict).inc()
        obs_trace.point("diagnose.verdict", VERDICTS.index(verdict), verdict=verdict)

    return Diagnosis(
        verdict=verdict,
        scores=scores,
        details=details,
        recommendation=recommendation,
    )
