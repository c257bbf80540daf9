"""The port's sketch-health diagnostics (``repro_torch.obs.diagnose`` and
``ckm.diagnose``): each building block held against the reference's on
shared numpy centroids, weights and a dense operator drawn by the reference
(to 1e-5; ``matched_distance`` exactly), the verdict precedence driven from
a table of scores, seeded failure modes on the port, the data-backed sigma
sweep and the telemetry the diagnosis emits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.obs as tobs
from repro.core import freq_ops as jfo
from repro.core import sketch as jsk
from repro.obs.diagnose import _rel_residual as j_rel_residual
from repro.obs.diagnose import _subsketch as j_subsketch
from repro.obs.diagnose import matched_distance as j_matched_distance
from repro.obs.diagnose import model_sketch as j_model_sketch
from repro.obs.diagnose import sketch_drift as j_sketch_drift
from repro_torch import convert
from repro_torch.core import ckm
from repro_torch.obs.diagnose import (
    VERDICTS,
    _cf_profile,
    _rel_residual,
    _subsketch,
    matched_distance,
    model_sketch,
    sigma_sweep,
    sketch_drift,
    verdict_of,
)

pytestmark = pytest.mark.torch_port

TOL = 1e-5  # float32 atoms and norms of (2m,) vectors, summed in two orders
K, N, M = 3, 4, 48


@pytest.fixture(autouse=True)
def _clean_obs():
    tobs.disable()
    tobs.reset()
    yield
    tobs.disable()
    tobs.reset()


@pytest.fixture(scope="module")
def shared():
    """A reference-drawn dense operator, centroids, weights and a sketch of
    points near the centroids, as numpy."""
    op = jfo.make_operator("dense", jax.random.PRNGKey(3), M, N, jnp.asarray(0.8))
    rng = np.random.default_rng(11)
    cents = rng.standard_normal((K, N)).astype(np.float32) * 2.0
    wts = rng.dirichlet(np.ones(K)).astype(np.float32)
    pts = (cents[rng.integers(0, K, 500)] + 0.3 * rng.standard_normal((500, N))).astype(
        np.float32)
    z = np.array(jsk.sketch(jnp.asarray(pts), op))
    return np.array(op.w), cents, wts, z, op


def _port_op(w):
    return convert.operator_from_numpy(w, device="cpu")


def test_model_sketch_drift_and_residual_match_the_reference(shared):
    w, cents, wts, z, jop = shared
    op = _port_op(w)
    np.testing.assert_allclose(model_sketch(cents, wts, op).numpy(),
                               np.asarray(j_model_sketch(cents, wts, jop)), atol=TOL, rtol=0)
    assert sketch_drift(z, cents, wts, op) == pytest.approx(
        j_sketch_drift(z, cents, wts, jop), abs=TOL)
    assert _rel_residual(z, cents, wts, op) == pytest.approx(
        j_rel_residual(z, cents, wts, jop), abs=TOL)
    # Raw (n, m) matrices are wrapped as dense operators on both sides.
    assert sketch_drift(z, cents, wts, torch.from_numpy(w)) == pytest.approx(
        sketch_drift(z, cents, wts, op), abs=0)


def test_subsketch_matches_the_reference(shared):
    w, _, _, z, _ = shared
    idx = np.random.default_rng(2).permutation(M)[: M // 2]
    z_s, w_s = _subsketch(torch.from_numpy(z), torch.from_numpy(w), torch.from_numpy(idx))
    jz_s, jw_s = j_subsketch(jnp.asarray(z), jnp.asarray(w), jnp.asarray(idx))
    np.testing.assert_array_equal(z_s.numpy(), np.asarray(jz_s))
    np.testing.assert_array_equal(w_s.numpy(), np.asarray(jw_s))


@pytest.mark.parametrize("m", [48, 49])  # even m: median between two middles
def test_cf_profile_matches_the_reference(m):
    jop = jfo.make_operator("dense", jax.random.PRNGKey(4), m, N, jnp.asarray(1.3))
    z = np.random.default_rng(m).uniform(-0.7, 0.7, 2 * m).astype(np.float32)
    # The reference's profile, as its diagnose computes it.
    moduli = jnp.abs(jsk.to_complex(jnp.asarray(z)))
    norms = jop.col_norms()
    med = jnp.median(norms)
    want = (float(jnp.mean(moduli)),
            float(jnp.mean(jnp.where(norms <= med, moduli, 0.0))) * 2.0,
            float(jnp.mean(jnp.where(norms > med, moduli, 0.0))) * 2.0)
    got = _cf_profile(torch.from_numpy(z), _port_op(np.asarray(jop.w)).col_norms())
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_matched_distance_is_the_reference_exactly():
    rng = np.random.default_rng(7)
    for k in (1, 3, 6):
        a, b = rng.standard_normal((k, 3)), rng.standard_normal((k, 3))
        wa = rng.uniform(0.1, 1.0, k)
        assert matched_distance(a, b) == j_matched_distance(a, b)
        assert matched_distance(a, b, wa) == j_matched_distance(a, b, wa)
    assert matched_distance(a, a) == 0.0


def test_zero_live_sketch_drift_is_defined(shared):
    w, cents, wts, _, _ = shared
    s = sketch_drift(np.zeros(2 * M, np.float32), cents, wts, _port_op(w))
    assert s == 0.0 and not np.isnan(s)


# -- the verdict precedence ------------------------------------------------------


def _scores(mod=0.4, res=0.2, probe=0.19, dis=0.01):
    return {"mean_modulus": mod, "rel_residual": res, "probe_rel_residual": probe,
            "subsketch_disagreement": dis}


@pytest.mark.parametrize("scores,verdict,direction,says", [
    (_scores(), "ok", None, "no failure"),
    (_scores(mod=0.95), "frequency_scale", "sigma2_too_large", "decrease sigma2"),
    (_scores(mod=0.01), "frequency_scale", "sigma2_too_small", "increase sigma2"),
    # sigma outranks the decoder and m
    (_scores(mod=0.95, res=0.9, probe=0.1, dis=0.5), "frequency_scale", "sigma2_too_large",
     "decrease"),
    (_scores(res=0.6, probe=0.2), "decoder", None, "probe reached 0.200"),
    # the decoder outranks m
    (_scores(res=0.6, probe=0.2, dis=0.5), "decoder", None, "re-decode"),
    # the ratio holds but not the margin, and the margin but not the ratio
    (_scores(res=0.03, probe=0.01), "ok", None, "no failure"),
    (_scores(res=0.5, probe=0.4), "ok", None, "no failure"),
    (_scores(dis=0.25), "sketch_size", None, "disagree by 0.25"),
    # the band and the threshold are open at their edges
    (_scores(mod=0.9, dis=0.1), "ok", None, "no failure"),
    (_scores(mod=0.05), "ok", None, "no failure"),
])
def test_verdict_precedence_from_scores(scores, verdict, direction, says):
    got, got_dir, rec = verdict_of(scores)
    assert (got, got_dir) == (verdict, direction)
    assert says in rec and got in VERDICTS


def test_verdict_thresholds_are_the_callers():
    s = _scores(mod=0.5, res=0.2, probe=0.19, dis=0.05)
    assert verdict_of(s, modulus_high=0.45)[0] == "frequency_scale"
    assert verdict_of(s, modulus_low=0.6)[1] == "sigma2_too_small"
    assert verdict_of(s, disagreement_threshold=0.04)[0] == "sketch_size"
    assert verdict_of(s, decoder_blame_ratio=1.01, decoder_blame_margin=0.0)[0] == "decoder"


# -- seeded failure modes, on the port --------------------------------------------


def _blobs3(n_pts=3000):
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((3, 2)) * 6.0
    idx = rng.integers(0, 3, n_pts)
    return torch.from_numpy(
        (centers[idx] + 0.3 * rng.standard_normal((n_pts, 2))).astype(np.float32))


GOOD = ckm.CKMConfig(k=3, m=60, decoder="sketch_shift", shift_steps=60,
                     shift_polish_steps=200, nnls_iters=80)
BASE = dict(k=3, m=60, atom_steps=60, joint_steps=40, nnls_iters=60, final_steps=120)


@pytest.fixture(scope="module")
def good_fit():
    return ckm.fit(1, _blobs3(), GOOD, device="cpu")


def test_converged_fit_is_ok(good_fit):
    d = ckm.diagnose(good_fit, probe_budget=0.4)
    assert d.verdict == "ok" and d.ok
    assert set(d.scores) == {"rel_residual", "probe_rel_residual", "mean_modulus",
                             "subsketch_disagreement", "m_per_kn"}
    assert [h["m"] for h in d.details["m_sweep"]] == [30, 30]
    assert d.details["sigma_profile"]["direction"] is None


@pytest.mark.parametrize("scale,direction,word", [(1e4, "sigma2_too_large", "decrease"),
                                                   (1e-4, "sigma2_too_small", "increase")])
def test_mis_scaled_sigma_is_frequency_scale(good_fit, scale, direction, word):
    res = ckm.fit(1, _blobs3(), ckm.CKMConfig(**{**BASE, "sigma2": scale * float(good_fit.sigma2)}),
                  device="cpu")
    d = ckm.diagnose(res, probe_budget=0.4)
    assert d.verdict == "frequency_scale"
    assert d.details["sigma_profile"]["direction"] == direction
    assert word in d.recommendation
    assert (d.scores["mean_modulus"] > 0.9) == (direction == "sigma2_too_large")


def test_lazy_decoder_is_blamed():
    lazy = ckm.fit(1, _blobs3(), ckm.CKMConfig(k=3, m=60, atom_steps=1, joint_steps=1,
                                               nnls_iters=2, final_steps=0), device="cpu")
    d = ckm.diagnose(lazy, probe_budget=0.4)
    assert d.verdict == "decoder"
    assert d.scores["rel_residual"] > 1.5 * d.scores["probe_rel_residual"]


def test_tiny_sketch_halves_disagree():
    """At m = 8 the verdict follows the probe draws (the decoder outranks
    the sketch size); the score that blames m is held alone."""
    small = ckm.fit(1, _blobs3(), ckm.CKMConfig(**{**BASE, "m": 8}), device="cpu")
    d = ckm.diagnose(small, probe_budget=0.4)
    assert d.scores["subsketch_disagreement"] > 0.1
    assert [h["m"] for h in d.details["m_sweep"]] == [4, 4]


def test_diagnose_is_deterministic_per_seed(good_fit):
    a = ckm.diagnose(good_fit, probe_budget=0.2, seed=3)
    b = ckm.diagnose(good_fit, probe_budget=0.2, seed=3)
    assert a.scores == b.scores and a.verdict == b.verdict


def test_sigma_sweep_rows(good_fit):
    d = ckm.diagnose(good_fit, probe_budget=0.3, sample=_blobs3()[:512])
    rows = d.details["sigma_sweep"]
    assert [r["factor"] for r in rows] == [0.1, 1.0, 10.0]
    assert [r["sigma2"] for r in rows] == [f * float(good_fit.sigma2) for f in (0.1, 1.0, 10.0)]
    assert rows[1]["healthy"]
    assert rows[2]["mean_modulus"] > rows[1]["mean_modulus"] > rows[0]["mean_modulus"]
    again = sigma_sweep(_blobs3()[:512], good_fit, seed=0, m_probe=30)
    assert len(again) == 3 and all(np.isfinite(r["mean_modulus"]) for r in again)


def test_diagnose_emits_instruments(good_fit):
    fast = dataclasses.replace(GOOD, shift_steps=10, shift_polish_steps=20, nnls_iters=10)
    tobs.enable()
    d = ckm.diagnose(good_fit, probe=fast)
    tobs.disable()
    snap = tobs.snapshot()
    assert snap[f"diagnose.verdicts{{verdict={d.verdict}}}"] == 1
    assert snap["diagnose.mean_modulus"] == pytest.approx(d.scores["mean_modulus"])
    assert snap["diagnose.subsketch_disagreement"] == d.scores["subsketch_disagreement"]
    spans = tobs.TRACER.spans("ckm.diagnose")
    assert len(spans) == 1 and spans[0]["attrs"] == {"m": 60, "k": 3}
    points = [e for e in tobs.TRACER.events if e["kind"] == "point"]
    assert [(p["name"], p["value"]) for p in points] == [
        ("diagnose.verdict", VERDICTS.index(d.verdict))]


def test_diagnose_records_nothing_when_disabled(good_fit):
    fast = dataclasses.replace(GOOD, shift_steps=10, shift_polish_steps=20, nnls_iters=10)
    ckm.diagnose(good_fit, probe=fast)
    assert tobs.snapshot() == {} and tobs.TRACER.events == []


def test_exports_match_the_reference():
    import repro.obs as jobs
    from repro import core as jcore
    from repro_torch import core as tcore

    names = {"Diagnosis", "diagnose", "sketch_drift", "model_sketch", "matched_distance",
             "sigma_sweep"}
    assert names <= set(jobs.__all__) and names <= set(tobs.__all__)
    assert "diagnose" in jcore.__all__ and "diagnose" in tcore.__all__
    assert tcore.diagnose is ckm.diagnose
