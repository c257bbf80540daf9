"""The port's pipeline end to end on the blobs fixture, against the reference:
CLOMPR decoding the reference's sketch, the port's own fit and streaming fit,
the evaluation helpers, and the device rule of the entry points."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import ckm as jckm
from repro.data import synthetic as jsynth
from repro_torch import convert
from repro_torch.core import ckm as tckm
from repro_torch.core.decoders.clompr import clompr as tclompr
from repro_torch.data import synthetic as tsynth

pytestmark = pytest.mark.torch_port

# The README quickstart's small decoder budgets.
SMALL = dict(atom_steps=40, joint_steps=30, nnls_iters=40, final_steps=60)


@pytest.fixture(scope="module")
def reference_fit(gaussian_blobs):
    """The reference's fit of the blobs: its sketch, W, bounds and SSE."""
    x, _, _ = gaussian_blobs
    res = jckm.fit(jax.random.PRNGKey(2), x, jckm.CKMConfig(k=5, replicates=2, **SMALL))
    return torch.from_numpy(np.array(x)), res, float(jckm.sse(x, res.centroids))


def _reference_sketch(res):
    op = convert.operator_from_numpy(np.asarray(res.frequencies), device="cpu")
    z = torch.from_numpy(np.array(res.sketch))
    lo, hi = (torch.from_numpy(np.array(b)) for b in res.bounds)
    return z, op, lo, hi


def test_clompr_decodes_the_reference_sketch(reference_fit):
    """The port's CLOMPR on the reference's sketch and W: SSE <= 1.05x the
    reference's own decode (best of two replicates on both sides)."""
    x, res, sse_ref = reference_fit
    z, op, lo, hi = _reference_sketch(res)
    cfg = tckm.CKMConfig(k=5, replicates=2, **SMALL)
    cents, alphas, cost = tckm.decode_sketch(7, z, op, lo, hi, cfg, device="cpu")
    assert cents.shape == (5, 4) and float(alphas.sum()) == pytest.approx(1.0, abs=1e-5)
    assert np.isfinite(float(cost))
    sse = float(tckm.sse(x, cents, device="cpu"))
    assert sse <= 1.05 * sse_ref, (sse, sse_ref)


def test_clompr_replicates_are_monotone(reference_fit):
    """Replicate r draws from its own child seed, so adding replicates can
    only lower the selected cost."""
    _, res, _ = reference_fit
    z, op, lo, hi = _reference_sketch(res)
    costs = [
        float(tckm.decode_sketch(
            3, z, op, lo, hi, tckm.CKMConfig(k=5, replicates=r, **SMALL), device="cpu"
        )[2])
        for r in (1, 2)
    ]
    assert costs[1] <= costs[0]


@pytest.mark.parametrize("init", ["sample", "kpp"])
def test_clompr_data_inits_recover_the_blobs(reference_fit, init):
    x, res, sse_ref = reference_fit
    z, op, lo, hi = _reference_sketch(res)
    cfg = tckm.CKMConfig(k=5, init=init, **SMALL).clompr_config()
    cents, _, _ = tclompr(torch.Generator().manual_seed(0), z, op, lo, hi, cfg, x[:2000])
    assert float(tckm.sse(x, cents, device="cpu")) <= 1.05 * sse_ref


def test_fit_matches_reference_quality(reference_fit):
    """The port's own sigma^2, frequencies, sketch and decode: SSE <= 1.05x
    the reference's fit with the same budgets."""
    x, _, sse_ref = reference_fit
    res = tckm.fit(5, x, tckm.CKMConfig(k=5, replicates=2, **SMALL), device="cpu")
    assert res.centroids.shape == (5, 4) and res.sketch.shape == (2 * 200,)
    assert res.frequencies.shape == (4, 200)
    assert float(tckm.sse(x, res.centroids, device="cpu")) <= 1.05 * sse_ref


def test_fit_streaming_sketch_equals_in_memory_sketch(reference_fit):
    """Same seed, same points, other batch boundaries: the same sigma^2 and
    frequencies (the first batch holds the sigma^2 sample) and a sketch
    equal to float rounding."""
    x, _, sse_ref = reference_fit
    cfg = tckm.CKMConfig(k=5, replicates=2, **SMALL)
    z, op, sigma2, (lo, hi) = tckm.compute_sketch(11, x, cfg, device="cpu")
    zs, ops, sigma2s, (los, his), first = tckm.compute_sketch_streaming(
        11, torch.split(x, 2500), cfg, device="cpu"
    )
    assert float(sigma2) == float(sigma2s) and torch.equal(op.materialize(), ops.materialize())
    np.testing.assert_allclose(zs.numpy(), z.numpy(), atol=1e-5)
    assert torch.equal(lo, los) and torch.equal(hi, his) and first.shape == (2500, 4)
    res = tckm.fit_streaming(5, torch.split(x, 2500), cfg, device="cpu")
    assert float(tckm.sse(x, res.centroids, device="cpu")) <= 1.05 * sse_ref
    with pytest.raises(ValueError, match="at least one batch"):
        tckm.compute_sketch_streaming(0, [], cfg, device="cpu")


def test_sse_and_predict_match_reference(reference_fit):
    x, res, _ = reference_fit
    cents = np.array(res.centroids)
    xj = jax.numpy.asarray(x.numpy())
    assert float(tckm.sse(x, torch.from_numpy(cents), device="cpu")) == pytest.approx(
        float(jckm.sse(xj, res.centroids)), rel=1e-5
    )
    np.testing.assert_array_equal(
        tckm.predict(x, torch.from_numpy(cents), device="cpu").numpy(),
        np.asarray(jckm.predict(xj, res.centroids)),
    )


def test_stream_keys_are_distinct_and_reproducible():
    a = [g.initial_seed() for g in tckm.stream_keys(3, "cpu")]
    b = [g.initial_seed() for g in tckm.stream_keys(3, "cpu")]
    assert a == b and len(set(a)) == 3
    assert a != [g.initial_seed() for g in tckm.stream_keys(4, "cpu")]


def test_gaussian_mixture_follows_the_reference_law():
    """The paper's mixture: unit clusters around means of variance c K^(1/n)."""
    x, labels, means = tsynth.gaussian_mixture(0, 20000, 4, 3, return_labels=True, device="cpu")
    assert x.shape == (20000, 3) and x.dtype == torch.float32
    resid = x - means[labels]
    np.testing.assert_allclose(resid.var(dim=0).numpy(), 1.0, atol=0.05)
    jx = np.asarray(jsynth.gaussian_mixture(jax.random.PRNGKey(0), 20000, 4, 3))
    assert x.var().item() == pytest.approx(float(jx.var()), rel=0.5)


def test_entry_points_raise_without_a_card_instead_of_running_on_the_cpu():
    """``fit`` without ``device=`` asks for the card; on a CPU-only host it
    raises and never silently runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    x = torch.zeros((64, 2))
    cfg = tckm.CKMConfig(k=2, **SMALL)
    for call in (
        lambda: tckm.fit(0, x, cfg),
        lambda: tckm.fit_streaming(0, [x], cfg),
        lambda: tckm.fit(0, x, dataclasses.replace(cfg, decoder="sketch_shift")),
        lambda: tckm.fit_streaming(0, [x], dataclasses.replace(cfg, decoder="amp")),
        lambda: tckm.sse(x, x[:2]),
        lambda: tsynth.gaussian_mixture(0, 10, 2, 2),
        lambda: convert.operator_from_numpy(np.ones((2, 3))),
    ):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
