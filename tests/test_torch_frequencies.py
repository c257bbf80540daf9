"""The port's frequency sampling and dense operator against the reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.core import freq_ops as jfo
from repro.core import frequencies as jfreq
from repro_torch.core import freq_ops as tfo
from repro_torch.core import frequencies as tfreq

pytestmark = pytest.mark.torch_port


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("sigma2", [0.05, 1.0, 7.5])
def test_radius_from_uniform_matches_reference(sigma2):
    """The deterministic half of the sampler, on shared uniforms: 1e-5.

    (Far in the tail, u > 1 - 1e-5, the float32 CDF's rounding order alone
    moves a radius by more: both cumulative sums are right to the float.)"""
    u = np.random.default_rng(0).uniform(size=4096).astype(np.float32)
    u[:2] = [0.0, 0.5]
    ref = np.asarray(jfreq.radius_from_uniform(jnp.asarray(u), sigma2))
    got = tfreq.radius_from_uniform(torch.from_numpy(u), sigma2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dist", ["adapted_radius", "gaussian", "folded_gaussian"])
def test_draw_frequencies_radii_follow_the_reference_law(dist):
    """Different generators draw different numbers: the port's radii and the
    reference's are compared as distributions (two-sample KS test)."""
    m, n, sigma2 = 4000, 6, 2.0
    w_ref = np.asarray(jfreq.draw_frequencies(jax.random.PRNGKey(0), m, n, sigma2, dist))
    w = tfreq.draw_frequencies(_gen(0), m, n, sigma2, dist, device="cpu")
    assert w.shape == (n, m) and w.dtype == torch.float32
    r_ref = np.linalg.norm(w_ref, axis=0)
    r = torch.linalg.vector_norm(w, dim=0).numpy()
    assert stats.ks_2samp(r, r_ref).pvalue > 1e-3
    # Directions are uniform on the sphere: the mean direction is ~0.
    unit = w.numpy() / r
    assert np.abs(unit.mean(axis=1)).max() < 0.1


def test_draw_radii_matches_draw_frequencies_law():
    r = tfreq.draw_radii(_gen(1), 4000, 6, 2.0, device="cpu").numpy()
    w = tfreq.draw_frequencies(_gen(2), 4000, 6, 2.0, device="cpu")
    assert stats.ks_2samp(r, torch.linalg.vector_norm(w, dim=0).numpy()).pvalue > 1e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimate_sigma2_within_2x_of_reference(seed):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((5, 4)) * 6.0
    x = (means[rng.integers(0, 5, 2048)] + rng.standard_normal((2048, 4))).astype(np.float32)
    ref = float(jfreq.estimate_sigma2(jax.random.PRNGKey(seed), jnp.asarray(x)))
    got = float(tfreq.estimate_sigma2(_gen(seed), torch.from_numpy(x), device="cpu"))
    assert 0.5 <= got / ref <= 2.0, (got, ref)


def test_entry_points_default_to_the_card():
    """Without ``device=`` the samplers ask for CUDA and raise without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tfreq.draw_frequencies(_gen(0), 8, 2, 1.0)
    with pytest.raises(RuntimeError, match="cuda"):
        tfreq.estimate_sigma2(_gen(0), torch.zeros((4, 2)))


def test_dense_operator_matches_reference():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((5, 40)).astype(np.float32)
    x = rng.standard_normal((7, 5)).astype(np.float32)
    v = rng.standard_normal((7, 40)).astype(np.float32)
    jop = jfo.as_operator(jnp.asarray(w))
    top = tfo.as_operator(torch.from_numpy(w))
    assert isinstance(top, tfo.DenseOperator) and (top.n, top.m) == (5, 40)
    for got, ref in [
        (top.apply(torch.from_numpy(x)), jop.apply(jnp.asarray(x))),
        (top.adjoint(torch.from_numpy(v)), jop.adjoint(jnp.asarray(v))),
        (top.materialize(), jop.materialize()),
        (top.col_norms(), jop.col_norms()),
        (top.col_sq_norms(), jop.col_sq_norms()),
    ]:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_registry_contract():
    assert tfo.available_freq_ops() == ["dense"]
    op = tfo.make_operator("dense", _gen(4), 30, 3, 1.5, device="cpu")
    assert isinstance(op, tfo.DenseOperator) and op.materialize().shape == (3, 30)
    assert tfo.as_operator(op) is op
    with pytest.raises(KeyError, match="available"):
        tfo.make_operator("structured", _gen(4), 30, 3, 1.5, device="cpu")
    with pytest.raises(ValueError, match="already registered"):
        tfo.register_freq_op("dense")(lambda *a, **k: None)
