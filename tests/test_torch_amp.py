"""The port's CL-AMP decoder and its input channel (kernel 7) against the
reference, on the CPU.

- The denoiser's plain version (``kernels.ops.amp_denoise`` on CPU tensors)
  against the reference's oracle (``ref.amp_denoise_ref``, through
  ``ndtr``) and its XLA path, on the reference suite's cases: four shapes at
  q in {0.5, 1e-4, 25}, the deep tail, half-open and open boxes.  Bars in
  the natural units of each moment, as the reference's: mean
  1e-5·max(1, sqrt(q)), variance 1e-5·max(1, q).
- The decoder on the reference's own initial estimates (``_estimates_init``
  patched), on the reference's sketch of a K = 3 blob fixture at m = 120:
  the GAMP loop and final NNLS to 1e-4, and the polished result once both
  polishes have settled (bars in the test).
- Quality at fuller budgets: the port's SSE within 1.05x the reference's on
  the same sketch and data (dense, 1-bit, structured, the data inits) and
  through ``fit_streaming``; replicates monotone; the output contract.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import ndtr

from repro.core import ckm as jckm
from repro.core import freq_ops as jfo
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import ckm as tckm
from repro_torch.kernels import amp_denoise as kamp
from repro_torch.kernels import ops as kops

jamp = importlib.import_module("repro.core.decoders.amp")
tamp = importlib.import_module("repro_torch.core.decoders.amp")

pytestmark = pytest.mark.torch_port

# The reference decoder suite's budgets (tests/test_decoders.py FAST).
FAST = dict(nnls_iters=60, amp_iters=40, amp_polish_steps=150)


def _denoise_case(seed, k_est, feat, spread=4.0):
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal((k_est, feat)) * spread).astype(np.float32)
    lo = (-np.abs(rng.standard_normal(feat)) - 0.1).astype(np.float32)
    hi = (np.abs(rng.standard_normal(feat)) + 0.1).astype(np.float32)
    return r, lo, hi


def _frac64(r, q, lo, hi):
    """``|phi(a) - phi(b)| / Z`` of each cell in float64 (scipy's ndtr)."""
    sig = np.sqrt(np.float64(np.float32(q)))
    a = (lo.astype(np.float64)[None, :] - r) / sig
    b = (hi.astype(np.float64)[None, :] - r) / sig
    with np.errstate(invalid="ignore"):
        z = np.where(a + b > 0, ndtr(-a) - ndtr(-b), ndtr(b) - ndtr(a))
    pdf = np.exp(-0.5 * a * a) - np.exp(-0.5 * b * b)
    return np.abs(pdf / np.sqrt(2 * np.pi) / np.maximum(z, 1e-300))


def _assert_denoise_matches(r, q, lo, hi):
    """The port against the oracle and the XLA path.

    Bars: the reference's, mean 1e-5·max(1, sqrt(q)) and variance
    1e-5·max(1, q), each scaled by the cell's condition number: 1 + frac
    for the mean and 1 + frac^2 for the variance (frac = (phi(a) -
    phi(b)) / Z).  A relative error in Z reaches the variance multiplied by
    about frac^2, up to ~50 in the tail just above the collapse at
    Z = 1e-12; and XLA's float32 erfc is accurate to 3.9e-6 relative
    (~33 ulps) where torch's is to 0.7 ulp, so the unscaled bar fails there
    by up to 2.9x at q = 0.5.  Where frac is small the bar is the
    reference's.
    """
    mean, var = kops.amp_denoise(
        torch.from_numpy(r), torch.tensor(q, dtype=torch.float32),
        torch.from_numpy(lo), torch.from_numpy(hi),
    )
    frac = _frac64(r, q, lo, hi)
    tol_m = 1e-5 * max(1.0, float(np.sqrt(q))) * (1.0 + frac)
    tol_v = 1e-5 * max(1.0, q) * (1.0 + frac * frac)
    args = (jnp.asarray(r), q, jnp.asarray(lo), jnp.asarray(hi))
    for m_ref, v_ref in (jref.amp_denoise_ref(*args), jops.amp_denoise(*args, impl="xla")):
        assert np.all(np.abs(mean.numpy() - np.asarray(m_ref)) <= tol_m)
        assert np.all(np.abs(var.numpy() - np.asarray(v_ref)) <= tol_v)
    return mean, var


@pytest.mark.parametrize("k_est,feat", [(8, 128), (37, 130), (3, 4), (256, 16)])
@pytest.mark.parametrize("q", [0.5, 1e-4, 25.0])
def test_denoise_plain_matches_reference(k_est, feat, q):
    r, lo, hi = _denoise_case(k_est, k_est, feat)
    _assert_denoise_matches(r, q, lo, hi)


def test_denoise_deep_tail():
    """r far outside the box: the in-box mass underflows, and the posterior
    collapses to the nearest edge, finite and inside the box."""
    r = np.array([[1e6] * 8, [-1e6] * 8, [50.0] * 8], np.float32)
    lo, hi = np.full(8, -1.0, np.float32), np.full(8, 1.0, np.float32)
    mean, var = _assert_denoise_matches(r, 1.0, lo, hi)
    assert bool(torch.all(torch.isfinite(mean))) and bool(torch.all(var > 0))
    assert bool(torch.all((mean >= -1.0) & (mean <= 1.0)))


def test_denoise_half_open_and_open_boxes():
    """Infinite edges: zero boundary terms; the open box is the identity
    (mean r, variance q)."""
    r = np.array([[0.3, -2.0, 5.0, -5.0]], np.float32)
    lo = np.array([-np.inf, -1.0, -np.inf, -1.0], np.float32)
    hi = np.array([np.inf, np.inf, 1.0, 1.0], np.float32)
    mean, var = _assert_denoise_matches(r, 2.0, lo, hi)
    assert float(mean[0, 0]) == pytest.approx(0.3, abs=1e-5)
    assert float(var[0, 0]) == pytest.approx(2.0, abs=1e-4)


def test_denoise_dispatch_and_kernel_wrapper(monkeypatch):
    """CPU tensors reach the plain version, never the kernel wrapper, and
    count no launch; q is clamped at 1e-20 on the tensor's device; the
    wrapper refuses CPU tensors and a q that is not 0-d."""

    def no_kernel(*args):
        raise AssertionError("kernel wrapper called for a CPU tensor")

    r, lo, hi = (torch.from_numpy(a) for a in _denoise_case(4, 5, 6))
    before = kamp.LAUNCHES
    monkeypatch.setattr(kamp, "amp_denoise", no_kernel)
    mean, var = kops.amp_denoise(r, torch.tensor(0.0), lo, hi)
    pm, pv = kamp.amp_denoise_plain(r, torch.tensor(1e-20), lo, hi)
    assert torch.equal(mean, pm) and torch.equal(var, pv)
    # Scalar bounds broadcast to (n,).
    sm, _ = kops.amp_denoise(r, 0.5, torch.tensor(-1.0), torch.tensor(1.0))
    bm, _ = kamp.amp_denoise_plain(r, torch.tensor(0.5), -torch.ones(6), torch.ones(6))
    assert torch.equal(sm, bm)
    assert kamp.LAUNCHES == before
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kamp.amp_denoise(r, torch.tensor(0.5), lo, hi)
    with pytest.raises(ValueError, match="0-d q"):
        kamp.amp_denoise_plain(r, torch.tensor([0.5]), lo, hi)
    with pytest.raises(ValueError, match="shape mismatch"):
        kamp.amp_denoise_plain(r, torch.tensor(0.5), lo[:5], hi)


def test_wrap_rounds_half_to_even_like_jnp():
    x = np.array([np.pi, -np.pi, 3 * np.pi, 5.0, -7.5, 100.0], np.float32)
    np.testing.assert_array_equal(
        tamp._wrap(torch.from_numpy(x)).numpy(), np.asarray(jamp._wrap(jnp.asarray(x)))
    )


# ---------------------------------------------------------------------------
# The decoder on the reference's own initial estimates
# ---------------------------------------------------------------------------


def _blob_sketch(n):
    """The reference's sketch of K = 3 separated blobs in R^n, m = 120."""
    x = jsyn.gaussian_mixture(jax.random.PRNGKey(42), 3000, k=3, n=n, c=6.0)
    z, w, _, (lo, hi) = jckm.compute_sketch(jax.random.PRNGKey(1), x, jckm.CKMConfig(k=3, m=120))
    port = (
        torch.from_numpy(np.array(z)),
        convert.operator_from_numpy(np.asarray(w.materialize()), device="cpu"),
        torch.from_numpy(np.array(lo)),
        torch.from_numpy(np.array(hi)),
    )
    return (z, w, lo, hi), port


@pytest.mark.parametrize("n,polish", [(2, 0), (3, 0), (4, 0), (3, 200)])
def test_decoder_matches_reference_on_its_draws(monkeypatch, n, polish):
    """10 GAMP iterations from the reference's initial estimates
    (``lo + uniform(key, (K, n)) * span``).

    Without the polish (the GAMP loop and the final NNLS) centroids and
    weights agree to 1e-4 and the cost to 1e-4 relative.  With it, 1e-4 is
    out of reach at 50 steps: Adam's first steps move each parameter by
    about 0.74·lr whatever the gradient's size, and at the NNLS optimum the
    gradient in alpha is ~0, so float rounding picks the sign (one polish
    step already moves the weights ~0.08 apart at n = 3; after 50 the costs
    still differ by 8%).  So the polished case runs 200 steps, by which both
    have settled in the same minimum: cost to 1e-4 relative, weights to
    1e-4, centroids to 1e-3 (measured 2.9e-4).
    """
    (z, w, lo, hi), port = _blob_sketch(n)
    key = jax.random.PRNGKey(5)
    cfg = dict(k=3, iters=10, polish_steps=polish)
    want = jamp.cl_amp(key, z, w, lo, hi, jamp.AMPConfig(**cfg))
    init = torch.from_numpy(np.array(lo + jax.random.uniform(key, (3, n)) * jnp.maximum(hi - lo, 1e-12)))
    monkeypatch.setattr(tamp, "_estimates_init", lambda *args: init.clone())
    got = tamp.cl_amp(None, *port, tamp.AMPConfig(**cfg))
    c_tol = 1e-4 if polish == 0 else 1e-3
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=c_tol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
    assert float(got[2]) == pytest.approx(float(want[2]), rel=1e-4)


def test_decoder_on_a_structured_operator_never_materialises(monkeypatch):
    """AMP reaches the operator through apply, adjoint and col_sq_norms only."""
    jop = jfo.make_operator("structured", jax.random.PRNGKey(2), 64, 3, 1.0)
    top = convert.structured_operator_from_numpy(
        np.asarray(jop.diags), np.asarray(jop.radii), np.asarray(jop.rho), 3, 64, device="cpu"
    )
    x = torch.randn((500, 3), generator=torch.Generator().manual_seed(0))
    z = tckm.make_engine(top, tckm.CKMConfig(k=2), "cpu").sketch(x)[0]

    def refuse():
        raise AssertionError("amp materialised the operator")

    monkeypatch.setattr(top, "materialize", refuse)
    cents, alphas, cost = tamp.cl_amp(
        torch.Generator().manual_seed(1), z, top, x.amin(0), x.amax(0),
        tamp.AMPConfig(k=2, iters=5, polish_steps=5),
    )
    assert bool(torch.all(torch.isfinite(cents))) and np.isfinite(float(cost))


# ---------------------------------------------------------------------------
# Quality at fuller budgets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def blobs():
    """The reference decoder suite's problem data: K = 3 blobs in R^3."""
    return jsyn.gaussian_mixture(jax.random.PRNGKey(7), 3000, k=3, n=3, c=6.0)


def _to_port(z, w, lo, hi):
    if isinstance(w, jfo.DenseOperator):
        top = convert.operator_from_numpy(np.asarray(w.materialize()), device="cpu")
    else:
        top = convert.structured_operator_from_numpy(
            np.asarray(w.diags), np.asarray(w.radii), np.asarray(w.rho), w.n, w.m, device="cpu"
        )
    return (torch.from_numpy(np.array(z)), top, torch.from_numpy(np.array(lo)),
            torch.from_numpy(np.array(hi)))


_PATHS = {"dense": {}, "1bit": dict(sketch_quantization="1bit"),
          "structured": dict(freq_op="structured"), "streaming": {},
          "sample": dict(init="sample"), "kpp": dict(init="kpp")}


def _reference_sample_inits(key, x_init, lo, hi, k, replicates):
    """The reference's "sample" initial estimates of each replicate: rows
    ``randint(fold_in(key, r), (K,), 0, N)`` of the clipped data."""
    x_data = jnp.clip(x_init, lo, hi)
    return [
        torch.from_numpy(np.array(x_data[jax.random.randint(
            jax.random.fold_in(key, r), (k,), 0, x_data.shape[0])]))
        for r in range(replicates)
    ]


@pytest.mark.parametrize("path", list(_PATHS))
def test_quality_matches_reference(monkeypatch, blobs, path):
    """Two replicates a side; the same sketch and data, except through
    fit_streaming, where each side sketches the same batches with its own
    frequencies.  SSE within 1.05x the reference's; finite centroids inside
    the box, nonnegative weights summing to 1.

    "sample" draws K data rows; with K = 3 blobs most draws put two rows in
    one blob, which CL-AMP does not leave, so one decode succeeds about as
    often as not on either side (14 of 40 reference keys, 19 of 40 port
    seeds at these budgets).  On that path the port starts from the
    reference's own draws, replicate by replicate.
    """
    opts = dict(k=3, m=120, decoder="amp", replicates=2, **FAST, **_PATHS[path])
    jcfg, tcfg = jckm.CKMConfig(**opts), tckm.CKMConfig(**opts)
    xt = torch.from_numpy(np.array(blobs))
    if path == "streaming":
        want = jckm.fit_streaming(jax.random.PRNGKey(2), jpipe.chunked(blobs, 1000), jcfg)
        cents, alphas, cost = tckm.fit_streaming(2, torch.split(xt, 1000), tcfg, device="cpu")[:3]
        want = want.centroids
    else:
        z, w, _, (lo, hi) = jckm.compute_sketch(jax.random.PRNGKey(1), blobs, jcfg)
        x_init = blobs[:512] if path in ("sample", "kpp") else None
        key = jax.random.PRNGKey(3)
        if path == "sample":
            inits = iter(_reference_sample_inits(key, x_init, lo, hi, 3, 2))
            monkeypatch.setattr(tamp, "_estimates_init", lambda *args: next(inits))
        want = jckm.decode_sketch(key, z, w, lo, hi, jcfg, x_init=x_init)[0]
        cents, alphas, cost = tckm.decode_sketch(
            3, *_to_port(z, w, lo, hi), tcfg,
            x_init=None if x_init is None else xt[:512], device="cpu",
        )
    sse, sse_ref = float(tckm.sse(xt, cents, device="cpu")), float(jckm.sse(blobs, want))
    assert sse <= 1.05 * sse_ref, (sse, sse_ref)
    assert cents.shape == (3, 3) and np.isfinite(float(cost))
    lo, hi = torch.amin(xt, 0), torch.amax(xt, 0)
    assert bool(torch.all(cents >= lo - 1e-5)) and bool(torch.all(cents <= hi + 1e-5))
    assert bool(torch.all(alphas >= 0)) and float(alphas.sum()) == pytest.approx(1.0, abs=1e-5)


def test_replicates_are_monotone(blobs):
    z, w, _, (lo, hi) = jckm.compute_sketch(
        jax.random.PRNGKey(1), blobs, jckm.CKMConfig(k=3, m=120))
    port = _to_port(z, w, lo, hi)
    costs = [
        float(tckm.decode_sketch(
            5, *port, tckm.CKMConfig(k=3, m=120, decoder="amp", replicates=r, **FAST),
            device="cpu")[2])
        for r in (1, 3)
    ]
    assert costs[1] <= costs[0]


def test_config_carries_the_knobs_and_inits_draw_in_the_box():
    cfg = tckm.CKMConfig(k=4, decoder="amp", amp_iters=17, amp_damp=0.2, amp_polish_steps=9,
                         nnls_iters=11, joint_lr=0.1, init="sample")
    assert dataclasses.asdict(cfg.amp_config()) == dict(
        k=4, iters=17, damp=0.2, inner_nnls_iters=40, nnls_iters=11, polish_steps=9,
        polish_lr=0.1, init="sample", alpha_floor=0.05, noise_floor=1e-8, trace=False,
    )
    assert dataclasses.replace(cfg, trace_convergence=True).amp_config().trace
    gen = torch.Generator().manual_seed(0)
    lo, hi = torch.tensor([-1.0, 0.0]), torch.tensor([1.0, 3.0])
    x = torch.rand((50, 2), generator=gen) * (hi - lo) + lo
    for init in ("range", "sample", "kpp"):
        c = tamp.AMPConfig(k=4, init=init)
        est = tamp._estimates_init(gen, c, lo, hi, hi - lo, None if init == "range" else x)
        assert est.shape == (4, 2) and bool(torch.all((est >= lo) & (est <= hi)))
        if init != "range":
            assert bool(torch.all(torch.any(torch.all(est[:, None] == x[None], -1), 1)))
