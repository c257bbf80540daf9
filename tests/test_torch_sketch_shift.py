"""The port's sketch_shift decoder and its score step (kernel 6) against the
reference, on the CPU.

- The score step's plain version (``kernels.ops.sketch_shift_scores`` on CPU
  tensors) against the reference's complex-arithmetic oracle, its XLA path
  and its Pallas kernel in interpret mode: 1e-5 on f and g after the
  division by m.  Through a structured operator, which the port
  materialises and the reference's XLA path applies through
  ``apply``/``adjoint``: 1e-4 (the engine's bar; the two round the
  projection apart).
- The decoder on the reference's own swarm draws (``_swarm_init`` patched),
  on the reference's sketch of a K = 3 blob fixture at m = 120: the rounds
  (mean shift, harvest, NNLS, deflation) to 1e-4, and the polished result
  once both polishes have settled (bars in the test).
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

from repro.core import ckm as jckm
from repro.core import freq_ops as jfo
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import ckm as tckm
from repro_torch.kernels import ops as kops
from repro_torch.kernels import sketch_shift as kss

jss = importlib.import_module("repro.core.decoders.sketch_shift")
tss = importlib.import_module("repro_torch.core.decoders.sketch_shift")

pytestmark = pytest.mark.torch_port

# The reference decoder suite's budgets (tests/test_decoders.py FAST).
FAST = dict(nnls_iters=60, shift_steps=40, shift_polish_steps=150)


def _score_inputs(seed, p, n, m):
    rng = np.random.default_rng(seed)
    c = (rng.standard_normal((p, n)) * 2.0).astype(np.float32)
    w = rng.standard_normal((n, m)).astype(np.float32)
    z = (rng.standard_normal(2 * m) * 0.3).astype(np.float32)
    return c, w, z


@pytest.mark.parametrize("p,n,m", [(5, 3, 37), (80, 10, 1000), (17, 64, 300)])
def test_score_plain_matches_reference_oracle_xla_and_pallas(p, n, m):
    c, w, z = _score_inputs(p, p, n, m)
    f, g = kops.sketch_shift_scores(torch.from_numpy(c), torch.from_numpy(w), torch.from_numpy(z))
    assert f.shape == (p,) and g.shape == (p, n)
    jc, jw, jz = jnp.asarray(c), jnp.asarray(w), jnp.asarray(z)
    op = jfo.as_operator(jw)
    refs = [
        jref.sketch_shift_scores_ref(jc, jw, jz),
        jops.sketch_shift_scores(jc, op, jz, impl="xla"),
        jops.sketch_shift_scores(jc, op, jz, impl="pallas", interpret=True),
    ]
    for f_ref, g_ref in refs:
        np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), atol=1e-5)


def test_score_plain_on_a_materialised_structured_operator():
    """The decoder materialises a structured operator once per decode; the
    reference's XLA path works through ``apply``/``adjoint``."""
    n, m = 6, 200
    jop = jfo.make_operator("structured", jax.random.PRNGKey(3), m, n, 0.7)
    top = convert.structured_operator_from_numpy(
        np.asarray(jop.diags), np.asarray(jop.radii), np.asarray(jop.rho), n, m, device="cpu"
    )
    c, _, z = _score_inputs(9, 24, n, m)
    f, g = kops.sketch_shift_scores(
        torch.from_numpy(c), top.materialize().contiguous(), torch.from_numpy(z)
    )
    f_ref, g_ref = jops.sketch_shift_scores(jnp.asarray(c), jop, jnp.asarray(z), impl="xla")
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), atol=1e-4)


def test_score_dispatch_and_kernel_wrapper(monkeypatch):
    """CPU tensors reach the plain version, never the kernel wrapper, and
    count no launch; the wrapper refuses CPU tensors and checks shapes."""

    def no_kernel(*args):
        raise AssertionError("kernel wrapper called for a CPU tensor")

    c, w, z = (torch.from_numpy(a) for a in _score_inputs(1, 7, 4, 50))
    before = kss.LAUNCHES
    monkeypatch.setattr(kss, "sketch_shift_sums", no_kernel)
    f, g = kops.sketch_shift_scores(c, w, z)
    pf, pg = kss.sketch_shift_sums_plain(c, w, z[:50], z[50:])
    assert torch.equal(f, pf / 50) and torch.equal(g, pg / 50)
    assert kss.LAUNCHES == before
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kss.sketch_shift_sums(c, w, z[:50], z[50:])
    with pytest.raises(ValueError, match="shape mismatch"):
        kss.sketch_shift_sums_plain(c, w, z[:49], z[50:])
    with pytest.raises(TypeError, match="float32"):
        kss.sketch_shift_sums_plain(c.double(), w, z[:50], z[50:])


H100_SMS = 132


@pytest.mark.parametrize("p_cand,m", [(80, 1000), (83, 1003), (83, 1024), (80, 1025),
                                     (80, 20000), (4, 100000), (1, 5), (7, 100)])
def test_shift_grid_fills_the_card_with_clusters_that_cover_m_once(p_cand, m):
    """The narrow path's grid: clusters of at most 8 CTAs whose slices of m
    are contiguous, none empty, and cover m once; each slice holds at least
    ``MIN_SLICE`` frequencies where m has them; the groups of ``CANDS``
    candidates cover P.  The decoder's P = 80, m = 1000 (and the smoke's
    ragged 83, 1003) get at least one CTA per SM of the card."""
    cluster, split_len, groups = kss.shift_grid(p_cand, m)
    assert 1 <= cluster <= kss.MAX_CLUSTER
    assert (cluster - 1) * split_len < m <= cluster * split_len
    assert split_len >= min(m, kss.MIN_SLICE)
    assert (groups - 1) * kss.CANDS < p_cand <= groups * kss.CANDS
    if (p_cand, m) in ((80, 1000), (83, 1003)):
        assert cluster * groups >= H100_SMS
        assert split_len <= 128  # one chunk of the CTA's 128 threads


@pytest.mark.parametrize("p_cand,n,m", [(80, 2048, 20000), (83, 65, 1003), (1, 100, 5),
                                       (300, 70, 777), (129, 2048, 64)])
def test_wide_grid_covers_every_output_and_m_once(p_cand, n, m):
    """The wide path's geometry: the candidate tiles cover P (one tile up to
    128), the phase kernel's frequency tiles and the gradient kernel's
    coordinate tiles cover m and n, the gradient's splits are whole steps
    of ``DEPTH``, none empty, covering m once, and the scratch holds t, f's
    tile partials and g's split partials.  At the smoke's wide shape both
    kernels launch at least two CTAs an SM."""
    geo = kss.wide_grid(p_cand, n, m, H100_SMS)
    tp, splits, split_len = geo["tp"], geo["splits"], geo["split_len"]
    assert 1 <= tp <= kss.MAX_TP
    assert (geo["p_tiles"] - 1) * 16 * tp < p_cand <= geo["p_tiles"] * 16 * tp
    assert geo["p_tiles"] == 1 or tp == kss.MAX_TP
    assert (geo["m_tiles"] - 1) * kss.TILE < m <= geo["m_tiles"] * kss.TILE
    assert (geo["n_tiles"] - 1) * kss.TILE < n <= geo["n_tiles"] * kss.TILE
    assert split_len % kss.DEPTH == 0 and (splits - 1) * split_len < m <= splits * split_len
    assert geo["scratch"] == p_cand * m + geo["m_tiles"] * p_cand + splits * p_cand * n
    if (p_cand, n, m) == (80, 2048, 20000):
        assert geo["m_tiles"] * geo["p_tiles"] >= 2 * H100_SMS
        assert geo["n_tiles"] * geo["p_tiles"] * splits >= 2 * H100_SMS


@pytest.mark.parametrize("p_cand,n,m", [(83, 10, 1003), (17, 70, 300)])
def test_kernel_partition_of_the_sums_adds_up_to_the_whole(p_cand, n, m):
    """The sums split as the kernel splits them add up to the whole: per
    cluster of ``CANDS`` candidates the narrow path's slices of m (added in
    rank order), and the wide path's frequency tiles (f) and gradient
    splits (g), each part through the plain version; within 1e-5 of the
    whole after the division by m."""
    c, w, z = (torch.from_numpy(a) for a in _score_inputs(3, p_cand, n, m))
    z1, z2 = z[:m], z[m:]
    f, g = kss.sketch_shift_sums_plain(c, w, z1, z2)
    cluster, split_len, groups = kss.shift_grid(p_cand, m)
    fn, gn = torch.zeros_like(f), torch.zeros_like(g)
    for grp in range(groups):
        rows = slice(grp * kss.CANDS, (grp + 1) * kss.CANDS)
        for r in range(cluster):
            cols = slice(r * split_len, (r + 1) * split_len)
            pf, pg = kss.sketch_shift_sums_plain(c[rows], w[:, cols].contiguous(), z1[cols],
                                                 z2[cols])
            fn[rows] += pf
            gn[rows] += pg
    geo = kss.wide_grid(p_cand, n, m, H100_SMS)
    fw, gw = torch.zeros_like(f), torch.zeros_like(g)
    for tile in range(geo["m_tiles"]):
        cols = slice(tile * kss.TILE, (tile + 1) * kss.TILE)
        fw += kss.sketch_shift_sums_plain(c, w[:, cols].contiguous(), z1[cols], z2[cols])[0]
    for s in range(geo["splits"]):
        cols = slice(s * geo["split_len"], (s + 1) * geo["split_len"])
        gw += kss.sketch_shift_sums_plain(c, w[:, cols].contiguous(), z1[cols], z2[cols])[1]
    for got_f, got_g in ((fn, gn), (fw, gw)):
        np.testing.assert_allclose(got_f.numpy() / m, f.numpy() / m, atol=1e-5)
        np.testing.assert_allclose(got_g.numpy() / m, g.numpy() / m, atol=1e-5)


def test_gradient_is_the_density_gradient():
    """g is the autograd gradient of f, as in the reference's test."""
    c, w, z = (torch.from_numpy(a) for a in _score_inputs(2, 6, 4, 96))
    leaf = c.clone().requires_grad_(True)
    f, _ = kops.sketch_shift_scores(leaf, w, z)
    (g_auto,) = torch.autograd.grad(f.sum(), leaf)
    _, g = kops.sketch_shift_scores(c, w, z)
    np.testing.assert_allclose(g.numpy(), g_auto.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# The decoder on the reference's own draws
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


def _reference_swarms(key, lo, hi, p, n, k):
    """The reference's round-t swarms: ``key, k_round = split(key)`` per
    round, then ``lo + uniform(k_round, (P, n)) * span``."""
    span = jnp.maximum(hi - lo, 1e-12)
    swarms = []
    for _ in range(k):
        key, k_round = jax.random.split(key)
        swarms.append(torch.from_numpy(np.array(lo + jax.random.uniform(k_round, (p, n)) * span)))
    return swarms


@pytest.mark.parametrize(
    "n,polish", [(2, 0), (3, 0), (4, 0), (3, 200)]
)
def test_decoder_matches_reference_on_its_draws(monkeypatch, n, polish):
    """20 mean-shift steps a round, the reference's swarm draws.

    Without the polish (the K rounds: mean shift, harvest argmax, NNLS,
    deflation) centroids and weights agree to 1e-4 and the cost to 1e-4
    relative.  With it, 1e-4 is out of reach at 50 steps: Adam's first
    steps move each parameter by about 0.74·lr whatever the gradient's
    size, and at the NNLS optimum the gradient in alpha is ~0, so float
    rounding picks the sign (one polish step already moves the weights
    ~0.08 apart at n = 3, and 50 steps leave the two mid-descent on
    different paths).  So the polished case runs 200 steps, by which both
    have settled in the same minimum: cost to 1e-4 relative, weights to
    1e-4, centroids to 1e-3 (measured 2e-6).
    """
    (z, w, lo, hi), port = _blob_sketch(n)
    key = jax.random.PRNGKey(5)
    cfg = dict(k=3, candidates=24, shift_steps=20, polish_steps=polish)
    want = jss.sketch_shift(key, z, w, lo, hi, jss.SketchShiftConfig(**cfg))
    swarms = _reference_swarms(key, lo, hi, 24, n, 3)
    monkeypatch.setattr(tss, "_swarm_init", lambda gen, c, lo_, sp, xd, sb, t: swarms[t].clone())
    got = tss.sketch_shift(None, *port, tss.SketchShiftConfig(**cfg))
    c_tol = 1e-4 if polish == 0 else 1e-3
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=c_tol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
    assert float(got[2]) == pytest.approx(float(want[2]), rel=1e-4)


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


def _quality(decoder, fast, path, x):
    """(port SSE, reference SSE, port result) for one path, two replicates
    on each side; the same sketch and data except through fit_streaming,
    where each side sketches the same batches with its own frequencies."""
    opts = dict(k=3, m=120, decoder=decoder, replicates=2, **fast)
    if path in ("1bit", "structured", "sample", "kpp"):
        opts.update({"1bit": dict(sketch_quantization="1bit"),
                     "structured": dict(freq_op="structured"),
                     "sample": dict(init="sample"), "kpp": dict(init="kpp")}[path])
    jcfg = jckm.CKMConfig(**opts)
    tcfg = tckm.CKMConfig(**opts)
    xt = torch.from_numpy(np.array(x))
    if path == "streaming":
        want = jckm.fit_streaming(jax.random.PRNGKey(2), jpipe.chunked(x, 1000), jcfg).centroids
        got = tckm.fit_streaming(2, torch.split(xt, 1000), tcfg, device="cpu")[:3]
    else:
        z, w, _, (lo, hi) = jckm.compute_sketch(jax.random.PRNGKey(1), x, jcfg)
        x_init = x[:512] if path in ("sample", "kpp") else None
        want = jckm.decode_sketch(jax.random.PRNGKey(3), z, w, lo, hi, jcfg, x_init=x_init)[0]
        got = tckm.decode_sketch(
            3, *_to_port(z, w, lo, hi), tcfg,
            x_init=None if x_init is None else xt[:512], device="cpu",
        )
    sse = float(tckm.sse(xt, got[0], device="cpu"))
    return sse, float(jckm.sse(x, want)), got


@pytest.mark.parametrize("path", ["dense", "1bit", "structured", "streaming", "sample", "kpp"])
def test_quality_matches_reference(blobs, path):
    """SSE within 1.05x the reference's; finite centroids inside the box,
    nonnegative weights summing to 1."""
    sse, sse_ref, (cents, alphas, cost) = _quality("sketch_shift", FAST, path, blobs)
    assert sse <= 1.05 * sse_ref, (sse, sse_ref)
    assert cents.shape == (3, 3) and np.isfinite(float(cost))
    xt = torch.from_numpy(np.array(blobs))
    lo, hi = torch.amin(xt, 0), torch.amax(xt, 0)
    assert bool(torch.all(cents >= lo - 1e-5)) and bool(torch.all(cents <= hi + 1e-5))
    assert bool(torch.all(alphas >= 0)) and float(alphas.sum()) == pytest.approx(1.0, abs=1e-5)


def test_replicates_are_monotone(blobs):
    z, w, _, (lo, hi) = jckm.compute_sketch(
        jax.random.PRNGKey(1), blobs, jckm.CKMConfig(k=3, m=120))
    port = _to_port(z, w, lo, hi)
    costs = [
        float(tckm.decode_sketch(
            5, *port, tckm.CKMConfig(k=3, m=120, decoder="sketch_shift", replicates=r, **FAST),
            device="cpu")[2])
        for r in (1, 3)
    ]
    assert costs[1] <= costs[0]


def test_config_carries_the_knobs_and_swarm_inits_draw_in_the_box():
    cfg = tckm.CKMConfig(k=4, decoder="sketch_shift", shift_candidates=3, shift_steps=7,
                         shift_step_scale=0.5, shift_polish_steps=9, shift_dedup_scale=2.0,
                         nnls_iters=11, joint_lr=0.1, init="kpp")
    scfg = cfg.sketch_shift_config()
    assert dataclasses.asdict(scfg) == dict(
        k=4, candidates=12, shift_steps=7, step_scale=0.5, nnls_iters=11, polish_steps=9,
        polish_lr=0.1, init="kpp", dedup_radius_scale=2.0, density_floor=1e-3, trace=False,
    )
    assert dataclasses.replace(cfg, trace_convergence=True).sketch_shift_config().trace
    assert tckm.CKMConfig(k=2).sketch_shift_config().shift_steps == 150
    assert tss.SketchShiftConfig(k=2).shift_steps == 75
    gen = torch.Generator().manual_seed(0)
    lo, hi = torch.tensor([-1.0, 0.0]), torch.tensor([1.0, 3.0])
    x = torch.rand((50, 2), generator=gen) * (hi - lo) + lo
    kept = x[:4].clone()
    for init in ("range", "sample", "kpp"):
        c = tss.SketchShiftConfig(k=4, candidates=16, init=init)
        sw = tss._swarm_init(gen, c, lo, hi - lo, None if init == "range" else x, kept, 2)
        assert sw.shape == (16, 2) and bool(torch.all((sw >= lo) & (sw <= hi)))
        if init != "range":
            assert bool(torch.all(torch.any(torch.all(sw[:, None] == x[None], -1), 1)))
