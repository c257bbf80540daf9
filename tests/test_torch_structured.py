"""The port's structured (fast Walsh–Hadamard) frequency operator against the
reference: the Hadamard helpers, the operator's algebra on shared signs and
radii, the restricted-norm rescaling, the plain versions of the structured
sketch kernels (float and quantized), and the slice end to end (structured
operator + 1-bit QCKM through ``compute_sketch`` and ``fit``); a float32
model of the CUDA kernels' butterfly arithmetic, the 1-bit codes they read
off the reduced phase, and their launch grid.

Tolerances: 1e-5 for the transform and the operator (float32 rounding of the
same Kronecker contractions); 1e-4 on sums / N for the float sketch sums (the
reference's bar across sketch backends); integer code sums within twice the
count of points whose reference argument lies within 1e-5 of a rounding
boundary; CKM decodes by matched-centroid error under one cluster standard
deviation (the blobs have unit variance).
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from repro.core import ckm as jckm
from repro.core import engine as jeng
from repro.core import freq_ops as jfo
from repro.core import quantize as jqz
from repro.kernels import freq_transform as jft
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import ckm as tckm
from repro_torch.core import freq_ops as tfo
from repro_torch.core.engine import SketchEngine
from repro_torch.core.freq_ops import structured as tst
from repro_torch.kernels import freq_transform as tft
from repro_torch.kernels import ops as kops

from _torch_codes import BOUNDARY
from _torch_codes import one_bit_codes as _one_bit_codes
from _torch_codes import assert_sums_within_flips as _assert_sums_within_flips

pytestmark = pytest.mark.torch_port

SMALL = dict(atom_steps=40, joint_steps=30, nnls_iters=40, final_steps=60)


def _ops(n, m, sigma2=1.3, seed=5):
    """A reference structured operator and the port's copy of it."""
    jop = jfo.make_operator("structured", jax.random.PRNGKey(seed), m, n, sigma2)
    top = convert.structured_operator_from_numpy(
        np.asarray(jop.diags), np.asarray(jop.radii), np.asarray(jop.rho), n, m, device="cpu"
    )
    return jop, top


def _points(seed, n_pts, n, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((n_pts, n)) * scale).astype(np.float32)


@pytest.mark.parametrize("d", [1, 2, 4, 32, 128, 2048])
def test_hadamard_helpers_match_reference(d):
    assert tft.kron_factors(d) == jft.kron_factors(d)
    a, b = tft.kron_factors(d)
    for k in (a, b):
        np.testing.assert_array_equal(tft.hadamard(k).numpy(), np.asarray(jft.hadamard(k)))
    v = _points(d, 6, d)
    np.testing.assert_allclose(
        tft.fwht(torch.from_numpy(v)).numpy(), np.asarray(jft.fwht(jnp.asarray(v))),
        rtol=1e-5, atol=1e-5 * np.sqrt(d),
    )


@pytest.mark.parametrize("d", [32, 128])
def test_hd_chain_matches_reference_on_shared_signs(d):
    rng = np.random.default_rng(d)
    diags = rng.choice(np.array([-1.0, 1.0], np.float32), size=(3, 3, d))
    xp = _points(1, 9, d)[:, None, :]
    np.testing.assert_allclose(
        tft.hd_chain(torch.from_numpy(xp), torch.from_numpy(diags)).numpy(),
        np.asarray(jft.hd_chain(jnp.asarray(xp), jnp.asarray(diags))),
        rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("n,m", [(10, 1000), (6, 80), (5, 7), (16, 16), (33, 100)])
def test_operator_matches_reference_on_shared_signs_and_radii(n, m):
    """apply, adjoint, materialize and col_norms: 1e-5."""
    jop, top = _ops(n, m)
    assert (top.n, top.m, top.d, top.nblocks) == (jop.n, jop.m, jop.d, jop.nblocks)
    assert top.d == tst.block_dim(n) == jfo.structured.block_dim(n)
    x = _points(2, 17, n)
    v = _points(3, 17, m)
    for got, ref in [
        (top.apply(torch.from_numpy(x)), jop.apply(jnp.asarray(x))),
        (top.adjoint(torch.from_numpy(v)), jop.adjoint(jnp.asarray(v))),
        (top.materialize(), jop.materialize()),
        (top.col_norms(), jop.col_norms()),
    ]:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,m", [(10, 100), (33, 70)])
def test_adjoint_is_the_transpose_and_col_norms_are_realised(n, m):
    _, top = _ops(n, m, seed=7)
    x, v = torch.from_numpy(_points(4, 9, n)), torch.from_numpy(_points(5, 9, m))
    lhs = float(torch.sum(top.apply(x) * v))
    rhs = float(torch.sum(x * top.adjoint(v)))
    assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs))
    w = top.materialize()
    np.testing.assert_allclose(
        torch.linalg.vector_norm(w, dim=0).numpy(), top.col_norms().numpy(), rtol=1e-5
    )
    np.testing.assert_allclose((v @ w.T).numpy(), top.adjoint(v).numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,m", [(10, 1000), (3, 40), (40, 200)])
def test_build_structured_rescales_by_the_reference_formula(n, m):
    """The port's own signs and radii, rescaled: the reference's formula
    (one hd_chain over the zero-padded basis) on the same signs and rho."""
    op = tfo.make_operator("structured", torch.Generator().manual_seed(0), m, n, 0.7,
                           device="cpu")
    diags = np.asarray(op.diags)
    assert set(np.unique(diags)) == {-1.0, 1.0} and op.diags.shape == (op.nblocks, 3, op.d)
    basis = jnp.eye(op.d, dtype=jnp.float32)[:n]
    cols = jft.hd_chain(basis[:, None, :], jnp.asarray(diags))
    restricted = jnp.sqrt(jnp.sum(cols * cols, axis=0))
    want = jnp.asarray(op.rho.numpy()) / jnp.maximum(restricted, 1e-6)
    np.testing.assert_allclose(op.radii.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(
        torch.linalg.vector_norm(op.materialize(), dim=0).numpy(), op.col_norms().numpy(),
        rtol=1e-5,
    )


def test_operator_moves_between_devices_and_flows_gradients():
    _, top = _ops(10, 100)
    assert top.to(torch.device("cpu")) is top
    c = torch.from_numpy(_points(6, 4, 10)).requires_grad_(True)
    torch.sum(torch.cos(top.apply(c))).backward()
    np.testing.assert_allclose(
        c.grad.numpy(), (-torch.sin(top.apply(c.detach())) @ top.materialize().T).numpy(),
        rtol=1e-4, atol=1e-4,
    )
    with pytest.raises(ValueError, match="expected diags"):
        tfo.StructuredOperator(top.diags, top.radii[:1], top.rho, 10, 100)


@pytest.mark.parametrize("n,m,n_pts", [(10, 1000, 333), (20, 70, 200), (100, 300, 129)])
def test_structured_kernel_plain_matches_reference(n, m, n_pts):
    """Kernel 4's plain version (d = 32 and d = 128): the reference's Pallas
    kernel in interpret mode and the explicit-Hadamard oracle, 1e-4 on
    sums / N, at ragged N and m."""
    jop, top = _ops(n, m, seed=n)
    x = _points(8, n_pts, n, 2.0)
    beta = np.random.default_rng(9).uniform(size=n_pts).astype(np.float32)
    jc, js = jops.fourier_sketch_sums(jnp.asarray(x), jop, jnp.asarray(beta), block_n=128,
                                      interpret=True)
    proj = np.asarray(jref.structured_project_ref(jnp.asarray(x), jop.diags, jop.radii))[:, :m]
    oc, os_ = beta @ np.cos(proj), beta @ np.sin(proj)
    tc, ts = tft.structured_sketch_sums_plain(
        torch.from_numpy(x), top.diags, top.radii, torch.from_numpy(beta)
    )
    assert tc.shape == (top.nblocks, top.d)
    for got, ref in ((tc, jc), (ts, js), (tc, oc), (ts, os_)):
        np.testing.assert_allclose(got.reshape(-1)[:m].numpy() / n_pts, np.asarray(ref) / n_pts,
                                   atol=1e-4)
    kc, ks = kops.fourier_sketch_sums(torch.from_numpy(x), top, torch.from_numpy(beta))
    assert torch.equal(kc, tc.reshape(-1)[:m]) and torch.equal(ks, ts.reshape(-1)[:m])


@pytest.mark.parametrize("bits", [1, 4])
@pytest.mark.parametrize("n,m,n_pts", [(10, 1000, 333), (100, 300, 129)])
def test_quantized_structured_kernel_plain_matches_reference(bits, n, m, n_pts):
    """Kernel 5's plain version against the reference's Pallas kernel
    (interpret mode), with the dither zero-padded to the block tail, under the
    boundary rule."""
    jop, top = _ops(n, m, seed=n + bits)
    x = _points(10, n_pts, n, 2.0)
    dither = np.random.default_rng(11).uniform(0, 2 * np.pi, m).astype(np.float32)
    ref = jops.quantized_fourier_sketch_sums(jnp.asarray(x), jop, jnp.asarray(dither),
                                             bits=bits, block_n=128, interpret=True)
    got = kops.quantized_fourier_sketch_sums(torch.from_numpy(x), top, torch.from_numpy(dither),
                                             bits)
    assert got[0].dtype == torch.int32 and got[0].shape == (m,)
    theta = np.asarray(jop.apply(jnp.asarray(x))) + dither
    _assert_sums_within_flips(got, ref, theta, bits)


def _butterfly(v, nx=None):
    """The kernels' unnormalised WHT along the last axis, level by level in
    their order (h = 1, 2, 4, ...; lower a + b, upper a - b).  With ``nx``,
    the values at ``k >= nx`` are zeros and levels ``h >= nx`` copy each
    lower value up, as the d = 32 kernel's first stage does."""
    d = v.shape[-1]
    h = 1
    while h < d:
        w = v.reshape(*v.shape[:-1], d // (2 * h), 2, h)
        a, b = w[..., 0, :], w[..., 1, :]
        pair = (a, a) if nx is not None and h >= nx else (a + b, a - b)
        v = torch.stack(pair, dim=-2).reshape(v.shape)
        h *= 2
    return v


def _kernel_phases(x, diags, radii, nx=None, fold=True):
    """float32 model of the structured kernels' phases ``(N, nblocks, d)``:
    x (times the first signs) padded with zeros, three butterfly stages,
    the scale c; with ``fold`` each later stage's sign rides on the previous
    stage's scale (``v * (+-c)``, one rounding), else it is applied after the
    scale (``(v * c) * (+-1)``); then the radius, rounded."""
    n_pts, n = x.shape
    nblocks, _, d = diags.shape
    c = tft.inv_sqrt(d)
    v = torch.zeros((n_pts, nblocks, d), dtype=torch.float32)
    v[..., :n] = x[:, None, :] * diags[:, 0, :n]
    for s in range(3):
        if s:
            v = v * (diags[:, s] * c) if fold else (v * c) * diags[:, s]
        v = _butterfly(v, nx if s == 0 else None)
    return (v * c) * radii


def _kernel_nx(n, d):
    """The first stage's nonzero width of the kernel instance for (n, d)."""
    if d > 32:
        return None
    return 16 if n <= 16 else None


@pytest.mark.parametrize("n,m,n_pts", [(10, 1000, 333), (10, 77, 129), (100, 300, 129)])
def test_kernel_butterfly_model_matches_reference(n, m, n_pts):
    """The kernels' butterfly (the float32 model above, in their level order,
    the signs folded into +-c) against the reference's
    ``structured_sketch_kernel`` in interpret mode and the ``hd_chain``
    oracle, on shared numpy inputs: 1e-4 on sums / N, at d = 32 and 128,
    ragged N and m.  Its phases are the Kronecker form's to float32
    rounding; its 1-bit codes (read off the reduced phase) are the
    reference's quantized kernel's under the boundary rule."""
    jop, top = _ops(n, m, seed=n + 1)
    x = _points(20, n_pts, n, 2.0)
    beta = np.random.default_rng(21).uniform(size=n_pts).astype(np.float32)
    phases = _kernel_phases(torch.from_numpy(x), top.diags, top.radii, _kernel_nx(n, top.d))
    flat = phases.reshape(n_pts, -1)[:, :m].double().numpy()
    kc, ks = beta @ np.cos(flat), beta @ np.sin(flat)
    jc, js = jops.fourier_sketch_sums(jnp.asarray(x), jop, jnp.asarray(beta), block_n=128,
                                      interpret=True)
    proj = np.asarray(jref.structured_project_ref(jnp.asarray(x), jop.diags, jop.radii))[:, :m]
    for got, ref in ((kc, jc), (ks, js), (kc, beta @ np.cos(proj)), (ks, beta @ np.sin(proj))):
        np.testing.assert_allclose(got / n_pts, np.asarray(ref) / n_pts, atol=1e-4)
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, top.d - n))
    oracle = tft.hd_chain(xp[:, None, :], top.diags) * top.radii
    np.testing.assert_allclose(phases.numpy(), oracle.numpy(), rtol=1e-5, atol=1e-5)

    dither = np.random.default_rng(22).uniform(0, 2 * np.pi, m).astype(np.float32)
    theta = (phases.reshape(n_pts, -1)[:, :m] + torch.from_numpy(dither)).numpy()
    qc, qs = _one_bit_codes(theta)
    ref = jops.quantized_fourier_sketch_sums(jnp.asarray(x), jop, jnp.asarray(dither), bits=1,
                                             block_n=128, interpret=True)
    _assert_sums_within_flips((qc.sum(0), qs.sum(0)), ref,
                              np.asarray(jop.apply(jnp.asarray(x))) + dither, 1)


@pytest.mark.parametrize("n,d", [(1, 32), (3, 32), (10, 32), (16, 32), (20, 32), (32, 32),
                                 (40, 64), (100, 128)])
def test_kernel_butterfly_skip_and_fold_keep_the_bits(n, d):
    """The design's two shortcuts change no bit of the phases: folding each
    stage's sign into the previous scale (``v * (+-c)`` for
    ``(v * c) * (+-1)``), and skipping the first stage's levels that the
    zero padding makes trivial (d = 32, n <= 16)."""
    rng = np.random.default_rng(n + d)
    nblocks = 3
    diags = torch.from_numpy(rng.choice(np.array([-1.0, 1.0], np.float32), (nblocks, 3, d)))
    radii = torch.from_numpy(rng.uniform(0.1, 3.0, (nblocks, d)).astype(np.float32))
    x = torch.from_numpy(_points(n, 257, n, 3.0))
    new = _kernel_phases(x, diags, radii, _kernel_nx(n, d), fold=True)
    old = _kernel_phases(x, diags, radii, None, fold=False)
    assert torch.equal(new, old)


def test_one_bit_codes_from_the_reduced_phase_follow_float64_signs():
    """The 1-bit kernels skip the trig: the codes of the header's helper
    (``one_bit_signs``, which kernels 3 and 5 both call), read off the phase
    reduced as ``sincos_reduced.cuh`` does, are the signs of float64 cos and
    sin of the float32 phase for |p| <= 1e5, except within 1e-6 rad of a
    boundary (cos: pi/2 + k pi; sin: k pi).  The exceptions are counted;
    points at a boundary are drawn on purpose.  A NaN phase codes to -1 for
    both, as ``c >= 0 ? 1 : -1`` gives."""
    csrc = Path(tft.__file__).parent / "csrc"
    helper = (csrc / "sincos_reduced.cuh").read_text()
    assert "kHalfPi" in helper and "one_bit_signs" in helper
    for user in ("quantized_fourier_sketch.cu", "structured_sketch.cu"):
        assert re.search(r"\bone_bit_signs\s*\(", (csrc / user).read_text()), user
    rng = np.random.default_rng(0)
    k = rng.integers(-31_830, 31_830, 20_000)
    near = np.concatenate([k * np.pi, (k + 0.5) * np.pi]) + rng.uniform(-2e-6, 2e-6, 40_000)
    p = np.concatenate([rng.uniform(-1e5, 1e5, 1_000_000), near,
                        rng.uniform(-10.0, 10.0, 100_000)]).astype(np.float32)
    p = p[np.abs(p) <= 1e5]
    qc, qs = _one_bit_codes(p)
    p64 = p.astype(np.float64)
    want_c = np.where(np.cos(p64) >= 0, 1, -1)
    want_s = np.where(np.sin(p64) >= 0, 1, -1)
    dist_c = np.abs(np.remainder(p64 - np.pi / 2 + np.pi / 2, np.pi) - np.pi / 2)
    dist_s = np.abs(np.remainder(p64 + np.pi / 2, np.pi) - np.pi / 2)
    bad_c, bad_s = qc != want_c, qs != want_s
    assert np.all(dist_c[bad_c] <= 1e-6) and np.all(dist_s[bad_s] <= 1e-6), (
        dist_c[bad_c].max(initial=0), dist_s[bad_s].max(initial=0))
    # Away from the drawn boundary points the exceptions are rare: a phase
    # lands within 1e-6 rad of a boundary about 1.3e-6 of the time.
    uniform = slice(0, 1_000_000)
    assert int(bad_c[uniform].sum() + bad_s[uniform].sum()) <= 10
    assert int(bad_c.sum() + bad_s.sum()) < len(near)
    nan_c, nan_s = _one_bit_codes(np.array([np.nan, np.inf, -np.inf], np.float32))
    assert nan_c.tolist() == [-1] * 3 and nan_s.tolist() == [-1] * 3


H100_SMS = 132


@pytest.mark.parametrize("n_pts,nblocks,fb,resident", [
    (10**7, 32, 8, 2), (10**6, 32, 8, 2), (1_000_003, 32, 8, 2), (100_003, 10, 1, 1),
    (20_001, 3, 8, 2), (20_001, 3, 1, 1), (1, 1, 8, 2), (10**10, 640, 1, 2),
])
def test_structured_grid_covers_each_row_once_in_one_wave(n_pts, nblocks, fb, resident):
    """The structured kernels' launch geometry: the groups' row ranges
    ``[g * rows, min(N, (g + 1) * rows))`` tile [0, N) with none empty, the
    CTAs' frequency blocks cover nblocks, the grid is at most one wave of the
    resident CTAs, a large N gets a CTA on every SM, and the double partials
    do not grow with N."""
    rows, groups, col_blocks = tft.structured_grid(n_pts, nblocks, fb, H100_SMS, resident)
    assert (groups - 1) * rows < n_pts <= groups * rows
    assert (col_blocks - 1) * fb < nblocks <= col_blocks * fb
    assert groups * col_blocks <= max(resident * H100_SMS, col_blocks)
    if n_pts >= 256 * H100_SMS * col_blocks:
        assert groups * col_blocks >= H100_SMS
    assert groups <= max(1, resident * H100_SMS // col_blocks)


def test_plain_versions_are_chunked_invisibly(monkeypatch):
    """Rows summed over several chunks give the one-chunk sums: exactly for
    the integer codes, to float rounding for the float sums."""
    _, top = _ops(10, 100)
    x = torch.from_numpy(_points(12, 500, 10, 2.0))
    beta = torch.ones(500)
    dth = torch.rand((top.nblocks, top.d), generator=torch.Generator().manual_seed(0))
    whole_f = tft.structured_sketch_sums_plain(x, top.diags, top.radii, beta)
    whole_q = tft.quantized_structured_sketch_sums_plain(x, top.diags, top.radii, dth, 1)
    monkeypatch.setattr(tft, "_PLAIN_ELEMS", 64 * top.nblocks * top.d)
    parts_f = tft.structured_sketch_sums_plain(x, top.diags, top.radii, beta)
    parts_q = tft.quantized_structured_sketch_sums_plain(x, top.diags, top.radii, dth, 1)
    for a, b in zip(whole_f, parts_f):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(whole_q, parts_q))


def test_engine_structured_quantized_state_matches_reference_engine():
    """The slice's sketch pass: structured operator + 1-bit codes in the
    engine, operator and dither carried over; states under the boundary
    rule, and the finalized sketch of the reference's state to 1e-5."""
    n, m = 10, 300
    jop, top = _ops(n, m, seed=3)
    x = _points(13, 700, n, 2.0)
    dither = np.random.default_rng(14).uniform(0, 2 * np.pi, m).astype(np.float32)
    jengine = jeng.SketchEngine(jop, "pallas", interpret=True,
                                quantizer=jqz.SketchQuantizer(1, jnp.asarray(dither)))
    jstate = jengine.update(jengine.init_state(), jnp.asarray(x))
    eng = SketchEngine(top, device="cpu",
                       quantizer=convert.quantizer_from_numpy(1, dither, device="cpu"))
    state = eng.update(eng.init_state(), torch.from_numpy(x))
    theta = np.asarray(jop.apply(jnp.asarray(x))) + dither
    _assert_sums_within_flips(state[:2], jstate[:2], theta, 1)
    carried = convert.quantized_state_from_numpy(*(np.asarray(v) for v in jstate), device="cpu")
    for got, ref in zip(eng.finalize(carried), jengine.finalize(jstate)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", ["none", "1bit"])
def test_compute_sketch_structured_matches_reference_on_carried_operator(quant, gaussian_blobs):
    """``compute_sketch`` with ``freq_op="structured"``: the port's engine on
    the reference's operator (and dither) gives the reference's sketch —
    1e-4 for float sums / N; for 1 bit, within (pi/4)·2·flips/N per entry."""
    x = np.array(gaussian_blobs[0])[:3000]
    cfg = jckm.CKMConfig(k=5, freq_op="structured", sketch_quantization=quant)
    key = jax.random.PRNGKey(4)
    jz, jop, _, (jlo, jhi) = jckm.compute_sketch(key, jnp.asarray(x), cfg)
    top = convert.structured_operator_from_numpy(
        np.asarray(jop.diags), np.asarray(jop.radii), np.asarray(jop.rho), jop.n, jop.m,
        device="cpu",
    )
    jq = jckm.make_quantizer(key, cfg, jop.m)
    q = None if jq is None else convert.quantizer_from_numpy(jq.bits, np.asarray(jq.dither),
                                                             device="cpu")
    tcfg = tckm.CKMConfig(k=5, freq_op="structured", sketch_quantization=quant)
    z, lo, hi = tckm.make_engine(top, tcfg, "cpu", q).sketch(torch.from_numpy(x))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    if q is None:
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-4)
        return
    theta = np.asarray(jop.apply(jnp.asarray(x))) + np.asarray(jq.dither)
    near = [np.sum(np.abs(np.asarray(f(jnp.asarray(theta)))) < BOUNDARY, axis=0)
            for f in (jnp.cos, jnp.sin)]
    # Each flipped code moves a dequantized entry by at most (pi/4)*2/N in
    # each of the two rotated components.
    bound = (np.pi / 4) * 2 * np.concatenate([near[0] + near[1]] * 2) / len(x) + 1e-6
    assert np.all(np.abs(z.numpy() - np.asarray(jz)) <= bound)


def _matched_error(cents, means):
    dist = np.linalg.norm(np.asarray(cents)[:, None] - np.asarray(means)[None], axis=-1)
    rows, cols = linear_sum_assignment(dist)
    return float(dist[rows, cols].max())


@pytest.mark.parametrize("quant", ["none", "1bit"])
def test_fit_structured_recovers_the_blobs_like_the_reference(quant, gaussian_blobs):
    """The slice end to end: ``fit`` with the structured operator (and 1-bit
    QCKM), fixed seeds, two replicates on both sides.  Each side's centroids
    lie within one cluster std (1.0) of the true means."""
    x, _, means = gaussian_blobs
    jcfg = jckm.CKMConfig(k=5, replicates=2, freq_op="structured",
                          sketch_quantization=quant, **SMALL)
    jres = jckm.fit(jax.random.PRNGKey(2), x, jcfg)
    tcfg = tckm.CKMConfig(k=5, replicates=2, freq_op="structured",
                          sketch_quantization=quant, **SMALL)
    res = tckm.fit(5, torch.from_numpy(np.array(x)), tcfg, device="cpu")
    assert isinstance(res.freq_op, tfo.StructuredOperator) and res.centroids.shape == (5, 4)
    assert _matched_error(jres.centroids, means) < 1.0
    assert _matched_error(res.centroids.numpy(), means) < 1.0


def test_fit_streaming_quantized_sketch_equals_in_memory_sketch(gaussian_blobs):
    """Integer sums are split-invariant: the streaming 1-bit structured
    sketch equals the in-memory one bitwise, with the same operator."""
    x = torch.from_numpy(np.array(gaussian_blobs[0]))
    cfg = tckm.CKMConfig(k=5, freq_op="structured", sketch_quantization="1bit", **SMALL)
    z, op, _, _ = tckm.compute_sketch(3, x, cfg, device="cpu")
    zs, ops, _, _, _ = tckm.compute_sketch_streaming(3, torch.split(x, 2500), cfg, device="cpu")
    assert torch.equal(op.diags, ops.diags) and torch.equal(op.radii, ops.radii)
    assert torch.equal(z, zs)
    # The float twin draws the same operator (its own generator streams).
    float_cfg = dataclasses.replace(cfg, sketch_quantization="none")
    zf, opf, _, _ = tckm.compute_sketch(3, x, float_cfg, device="cpu")
    assert torch.equal(opf.radii, op.radii) and not torch.equal(zf, z)
