"""The port's QCKM quantized sketch against the reference: the pure helpers,
the codes, the chunked and fused sums (kernel 3's plain version), the
dequantization, the quantized engine state and its monoid laws.

Integer codes are compared under the boundary rule of ``_torch_codes``:
exact except where the reference's argument lies within 1e-5 of a rounding
boundary, and code sums within twice the count of such points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import freq_ops as jfo
from repro.core import quantize as jqz
from repro.core import sketch as jsk
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import quantize as tqz
from repro_torch.core import sketch as tsk
from repro_torch.core.engine import QuantizedSketchEngineState, SketchEngine
from repro_torch.kernels import fourier_sketch as fs
from repro_torch.kernels import ops as kops

from _torch_codes import assert_sums_within_flips as _assert_sums_within_flips
from _torch_codes import fma32 as _fma32
from _torch_codes import on_boundary as _on_boundary
from _torch_codes import one_bit_codes as _one_bit_codes

pytestmark = pytest.mark.torch_port


def _data(seed, n_pts=333, feat=5, m=45):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_pts, feat)) * 2).astype(np.float32)
    w = rng.standard_normal((feat, m)).astype(np.float32)
    dither = rng.uniform(0, 2 * np.pi, size=m).astype(np.float32)
    return x, w, dither


@pytest.mark.parametrize(
    "spec", ["none", "off", "1bit", "4bit", "16bit", "8-bit", "2", "0bit", "17bit"]
)
def test_parse_bits_matches_reference(spec):
    try:
        want = jqz.parse_bits(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tqz.parse_bits(spec)
        return
    assert tqz.parse_bits(spec) == want


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_scale_capacity_and_wire_bytes_match_reference(bits):
    assert tqz.quantization_scale(bits) == jqz.quantization_scale(bits)
    assert tqz.accumulator_capacity(bits) == jqz.accumulator_capacity(bits)
    for m, count in [(1000, 1), (1000, 8000), (50, 10**7), (7, 2**31)]:
        assert tqz.state_wire_bytes(m, count, bits) == jqz.state_wire_bytes(m, count, bits)
    assert tqz.state_wire_bytes(1000, 8000, None) == jqz.state_wire_bytes(1000, 8000, None)


@pytest.mark.parametrize("bits", [1, 4])
def test_quantize_codes_match_reference_except_at_boundaries(bits):
    """Per-point codes on shared phases: exact except where the reference's
    argument lies on a rounding boundary."""
    x, w, dither = _data(0, n_pts=400, m=64)
    proj = x @ w
    valid = (np.arange(400) % 7 != 3).astype(np.float32)[:, None]
    jc, js = jqz.quantize_codes(jnp.asarray(proj), jnp.asarray(dither), bits, jnp.asarray(valid))
    tc, ts = tqz.quantize_codes(
        torch.from_numpy(proj), torch.from_numpy(dither), bits, torch.from_numpy(valid)
    )
    assert tc.dtype == torch.int32 and ts.dtype == torch.int32
    theta = np.asarray(jnp.asarray(proj) + jnp.asarray(dither))
    for got, ref, trig in ((tc, jc, jnp.cos), (ts, js, jnp.sin)):
        bad = got.numpy() != np.asarray(ref)
        assert np.all(_on_boundary(np.asarray(trig(jnp.asarray(theta))), bits)[bad])
        assert np.all(got.numpy()[valid[:, 0] == 0] == 0)


def test_quantize_codes_sign_conventions_match_reference():
    """1 bit: ``c >= 0`` is +1, so NaN gives -1 as ``jnp.where`` does; b bits
    round half to even as ``jnp.round`` does."""
    proj = np.array([np.nan, 0.0, np.pi / 2, np.pi], np.float32)
    zero = np.zeros(4, np.float32)
    for bits in (1, 4):
        jc, js = jqz.quantize_codes(jnp.asarray(proj), jnp.asarray(zero), bits)
        tc, ts = tqz.quantize_codes(torch.from_numpy(proj), torch.from_numpy(zero), bits)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    half = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5])
    assert torch.round(half).tolist() == np.asarray(jnp.round(jnp.asarray(half.numpy()))).tolist()


@pytest.mark.parametrize("bits", [1, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_sketch_quantized_matches_reference(bits, masked):
    """The chunked plain QCKM sums over a dense operator, at ragged N."""
    x, w, dither = _data(1)
    valid = (np.arange(len(x)) % 5 != 0).astype(np.float32) if masked else None
    jv = None if valid is None else jnp.asarray(valid)
    ref = jsk.sketch_quantized(
        jnp.asarray(x), jfo.as_operator(jnp.asarray(w)), jnp.asarray(dither), jv, bits, chunk=128
    )
    got = tsk.sketch_quantized(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dither),
        None if valid is None else torch.from_numpy(valid), bits, chunk=100,
    )
    assert got[0].dtype == torch.int32
    _assert_sums_within_flips(got, ref, x @ w + dither, bits, valid)


@pytest.mark.parametrize("bits", [1, 4])
@pytest.mark.parametrize("n_pts,feat,m", [(333, 10, 1000), (1, 3, 7), (517, 24, 130)])
def test_quantized_kernel_plain_matches_reference_kernel(bits, n_pts, feat, m):
    """Kernel 3's plain version against the reference's Pallas kernel
    (interpret mode), at ragged N and m."""
    x, w, dither = _data(2, n_pts, feat, m)
    ref = jops.quantized_fourier_sketch_sums(
        jnp.asarray(x), jfo.as_operator(jnp.asarray(w)), jnp.asarray(dither), bits=bits,
        block_n=128, block_m=128, interpret=True,
    )
    got = fs.quantized_fourier_sketch_sums_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dither), bits
    )
    _assert_sums_within_flips(got, ref, x @ w + dither, bits)
    same = kops.quantized_fourier_sketch_sums(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dither), bits
    )
    assert all(torch.equal(a, b) for a, b in zip(same, got))


@pytest.mark.parametrize("n_pts,feat,m", [(333, 10, 1000), (129, 3, 77), (130, 100, 77)])
def test_quantized_kernel_one_bit_arithmetic_matches_reference(n_pts, feat, m):
    """Kernel 3's 1-bit arithmetic, emulated in float32 on the CPU: the phase
    as its FMA chain (k ascending, as both its paths carry it), the dither
    added and rounded apart, both codes read off the reduced phase
    (``one_bit_signs``, no trig), valid truncated to int, and each code sum
    formed as the kernel forms it, 2 * (valid-weighted count of +1 codes) -
    (sum of valid).  Against the reference's Pallas kernel in interpret mode
    with a 0 / 1 / 1.7 mask, under the boundary rule; the plain version
    too."""
    x, w, dither = _data(7, n_pts, feat, m)
    valid = np.resize(np.array([1.0, 0.0, 1.7, 1.0], np.float32), n_pts)
    phase = np.zeros((n_pts, m), np.float32)
    for k in range(feat):
        phase = _fma32(x[:, k:k + 1], w[k:k + 1, :], phase)
    theta = (phase.astype(np.float64) + dither).astype(np.float32)
    v = valid.astype(np.int32)[:, None]
    got = tuple(2 * np.where(q > 0, v, 0).sum(axis=0) - v.sum() for q in _one_bit_codes(theta))
    assert all(np.array_equal(g, (q * v).sum(axis=0)) for g, q in zip(got, _one_bit_codes(theta)))
    ref = jops.quantized_fourier_sketch_sums(
        jnp.asarray(x), jfo.as_operator(jnp.asarray(w)), jnp.asarray(dither),
        valid=jnp.asarray(valid), bits=1, block_n=128, block_m=128, interpret=True,
    )
    _assert_sums_within_flips(got, ref, x @ w + dither, 1, valid)
    plain = fs.quantized_fourier_sketch_sums_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dither), 1,
        valid=torch.from_numpy(valid),
    )
    _assert_sums_within_flips(plain, ref, x @ w + dither, 1, valid)


@pytest.mark.parametrize("bits", [1, 4])
def test_dequantize_sums_matches_reference(bits):
    rng = np.random.default_rng(3)
    q = rng.integers(-500, 500, size=(2, 60)).astype(np.int32)
    dither = rng.uniform(0, 2 * np.pi, 60).astype(np.float32)
    ref = jqz.dequantize_sums(jnp.asarray(q[0]), jnp.asarray(q[1]), jnp.asarray(dither), bits)
    got = tqz.dequantize_sums(
        torch.from_numpy(q[0]), torch.from_numpy(q[1]), torch.from_numpy(dither), bits
    )
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def _reference_engine(w, dither, bits):
    q = jqz.SketchQuantizer(bits, jnp.asarray(dither))
    return jeng.SketchEngine(jfo.as_operator(jnp.asarray(w)), "xla", quantizer=q)


def _engine(w, dither, bits):
    q = convert.quantizer_from_numpy(bits, dither, device="cpu")
    return SketchEngine(convert.operator_from_numpy(w, device="cpu"), device="cpu", quantizer=q)


@pytest.mark.parametrize("bits", [1, 4])
def test_engine_finalize_matches_reference_on_shared_state(bits):
    """The reference's quantized state, carried over, finalizes alike: 1e-5."""
    x, w, dither = _data(4)
    jengine = _reference_engine(w, dither, bits)
    jstate = jengine.update(jengine.init_state(), jnp.asarray(x))
    state = convert.quantized_state_from_numpy(*(np.asarray(v) for v in jstate), device="cpu")
    assert state.qcos_acc.dtype == torch.int32
    for got, ref in zip(_engine(w, dither, bits).finalize(state), jengine.finalize(jstate)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="inconsistent"):
        convert.quantized_state_from_numpy(*(np.asarray(v) for v in jstate[:-1]), np.ones(2),
                                           device="cpu")


@pytest.mark.parametrize("bits", [1, 4])
def test_engine_state_matches_reference_engine(bits):
    """The port's own quantized state from the same points: integer sums
    within the boundary rule, bounds and counts equal."""
    x, w, dither = _data(5, n_pts=500)
    jengine = _reference_engine(w, dither, bits)
    jstate = jengine.update(jengine.init_state(), jnp.asarray(x))
    eng = _engine(w, dither, bits)
    state = eng.update(eng.init_state(), torch.from_numpy(x))
    assert isinstance(state, QuantizedSketchEngineState)
    _assert_sums_within_flips(state[:2], jstate[:2], x @ w + dither, bits)
    for f in ("weight_sum", "lower", "upper", "count"):
        np.testing.assert_array_equal(getattr(state, f).numpy(), np.asarray(getattr(jstate, f)))


@pytest.mark.parametrize("spec", ["1bit", "4bit"])
@pytest.mark.parametrize("cuts", [(50, 200), (1, 332), (150, 150)])
def test_merge_is_bitwise_associative_and_commutative(spec, cuts):
    x, w, dither = _data(6)
    eng = _engine(w, dither, tqz.parse_bits(spec))
    xt = torch.from_numpy(x)
    parts = [p for p in (xt[: cuts[0]], xt[cuts[0] : cuts[1]], xt[cuts[1] :]) if len(p)]
    states = [eng.update(eng.init_state(), p) for p in parts]
    left = states[0]
    for s in states[1:]:
        left = eng.merge(left, s)
    right = states[-1]
    for s in reversed(states[:-1]):
        right = eng.merge(s, right)
    swapped = eng.merge(states[-1], states[0]) if len(states) == 2 else None
    for f in QuantizedSketchEngineState._fields:
        assert torch.equal(getattr(left, f), getattr(right, f)), f
        assert torch.equal(getattr(eng.merge(eng.init_state(), left), f), getattr(left, f)), f
        if swapped is not None:
            assert torch.equal(getattr(swapped, f), getattr(left, f)), f


@pytest.mark.parametrize("n_chunks", [2, 5, 333])
def test_split_invariance_is_exact(n_chunks):
    x, w, dither = _data(7)
    eng = _engine(w, dither, 1)
    whole = eng.update(eng.init_state(), torch.from_numpy(x))
    state = eng.init_state()
    for c in np.array_split(x, n_chunks):
        state = eng.update(state, torch.from_numpy(c))
    for f in QuantizedSketchEngineState._fields:
        assert torch.equal(getattr(state, f), getattr(whole, f)), f
    z_one, _, _ = eng.sketch(torch.from_numpy(x))
    z_str, _, _ = eng.sketch_stream(torch.from_numpy(c) for c in np.array_split(x, n_chunks))
    assert torch.equal(z_one, z_str)


def test_weights_rejected_and_flavours_do_not_mix():
    x, w, dither = _data(8, n_pts=20)
    eng = _engine(w, dither, 1)
    with pytest.raises(ValueError, match="unit-weight"):
        eng.update(eng.init_state(), torch.from_numpy(x), torch.ones(20))
    float_eng = SketchEngine(torch.from_numpy(w), device="cpu")
    with pytest.raises(TypeError, match="mismatched"):
        eng.merge(eng.init_state(), float_eng.init_state())


def test_capacity_check_raises_past_int32_capacity():
    x, w, dither = _data(9, n_pts=10)
    eng = _engine(w, dither, 16)
    state = eng.update(eng.init_state(), torch.from_numpy(x))
    eng.finalize(state)  # 10 points: fine
    cap = tqz.accumulator_capacity(16)
    over = state._replace(count=torch.tensor(float(cap + 1)))
    with pytest.raises(ValueError, match="overflow"):
        eng.finalize(over)
    eng.finalize(state._replace(count=torch.tensor(float(cap))))


def test_empty_quantized_stream_finalizes_to_zero_sketch():
    _, w, dither = _data(10)
    eng = _engine(w, dither, 1)
    z, lo, hi = eng.finalize(eng.init_state())
    assert torch.equal(z, torch.zeros(2 * w.shape[1]))
    assert torch.isinf(lo).all() and torch.isinf(hi).all()
    z, _, _ = eng.sketch_stream(iter(()))
    assert torch.equal(z, torch.zeros(2 * w.shape[1]))


def test_dither_shape_checked_and_moved_to_the_engine_device():
    _, w, dither = _data(11)
    with pytest.raises(ValueError, match="dither shape"):
        _engine(w, dither[:-1], 1)
    eng = _engine(w, dither, 4)
    assert eng.quantizer.dither.device == torch.device("cpu") and eng.quantizer.scale == 7


def test_draw_dither_is_uniform_on_the_circle():
    d = tqz.draw_dither(torch.Generator().manual_seed(0), 20000)
    assert d.dtype == torch.float32 and d.shape == (20000,)
    assert float(d.min()) >= 0.0 and float(d.max()) < 2 * np.pi
    assert abs(float(d.mean()) - np.pi) < 0.05
    assert tqz.make_quantizer(torch.Generator(), 5, "none") is None
    q = tqz.make_quantizer(torch.Generator().manual_seed(1), 5, "4bit")
    assert q.bits == 4 and q.dither.shape == (5,)
