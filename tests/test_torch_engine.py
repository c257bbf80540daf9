"""The port's sketch and SketchEngine against the reference, plus the
engine's monoid laws and the converters that carry reference values over."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import freq_ops as jfo
from repro.core import sketch as jsk
from repro.core.engine import SketchEngine as JaxEngine
from repro_torch import convert
from repro_torch.core import sketch as tsk
from repro_torch.core.engine import SketchEngine, SketchEngineState

pytestmark = pytest.mark.torch_port


def _data(seed, n_pts=600, feat=5, m=48):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_pts, feat)) * 2).astype(np.float32)
    w = rng.standard_normal((feat, m)).astype(np.float32)
    return x, w


def _engine(w):
    return SketchEngine(convert.operator_from_numpy(w, device="cpu"), device="cpu")


def _assert_states_close(a, b, atol=1e-4):
    for f in SketchEngineState._fields:
        np.testing.assert_allclose(
            getattr(a, f).numpy(), getattr(b, f).numpy(), rtol=1e-5, atol=atol, err_msg=f
        )


@pytest.mark.parametrize("cuts", [(100, 350), (1, 599), (300, 300)])
def test_merge_associative_and_commutative(cuts):
    x, w = _data(0)
    eng = _engine(w)
    xt = torch.from_numpy(x)
    parts = [xt[: cuts[0]], xt[cuts[0] : cuts[1]], xt[cuts[1] :]]
    parts = [p for p in parts if len(p)]
    states = [eng.update(eng.init_state(), p) for p in parts]
    left = states[0]
    for s in states[1:]:
        left = eng.merge(left, s)
    right = states[-1]
    for s in reversed(states[:-1]):
        right = eng.merge(s, right)
    _assert_states_close(left, right)
    _assert_states_close(eng.merge(eng.init_state(), left), left, atol=0)


@pytest.mark.parametrize("n_chunks", [2, 7])
def test_update_splits_equal_one_shot_sketch(n_chunks):
    x, w = _data(1)
    eng = _engine(w)
    z_one, lo_one, hi_one = eng.sketch(torch.from_numpy(x))
    z_str, lo_str, hi_str = eng.sketch_stream(torch.from_numpy(c) for c in np.array_split(x, n_chunks))
    np.testing.assert_allclose(z_str.numpy(), z_one.numpy(), atol=1e-5)
    assert torch.equal(lo_one, lo_str) and torch.equal(hi_one, hi_str)


def test_engine_sketch_matches_reference_xla_engine():
    """Same W (carried over by convert), same points, same weights: 1e-4."""
    x, w = _data(2, n_pts=1000, feat=10, m=130)
    wts = np.random.default_rng(2).uniform(size=1000).astype(np.float32)
    jz, jlo, jhi = JaxEngine(jnp.asarray(w), "xla").sketch(jnp.asarray(x), jnp.asarray(wts))
    tz, tlo, thi = _engine(w).sketch(torch.from_numpy(x), torch.from_numpy(wts))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-4)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))


def test_reference_state_carries_over_and_finalizes_alike():
    x, w = _data(3)
    jeng = JaxEngine(jnp.asarray(w), "xla")
    jstate = jeng.update(jeng.init_state(), jnp.asarray(x))
    state = convert.state_from_numpy(*(np.asarray(v) for v in jstate), device="cpu")
    eng = _engine(w)
    for got, ref in zip(eng.finalize(state), jeng.finalize(jstate)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    # ... and it merges with a state the port built itself.
    more = eng.update(eng.init_state(), torch.from_numpy(x))
    z2, _, _ = eng.finalize(eng.merge(state, more))
    np.testing.assert_allclose(z2.numpy(), np.asarray(jeng.finalize(jstate)[0]), atol=1e-5)
    with pytest.raises(ValueError, match="inconsistent"):
        convert.state_from_numpy(*(np.asarray(v) for v in jstate[:-1]), np.ones(2), device="cpu")


def test_empty_and_zero_weight_states_finalize_to_zero_sketch():
    x, w = _data(4)
    eng = _engine(w)
    z, lo, hi = eng.finalize(eng.init_state())
    assert torch.equal(z, torch.zeros(2 * w.shape[1]))
    assert torch.isinf(lo).all() and torch.isinf(hi).all()
    state = eng.update(eng.init_state(), torch.from_numpy(x), torch.zeros(len(x)))
    z, _, _ = eng.finalize(state)
    assert torch.equal(z, torch.zeros(2 * w.shape[1]))


def test_engine_rejects_bad_input():
    _, w = _data(5)
    with pytest.raises(ValueError, match="backend"):
        SketchEngine(torch.from_numpy(w), "pallas", device="cpu")
    eng = _engine(w)
    with pytest.raises(ValueError, match="batch must be"):
        eng.update(eng.init_state(), torch.zeros((3, w.shape[0] + 1)))
    with pytest.raises(TypeError, match="mismatched"):
        eng.merge(eng.init_state(), tuple(eng.init_state()))


def test_sketch_and_atoms_match_reference():
    x, w = _data(6, n_pts=700)
    jop = jfo.as_operator(jnp.asarray(w))
    np.testing.assert_allclose(
        tsk.sketch(torch.from_numpy(x), torch.from_numpy(w), chunk=128).numpy(),
        np.asarray(jsk.sketch(jnp.asarray(x), jop, chunk=128)),
        atol=1e-5,
    )
    cs = x[:6]
    np.testing.assert_allclose(
        tsk.atoms(torch.from_numpy(cs), torch.from_numpy(w)).numpy(),
        np.asarray(jsk.atoms(jnp.asarray(cs), jop)), atol=1e-5,
    )
    np.testing.assert_allclose(
        tsk.atom(torch.from_numpy(cs[0]), torch.from_numpy(w)).numpy(),
        np.asarray(jsk.atom(jnp.asarray(cs[0]), jop)), atol=1e-5,
    )
    assert tsk.atom_norm(48) == pytest.approx(jsk.atom_norm(48))
    lo, hi = tsk.data_bounds(torch.from_numpy(x))
    jlo, jhi = jsk.data_bounds(jnp.asarray(x))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


def test_complex_round_trip_matches_reference():
    z = np.random.default_rng(7).standard_normal(20).astype(np.float32)
    zc = tsk.to_complex(torch.from_numpy(z))
    np.testing.assert_allclose(zc.numpy(), np.asarray(jsk.to_complex(jnp.asarray(z))))
    assert torch.equal(tsk.from_complex(zc), torch.from_numpy(z))


def test_engine_moves_operator_to_its_device_and_defaults_to_the_card():
    _, w = _data(8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SketchEngine(torch.from_numpy(w))
    eng = _engine(w)
    assert eng.freq_op.materialize().device == torch.device("cpu") and (eng.n, eng.m) == w.shape
