"""The port's recurrent mixers (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) in float32 on the CPU, on shared numpy
inputs: Mamba (the causal convolution with its carried state, the chunked
scan, apply and step), mLSTM (at sequence lengths that are and are not a
multiple of the chunk) and sLSTM; each mixer's step-by-step decode against
its own full-sequence apply; the initial states.

Bars: 1e-5 of the largest reference magnitude (the scan's association
order differs from the reference's ``associative_scan`` only in float32
rounding); a step loop against the chunked apply to 1e-5 as well."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm

pytestmark = pytest.mark.torch_port

TOL = 1e-5
D, B = 16, 2


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else _t(v) for k, v in tree.items()}


def _close(got, want, tol=TOL, what=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _close(got[k], want[k], tol, f"{what}.{k}")
        return
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x {scale:.3e}"


def _x(s, seed=1, d=D):
    return np.random.default_rng(seed).standard_normal((B, s, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

MAMBA = (jssm.MambaDims(D, d_state=4, d_conv=4, expand=2, chunk=8),
         tssm.MambaDims(D, d_state=4, d_conv=4, expand=2, chunk=8))


def _mamba_params(seed=0):
    p = _np(jssm.init_mamba(jax.random.PRNGKey(seed), MAMBA[0]))
    # Spread dt and the decays so the scan's chunks carry real state.
    rng = np.random.default_rng(seed + 10)
    p["dt_bias"] = rng.uniform(-3.0, 1.0, p["dt_bias"].shape).astype(np.float32)
    p["a_log"] = p["a_log"] + rng.uniform(-1.0, 1.0, p["a_log"].shape).astype(np.float32)
    return p


def test_causal_conv_matches_the_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    state = rng.standard_normal((B, 3, 6)).astype(np.float32)
    for st in (None, state):
        yj, sj = jssm._causal_conv(x, w, b, st)
        yt, s_t = tssm._causal_conv(_t(x), _t(w), _t(b), None if st is None else _t(st))
        _close(yt, yj, what="conv y")
        _close(s_t, sj, what="conv state")


@pytest.mark.parametrize("s", [8, 24, 13, 1])
def test_mamba_apply_matches_the_reference(s):
    """S a multiple of the chunk (8), three chunks, a padded tail, one token."""
    p = _mamba_params()
    x = _x(s)
    oj, sj = jssm.mamba_apply(p, MAMBA[0], x)
    ot, st = tssm.mamba_apply(_torch(p), MAMBA[1], _t(x))
    _close(ot, oj, what="out")
    _close(st, _np(sj), what="state")
    # Continued from that state.
    x2 = _x(11, seed=3)
    oj2, sj2 = jssm.mamba_apply(p, MAMBA[0], x2, sj)
    ot2, st2 = tssm.mamba_apply(_torch(p), MAMBA[1], _t(x2), st)
    _close(ot2, oj2, what="out continued")
    _close(st2, _np(sj2), what="state continued")


def test_chunked_scan_matches_a_step_loop():
    """The chunked, log-depth scan over 29 tokens (four chunks, a padded
    tail) against 29 calls of mamba_step from the initial state."""
    p = _torch(_mamba_params(1))
    x = _t(_x(29, seed=4))
    out, state = tssm.mamba_apply(p, MAMBA[1], x)
    st = tssm.mamba_init_state(MAMBA[1], B, torch.float32, "cpu")
    outs = []
    for t in range(x.shape[1]):
        o, st = tssm.mamba_step(p, MAMBA[1], x[:, t:t + 1], st)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), out, rtol=TOL, atol=TOL)
    torch.testing.assert_close(st["ssm"], state["ssm"], rtol=TOL, atol=TOL)
    torch.testing.assert_close(st["conv"], state["conv"])


def test_scan_is_the_sequential_recurrence():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (2, 13, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 13, 3)).astype(np.float32))
    a_cum, b_cum = tssm._scan(a, b)
    h = torch.zeros((2, 3))
    prod = torch.ones((2, 3))
    for t in range(13):
        h = a[:, t] * h + b[:, t]
        prod = prod * a[:, t]
        torch.testing.assert_close(b_cum[:, t], h)
        torch.testing.assert_close(a_cum[:, t], prod)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

MLSTM = (jssm.MLSTMDims(D, n_heads=2, expand=2, chunk=8),
         tssm.MLSTMDims(D, n_heads=2, expand=2, chunk=8))


@pytest.mark.parametrize("s", [16, 21, 5])
def test_mlstm_apply_matches_the_reference(s):
    """Two whole chunks, a padded tail (log_i at -30, log_f at 0), and a
    sequence shorter than the chunk; then continued from the state."""
    p = _np(jssm.init_mlstm(jax.random.PRNGKey(2), MLSTM[0]))
    x = _x(s, seed=6)
    oj, sj = jssm.mlstm_apply(p, MLSTM[0], x)
    ot, st = tssm.mlstm_apply(_torch(p), MLSTM[1], _t(x))
    _close(ot, oj, what="out")
    _close(st, _np(sj), what="state")
    x2 = _x(9, seed=7)
    oj2, sj2 = jssm.mlstm_apply(p, MLSTM[0], x2, sj)
    ot2, st2 = tssm.mlstm_apply(_torch(p), MLSTM[1], _t(x2), st)
    _close(ot2, oj2, what="out continued")
    _close(st2, _np(sj2), what="state continued")


def test_mlstm_step_loop_matches_apply():
    p = _torch(_np(jssm.init_mlstm(jax.random.PRNGKey(3), MLSTM[0])))
    x = _t(_x(19, seed=8))
    out, state = tssm.mlstm_apply(p, MLSTM[1], x)
    st = tssm.mlstm_init_state(MLSTM[1], B, "cpu")
    outs = []
    for t in range(x.shape[1]):
        o, st = tssm.mlstm_step(p, MLSTM[1], x[:, t:t + 1], st)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), out, rtol=TOL, atol=TOL)
    for k in state:
        torch.testing.assert_close(st[k], state[k], rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

SLSTM = (jssm.SLSTMDims(D, heads=4), tssm.SLSTMDims(D, heads=4))


def test_slstm_apply_and_step_match_the_reference():
    p = _np(jssm.init_slstm(jax.random.PRNGKey(4), SLSTM[0]))
    p["b"] = np.random.default_rng(9).standard_normal(p["b"].shape).astype(np.float32)
    x = _x(12, seed=10)
    oj, sj = jssm.slstm_apply(p, SLSTM[0], x)
    ot, st = tssm.slstm_apply(_torch(p), SLSTM[1], _t(x))
    _close(ot, oj, what="out")
    _close(st, _np(sj), what="state")
    xs = _x(1, seed=11)
    oj2, sj2 = jssm.slstm_step(p, SLSTM[0], xs, sj)
    ot2, st2 = tssm.slstm_step(_torch(p), SLSTM[1], _t(xs), st)
    _close(ot2, oj2, what="step out")
    _close(st2, _np(sj2), what="step state")


def test_slstm_step_loop_matches_apply():
    p = _torch(_np(jssm.init_slstm(jax.random.PRNGKey(5), SLSTM[0])))
    x = _t(_x(7, seed=12))
    out, state = tssm.slstm_apply(p, SLSTM[1], x)
    st = tssm.slstm_init_state(SLSTM[1], B, torch.float32, "cpu")
    outs = []
    for t in range(x.shape[1]):
        o, st = tssm.slstm_step(p, SLSTM[1], x[:, t:t + 1], st)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), out)
    for k in state:
        torch.testing.assert_close(st[k], state[k])


# ---------------------------------------------------------------------------
# Initial states and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_initial_states_match_the_reference(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    pairs = [
        (jssm.mamba_init_state(MAMBA[0], B, jdt), tssm.mamba_init_state(MAMBA[1], B, tdt, "cpu")),
        (jssm.mlstm_init_state(MLSTM[0], B), tssm.mlstm_init_state(MLSTM[1], B, "cpu")),
        (jssm.slstm_init_state(SLSTM[0], B, jdt), tssm.slstm_init_state(SLSTM[1], B, tdt, "cpu")),
    ]
    for want, got in pairs:
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k].astype(jnp.float32))
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
            np.testing.assert_array_equal(got[k].float().numpy(), w)


@pytest.mark.parametrize("which", ["mamba", "mlstm", "slstm"])
def test_init_matches_the_reference_shapes_and_constants(which):
    j_init = {"mamba": (jssm.init_mamba, MAMBA), "mlstm": (jssm.init_mlstm, MLSTM),
              "slstm": (jssm.init_slstm, SLSTM)}[which]
    t_init = getattr(tssm, f"init_{which}")
    want = _np(j_init[0](jax.random.PRNGKey(0), j_init[1][0]))
    got = t_init(torch.Generator().manual_seed(0), j_init[1][1], "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k in ("conv_b", "dt_bias", "a_log", "d_skip", "b"):
        if k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    bf = t_init(torch.Generator().manual_seed(0), j_init[1][1], "cpu", torch.bfloat16)
    for k in got:
        assert torch.equal(bf[k], got[k].to(torch.bfloat16)), k
