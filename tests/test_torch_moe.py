"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) in float32 on the CPU, on shared numpy inputs:
routing (gates, expert ids with their ties, the aux loss), the capacity,
the dispatch path with and without dropped tokens and over an expert slice,
the dense (decode) path, ``moe_apply`` and ``router_init_from_ckm``.

Bar: 1e-5 of the largest reference magnitude; expert ids equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

pytestmark = pytest.mark.torch_port

TOL = 1e-5
D, F_, E = 16, 24, 8


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol=TOL, what=""):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x {scale:.3e}"


def _params(seed=0, e=E):
    rng = np.random.default_rng(seed)
    return {
        "router": rng.standard_normal((D, e)).astype(np.float32) / 4,
        "w_gate": rng.standard_normal((e, D, F_)).astype(np.float32) / 4,
        "w_up": rng.standard_normal((e, D, F_)).astype(np.float32) / 4,
        "w_down": rng.standard_normal((e, F_, D)).astype(np.float32) / 5,
    }


def _x(t, seed=1):
    return np.random.default_rng(seed).standard_normal((t, D)).astype(np.float32)


def _torch(params):
    return {k: _t(v) for k, v in params.items()}


def _dims(top_k=2, capacity_factor=8.0, e=E):
    return (jmoe.MoEDims(D, F_, e, top_k, capacity_factor),
            tmoe.MoEDims(D, F_, e, top_k, capacity_factor))


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_route_matches_the_reference(top_k):
    params, x = _params(), _x(37)
    jd, td = _dims(top_k)
    gj, ij, aj = jmoe.route(params, jd, x)
    gt, it, at = tmoe.route(_torch(params), td, _t(x))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _close(gt, gj, what="gates")
    _close(at.reshape(1), np.asarray(aj).reshape(1), what="aux")


def test_route_breaks_ties_to_the_lower_index():
    """A zero router gives every expert the same probability: both
    packages pick the lowest ids, in order."""
    params = {**_params(), "router": np.zeros((D, E), np.float32)}
    jd, td = _dims(3)
    _, ij, _ = jmoe.route(params, jd, _x(5))
    _, it, _ = tmoe.route(_torch(params), td, _t(_x(5)))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(it.numpy(), np.tile([0, 1, 2], (5, 1)))


@pytest.mark.parametrize("t", [1, 5, 64, 1000])
@pytest.mark.parametrize("factor", [1.0, 1.25, 8.0])
def test_capacity_matches_the_reference(t, factor):
    jd, td = _dims(2, factor)
    assert tmoe._capacity(t, td) == jmoe._capacity(t, jd)


def _routed(top_k, factor, t=61, seed=0):
    params, x = _params(seed), _x(t, seed + 1)
    jd, td = _dims(top_k, factor)
    gates, ids, _ = jmoe.route(params, jd, x)
    return params, x, np.asarray(gates), np.asarray(ids), jd, td


@pytest.mark.parametrize("factor", [1.0, 8.0])
@pytest.mark.parametrize("e_start,e_local", [(0, E), (4, 4), (2, 3)])
def test_moe_local_matches_the_reference(factor, e_start, e_local):
    """The dispatch path over an expert slice.  At capacity_factor 1.0 the
    router overflows some experts: the same (token, expert) pairs are kept
    and dropped in both packages."""
    params, x, gates, ids, jd, td = _routed(2, factor)
    cap = jmoe._capacity(x.shape[0], jd)
    sl = slice(e_start, e_start + e_local)
    ws = [params[k][sl] for k in ("w_gate", "w_up", "w_down")]
    want = jmoe._moe_local(x, gates, ids, *ws, jnp.asarray(e_start), E, cap)
    got = tmoe._moe_local(_t(x), _t(gates), _t(ids).long(), *map(_t, ws), e_start, E, cap)
    _close(got, want, what="moe_local")
    counts = np.bincount(ids.reshape(-1), minlength=E)
    if factor == 1.0:
        assert counts.max() > cap, "no expert overflows: the drops are not exercised"
    else:
        assert counts.max() <= cap


def test_dropped_tokens_are_the_ones_past_capacity():
    """At capacity_factor 1.0, a token routed only to an overflowing expert,
    past its capacity in stable order, gets no output from that expert: the
    port's output equals the reference's, and some rows of it are zero."""
    params, x, gates, ids, jd, td = _routed(1, 1.0, t=200)
    cap = jmoe._capacity(x.shape[0], jd)
    ws = [params[k] for k in ("w_gate", "w_up", "w_down")]
    got = tmoe._moe_local(_t(x), _t(gates), _t(ids).long(), *map(_t, ws), 0, E, cap).numpy()
    want = np.asarray(jmoe._moe_local(x, gates, ids, *ws, jnp.asarray(0), E, cap))
    dropped = np.zeros(x.shape[0], bool)
    for e in range(E):
        members = np.nonzero(ids[:, 0] == e)[0]  # stable order = token order
        dropped[members[cap:]] = True
    assert dropped.any()
    np.testing.assert_array_equal(np.all(got == 0, axis=1), dropped)
    np.testing.assert_array_equal(np.all(want == 0, axis=1), dropped)
    _close(torch.from_numpy(got), want, what="moe_local top-1")


@pytest.mark.parametrize("e_start,e_local", [(0, E), (4, 4)])
def test_moe_dense_local_matches_the_reference(e_start, e_local):
    params, x, gates, ids, _, _ = _routed(2, 8.0, t=3)
    sl = slice(e_start, e_start + e_local)
    ws = [params[k][sl] for k in ("w_gate", "w_up", "w_down")]
    want = jmoe._moe_dense_local(x, gates, ids, *ws, jnp.asarray(e_start))
    got = tmoe._moe_dense_local(_t(x), _t(gates), _t(ids).long(), *map(_t, ws), e_start)
    _close(got, want, what="moe_dense_local")


@pytest.mark.parametrize("dense_path", [False, True])
@pytest.mark.parametrize("factor", [1.0, 8.0])
def test_moe_apply_matches_the_reference(dense_path, factor):
    params = _params(3)
    x = np.random.default_rng(4).standard_normal((2, 13, D)).astype(np.float32)
    jd, td = _dims(2, factor)
    oj, aj = jmoe.moe_apply(params, jd, x, dense_path=dense_path)
    ot, at = tmoe.moe_apply(_torch(params), td, _t(x), dense_path=dense_path)
    _close(ot, oj, what="moe_apply")
    _close(at.reshape(1), np.asarray(aj).reshape(1), what="aux")


def test_dense_path_equals_dispatch_when_nothing_drops():
    params = _torch(_params(5))
    x = _t(np.random.default_rng(6).standard_normal((3, 7, D)).astype(np.float32))
    _, td = _dims(2, 8.0)
    disp, a1 = tmoe.moe_apply(params, td, x)
    dense, a2 = tmoe.moe_apply(params, td, x, dense_path=True)
    torch.testing.assert_close(dense, disp, rtol=1e-5, atol=1e-6)
    assert float(a1) == float(a2)


def test_moe_apply_in_bf16_runs_and_stays_near_float32():
    params = _torch(_params(7))
    x = _t(np.random.default_rng(8).standard_normal((2, 9, D)).astype(np.float32))
    _, td = _dims(2, 8.0)
    ref, _ = tmoe.moe_apply(params, td, x)
    for dense_path in (False, True):
        out, _ = tmoe.moe_apply(params, td, x.to(torch.bfloat16), dense_path=dense_path)
        assert out.dtype == torch.bfloat16
        assert float(torch.amax(torch.abs(out.float() - ref))) <= 0.05 * float(
            torch.amax(torch.abs(ref)))


def test_router_init_from_ckm_matches_the_reference():
    c = np.random.default_rng(9).standard_normal((E, D)).astype(np.float32)
    c[2] = 0.0  # a zero centroid: the norm's floor
    _close(tmoe.router_init_from_ckm(_t(c), D), jmoe.router_init_from_ckm(c, D), what="router")


def test_init_moe_shapes_and_scale():
    _, td = _dims()
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(gen, td, "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (D, E), "w_gate": (E, D, F_), "w_up": (E, D, F_), "w_down": (E, F_, D)}
    # normal / sqrt(fan_in), fan_in the d (or f) axis of each expert.
    assert abs(float(p["w_gate"].std()) * D**0.5 - 1.0) < 0.1
    assert abs(float(p["w_down"].std()) * F_**0.5 - 1.0) < 0.1
    bf = tmoe.init_moe(torch.Generator().manual_seed(0), td, "cpu", torch.bfloat16)
    for k in p:
        assert torch.equal(bf[k], p[k].to(torch.bfloat16))


def test_moe_apply_refuses_a_mesh():
    _, td = _dims()
    with pytest.raises(NotImplementedError, match="item 22 \\(b\\), part 2"):
        tmoe.moe_apply(_torch(_params()), td, torch.zeros((1, 2, D)), mesh=object())
