"""The port's NNLS, Adam and decoder helpers against the reference (CLOMPR
end to end is in test_torch_ckm.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nnls as jnnls
from repro.core import freq_ops as jfo
from repro.core.decoders import common as jcommon
from repro_torch import convert
from repro_torch.core import nnls as tnnls
from repro_torch.core import decoders as tdec
from repro_torch.core.decoders import common as tcommon

pytestmark = pytest.mark.torch_port


def _nnls_problem(seed, d=40, s=6):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, s)).astype(np.float32)
    beta = np.abs(rng.standard_normal(s)).astype(np.float32)
    z = (a @ beta + 0.1 * rng.standard_normal(d)).astype(np.float32)
    return a, z


@pytest.mark.parametrize(
    "mask", [[1, 1, 1, 1, 1, 1], [1, 0, 1, 1, 0, 1], [0, 0, 0, 0, 0, 0]]
)
def test_nnls_matches_reference(mask):
    a, z = _nnls_problem(0)
    mask = np.asarray(mask, bool)
    a[:, ~mask] = np.nan  # padded columns may hold NaN: the select guards them
    ref = np.asarray(jnnls.nnls(jnp.asarray(a), jnp.asarray(z), jnp.asarray(mask), iters=150))
    got = tnnls.nnls(torch.from_numpy(a), torch.from_numpy(z), torch.from_numpy(mask), iters=150)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert np.isfinite(got.numpy()).all() and (got.numpy() >= 0).all()
    if not mask.any():
        assert not got.any()


def test_adam_matches_reference_on_a_quadratic():
    rng = np.random.default_rng(1)
    target = rng.uniform(-0.5, 1.5, (3, 4)).astype(np.float32)
    scale = rng.uniform(0.5, 3.0, 5).astype(np.float32)
    p0 = (rng.uniform(size=(3, 4)).astype(np.float32), np.zeros(5, np.float32))

    def j_loss(p):
        return jnp.sum((p[0] - target) ** 2) + jnp.sum(scale * (p[1] - 1.0) ** 2)

    def t_loss(p):
        return torch.sum((p[0] - torch.from_numpy(target)) ** 2) + torch.sum(
            torch.from_numpy(scale) * (p[1] - 1.0) ** 2
        )

    ref = jcommon.adam(
        j_loss, tuple(jnp.asarray(v) for v in p0), 80, 0.05,
        lambda p: (jnp.clip(p[0], 0.0, 1.0), jnp.maximum(p[1], 0.0)),
    )
    got = tcommon.adam(
        t_loss, tuple(torch.from_numpy(v) for v in p0), 80, 0.05,
        lambda p: (torch.clamp(p[0], 0.0, 1.0), torch.clamp(p[1], min=0.0)),
    )
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
        assert not g.requires_grad


@pytest.mark.parametrize("m", [7, 8])
def test_median_averages_the_two_middle_values_like_jnp(m):
    v = np.random.default_rng(m).standard_normal(m).astype(np.float32)
    assert float(tcommon.median(torch.from_numpy(v))) == float(jnp.median(jnp.asarray(v)))


def test_residual_cost_and_resolution_radius_match_reference():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 50)).astype(np.float32)
    cents = rng.standard_normal((4, 3)).astype(np.float32)
    alpha = rng.uniform(size=4).astype(np.float32)
    z = rng.standard_normal(100).astype(np.float32)
    jop, top = jfo.as_operator(jnp.asarray(w)), convert.operator_from_numpy(w, device="cpu")
    ref = jcommon.residual_cost(jnp.asarray(z), jnp.asarray(cents), jnp.asarray(alpha), jop)
    got = tcommon.residual_cost(
        torch.from_numpy(z), torch.from_numpy(cents), torch.from_numpy(alpha), top
    )
    assert float(got) == pytest.approx(float(ref), rel=1e-5)
    assert float(tcommon.resolution_radius(top, 2.5)) == pytest.approx(
        float(jcommon.resolution_radius(jop, 2.5)), rel=1e-6
    )
    with pytest.raises(TypeError, match="FrequencyOperator"):
        tcommon.resolution_radius(torch.from_numpy(w), 2.5)


def test_decoder_registry_contract():
    assert tdec.available_decoders() == ["amp", "clompr", "sketch_shift"]
    assert tdec.get_decoder("clompr") is tdec.DECODERS["clompr"]
    assert tdec.get_decoder("amp").__name__ == "decode_amp"
    assert tdec.get_decoder("sketch_shift").__name__ == "decode_sketch_shift"
    with pytest.raises(KeyError, match="available"):
        tdec.get_decoder("no_such_decoder")
    with pytest.raises(ValueError, match="already registered"):
        tdec.register_decoder("clompr")(lambda *a: None)


_TRACE_BUDGET = dict(atom_steps=15, joint_steps=10, nnls_iters=20, final_steps=20,
                     shift_steps=10, shift_polish_steps=10, amp_iters=12, amp_polish_steps=10)


@pytest.mark.parametrize("decoder", ["clompr", "sketch_shift", "amp"])
def test_trace_flag_series_match_reference_and_leave_the_decode_alone(decoder):
    """``trace=True`` adds the reference's series (same names, same
    lengths, finite) and leaves the decode's bits as they were."""
    import jax

    from repro.core import ckm as jckm
    from repro_torch.core import ckm as tckm

    rng = np.random.default_rng(4)
    x = (rng.uniform(-3, 3, (3, 2))[rng.integers(0, 3, 600)]
         + 0.3 * rng.standard_normal((600, 2))).astype(np.float32)
    w = (rng.standard_normal((2, 40)) * 0.8).astype(np.float32)
    jcfg = jckm.CKMConfig(k=3, m=40, decoder=decoder, trace_convergence=True, **_TRACE_BUDGET)
    jop = jfo.as_operator(jnp.asarray(w))
    jz = jnp.asarray(np.concatenate([np.cos(x @ w).mean(0), -np.sin(x @ w).mean(0)]))
    jlo, jhi = jnp.asarray(x.min(0)), jnp.asarray(x.max(0))
    from repro.core.decoders import get_decoder as jget_decoder

    ref = jget_decoder(decoder)(jax.random.PRNGKey(0), jz, jop, jlo, jhi, jcfg)[3]

    cfg = tckm.CKMConfig(k=3, m=40, decoder=decoder, **_TRACE_BUDGET)
    op = convert.operator_from_numpy(w, device="cpu")
    z, lo, hi = (torch.from_numpy(np.array(a)) for a in (jz, jlo, jhi))
    plain = tdec.get_decoder(decoder)(torch.Generator().manual_seed(0), z, op, lo, hi, cfg)
    traced_cfg = tckm.CKMConfig(k=3, m=40, decoder=decoder, trace_convergence=True,
                                **_TRACE_BUDGET)
    traced = tdec.get_decoder(decoder)(torch.Generator().manual_seed(0), z, op, lo, hi,
                                       traced_cfg)
    assert len(plain) == 3 and len(traced) == 4
    assert all(torch.equal(a, b) for a, b in zip(plain, traced[:3]))
    assert sorted(traced[3]) == sorted(ref)
    for name, series in traced[3].items():
        assert series.shape == ref[name].shape and series.dtype == torch.float32, name
        assert bool(torch.isfinite(series).all()) and bool((series > 0).all()), name
