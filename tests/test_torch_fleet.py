"""The port's fleet engine: the stacked monoid law bitwise against each
tenant's isolated ``SketchEngine`` (float, 1-bit, decayed; dense and
structured; a fleet whose tenant count equals m), request routing through
unique and duplicate ids, tenant surgery, the fleet kernels' plain versions,
operator specs, and parity with the reference ``FleetEngine`` on shared numpy
operators, dithers and batches: z to 1e-4, int32 code sums exact under the
boundary rule of ``_torch_codes``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_codes import assert_sums_within_flips
from repro import core as jcore
from repro.core import fleet as jfl
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch.core import fleet as fl
from repro_torch.core import freq_ops as fo
from repro_torch.core.engine import (
    DecayedQuantizedSketchEngineState,
    DecayedSketchEngineState,
    QuantizedSketchEngineState,
    SketchEngineState,
)
from repro_torch.kernels import fourier_sketch as fs
from repro_torch.parallel import tenant_mesh

pytestmark = pytest.mark.torch_port

T, B, N, M = 4, 12, 3, 32
Z_TOL = 1e-4  # on z, the engine backends' bar
QUANTS = ["none", "1bit"]


def _engine(quant="none", name="dense", n_tenants=T, decay=None, m=M):
    specs = fl.fleet_specs(0, n_tenants, name, m, N, 1.5)
    quants = fl.fleet_quantizers(7, n_tenants, m, quant, device="cpu")
    return fl.FleetEngine(specs, quantizers=quants, decay=decay, device="cpu")


def _batches(seed, rounds=1, n_tenants=T, batch=B, n=N):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((rounds, n_tenants, batch, n)).astype(np.float32))


def _rows_equal(row, ref):
    return type(row) is type(ref) and all(torch.equal(a, b) for a, b in zip(row, ref))


def _finals_equal(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b))


# -- the stacked monoid law ----------------------------------------------------


@pytest.mark.parametrize("name", ["dense", "structured"])
@pytest.mark.parametrize("quant", QUANTS)
def test_stacked_monoid_law_bitwise(quant, name):
    """Stacked update/merge/finalize/finalize_tenant == each tenant's
    isolated engine, bitwise."""
    eng = _engine(quant, name)
    xs = _batches(1, rounds=2)
    sa = eng.update(eng.init_state(), xs[0])
    sb = eng.update(eng.init_state(), xs[1])
    merged = eng.merge(sa, sb)
    z, lo, hi = eng.finalize(merged)
    for t in range(T):
        ref = eng.tenant_engine(t)
        ra = ref.update(ref.init_state(), xs[0, t])
        rm = ref.merge(ra, ref.update(ref.init_state(), xs[1, t]))
        assert _rows_equal(eng.tenant_state(sa, t), ra)
        assert _rows_equal(eng.tenant_state(merged, t), rm)
        rz = ref.finalize(rm)
        assert _finals_equal((z[t], lo[t], hi[t]), rz)
        assert _finals_equal(eng.finalize_tenant(merged, t), rz)


# Ticks at which float32 0.5 ** dt differs in its last bit between the
# CPU's vector and scalar pow (dt from a stamp of 0).
_POW_SPLIT_TICKS = (0.26, 0.61, 1.22, 1.26, 1.61, 2.22, 2.26, 3.22)


@pytest.mark.parametrize("quant", QUANTS)
def test_tenant_count_equal_to_m_decayed(quant):
    """T == m: a (T,) per-tenant factor broadcast on the trailing axis of
    (T, m) leaves would pass silently, so the tenants' ticks differ; every
    row must still be its isolated decayed engine's, through updates at
    several ticks and decay_to.  At T = 32 the CPU's pow takes its vector
    path for the stack and its scalar path per tenant, and the ticks are
    ones where float32 pow's two paths round apart."""
    eng = _engine(quant, n_tenants=M, decay=0.5)
    xs = _batches(2, rounds=3, n_tenants=M, batch=5)
    state = eng.init_state()
    refs = [eng.tenant_engine(t) for t in range(M)]
    rstates = [r.init_state() for r in refs]
    split = torch.tensor([_POW_SPLIT_TICKS[t % len(_POW_SPLIT_TICKS)] for t in range(M)])
    for k, ticks in enumerate((torch.zeros(M), split, torch.full((M,), 3.5))):
        state = eng.update(state, xs[k], t=ticks)
        rstates = [r.update(s, xs[k, t], t=float(ticks[t]))
                   for t, (r, s) in enumerate(zip(refs, rstates))]
    state = eng.decay_to(state, 6.0)
    rstates = [r.decay_to(s, 6.0) for r, s in zip(refs, rstates)]
    z = eng.finalize(state)[0]
    for t in range(M):
        assert _rows_equal(eng.tenant_state(state, t), rstates[t])
        assert torch.equal(z[t], refs[t].finalize(rstates[t])[0])


@pytest.mark.parametrize("m", [40, 45])
def test_quantized_finalize_at_a_ragged_m(m):
    """At an m that is not a whole number of the CPU's vector widths, cos
    and sin of the (T, m) dither stack take the vector path where a tenant's
    (m,) row takes the scalar one for its tail; z is still bitwise each
    isolated engine's."""
    eng = _engine("2bit", n_tenants=6, m=m)
    xs = _batches(16, n_tenants=6)[0]
    state = eng.update(eng.init_state(), xs)
    z = eng.finalize(state)[0]
    for t in range(6):
        ref = eng.tenant_engine(t)
        assert torch.equal(z[t], ref.finalize(ref.update(ref.init_state(), xs[t]))[0])


def test_weighted_update_bitwise():
    eng = _engine()
    xs = _batches(3)[0]
    weights = torch.from_numpy(np.random.default_rng(3).uniform(0.1, 2.0, (T, B)).astype(np.float32))
    state = eng.update(eng.init_state(), xs, weights)
    for t in range(T):
        ref = eng.tenant_engine(t)
        assert _rows_equal(eng.tenant_state(state, t), ref.update(ref.init_state(), xs[t],
                                                                  weights[t]))


@pytest.mark.parametrize("quant", QUANTS)
def test_decayed_fleet_per_tenant_ticks(quant):
    """Per-tenant ticks ``t (T,)``, ``t=None`` (each row's own stamp) and
    decay_to with ``(T,)`` ticks, row for row the isolated engines."""
    eng = _engine(quant, decay=0.9)
    xs = _batches(4, rounds=3)
    ticks = torch.tensor([0.0, 1.0, 3.0, 7.0])
    state = eng.update(eng.init_state(), xs[0], t=ticks)
    state = eng.update(state, xs[1])
    state = eng.update(state, xs[2], t=8.0)
    state = eng.decay_to(state, ticks + 10.0)
    assert isinstance(state, DecayedQuantizedSketchEngineState if quant == "1bit"
                      else DecayedSketchEngineState)
    for t in range(T):
        ref = eng.tenant_engine(t)
        r = ref.update(ref.init_state(), xs[0, t], t=float(ticks[t]))
        r = ref.update(r, xs[1, t])
        r = ref.update(r, xs[2, t], t=8.0)
        r = ref.decay_to(r, float(ticks[t]) + 10.0)
        assert _rows_equal(eng.tenant_state(state, t), r)
        assert _finals_equal(eng.finalize_tenant(state, t), ref.finalize(r))


# -- request routing -------------------------------------------------------------


@pytest.mark.parametrize("quant", QUANTS)
def test_ingest_unique_ids_scatter(quant):
    eng = _engine(quant)
    xs = _batches(5)[0]
    ids = np.array([2, 0, 3, 1])  # permuted on purpose
    state = eng.ingest(eng.init_state(), ids, xs)
    for r, t in enumerate(ids):
        ref = eng.tenant_engine(int(t))
        assert _rows_equal(eng.tenant_state(state, int(t)), ref.update(ref.init_state(), xs[r]))


@pytest.mark.parametrize("decay", [None, 0.5])
@pytest.mark.parametrize("quant", QUANTS)
def test_ingest_duplicate_ids_arrival_order(quant, decay):
    """Duplicate ids fold in arrival order — bitwise the association of
    the tenant's isolated engine; under decay, ``t=None`` stamps each request
    with its row's clock as it merges."""
    eng = _engine(quant, decay=decay)
    xs = _batches(6, n_tenants=6)[0]
    ids = np.array([1, 0, 1, 2, 1, 0])
    kw = {} if decay is None else {"t": 2.0}
    state = eng.update(eng.init_state(), _batches(7)[0], **kw)
    state = eng.ingest(state, ids, xs)
    refs = {}
    for t in range(T):
        ref = eng.tenant_engine(t)
        refs[t] = ref.update(ref.init_state(), _batches(7)[0][t], **kw)
    for r, t in enumerate(ids):
        refs[int(t)] = eng.tenant_engine(int(t)).update(refs[int(t)], xs[r])
    for t, ref in refs.items():
        assert _rows_equal(eng.tenant_state(state, t), ref)


def test_ingest_decayed_per_request_ticks():
    eng = _engine(decay=0.7)
    xs = _batches(8, n_tenants=5)[0]
    ids, ticks = np.array([3, 0, 3, 3, 1]), np.array([1.0, 2.0, 2.0, 5.0, 4.0], np.float32)
    state = eng.ingest(eng.init_state(), ids, xs, t=torch.from_numpy(ticks))
    refs = {}
    for r, t in enumerate(ids.tolist()):
        ref = eng.tenant_engine(t)
        refs[t] = ref.update(refs.get(t, ref.init_state()), xs[r], t=float(ticks[r]))
    for t in range(T):
        want = refs.get(t, eng.tenant_engine(t).init_state())
        assert _rows_equal(eng.tenant_state(state, t), want)


def test_ingest_validation():
    eng = _engine()
    xs = _batches(9)[0]
    with pytest.raises(ValueError, match="tenant ids"):
        eng.ingest(eng.init_state(), [0, 1, 2, 9], xs)
    with pytest.raises(ValueError, match=r"\(R,\)"):
        eng.ingest(eng.init_state(), [0, 1], xs)
    with pytest.raises(ValueError, match="decay-enabled"):
        eng.ingest(eng.init_state(), [0, 1, 2, 3], xs, t=1.0)


# -- refusals, surgery, sizes --------------------------------------------------


def test_quantized_fleet_rejects_weights():
    eng = _engine("1bit")
    with pytest.raises(ValueError, match="unit-weight"):
        eng.update(eng.init_state(), _batches(10)[0], weights=torch.ones((T, B)))


def test_stack_operators_rejects_mismatched_tenants():
    a = fl.fleet_specs(0, 1, "dense", M, N, 1.0)
    b = fl.fleet_specs(1, 1, "dense", M // 2, N, 1.0)
    with pytest.raises(ValueError, match="tenant 1"):
        fl.FleetEngine(a + b, device="cpu")
    c = fl.fleet_specs(2, 1, "structured", M, N, 1.0)
    with pytest.raises(ValueError, match="tenant 1"):
        fl.FleetEngine(a + c, device="cpu")


def test_constructor_refusals():
    specs = fl.fleet_specs(0, T, "dense", M, N, 1.0)
    # sharding="mesh" builds (tests/test_torch_fleet_shard.py holds it).
    mesh = fl.FleetEngine(specs, sharding="mesh", mesh=tenant_mesh(2, devices=["cpu"] * 2))
    assert (mesh.sharding, mesh.tenant_shards, mesh.shard_rows) == ("mesh", 2, T // 2)
    with pytest.raises(ValueError, match="sharding"):
        fl.FleetEngine(specs, sharding="ring", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        fl.FleetEngine(specs, backend="xla", device="cpu")
    with pytest.raises(ValueError, match="decay"):
        fl.FleetEngine(specs, decay=1.5, device="cpu")
    quants = fl.fleet_quantizers(0, T, M, "1bit", device="cpu")
    quants[1] = fl.fleet_quantizers(0, 1, M, "2bit", device="cpu")[0]
    with pytest.raises(ValueError, match="bit width"):
        fl.FleetEngine(specs, quantizers=quants, device="cpu")
    eng = fl.FleetEngine(specs, device="cpu")
    with pytest.raises(ValueError, match="decay-enabled"):
        eng.update(eng.init_state(), _batches(11)[0], t=1.0)
    with pytest.raises(ValueError, match="decay-enabled"):
        eng.decay_to(eng.init_state(), 1.0)


@pytest.mark.parametrize("quant", QUANTS)
def test_tenant_surgery_and_state_bytes(quant):
    eng = _engine(quant)
    xs = _batches(12, rounds=2)
    state = eng.update(eng.init_state(), xs[0])
    row = eng.tenant_state(state, 2)
    cleared = eng.reset_tenant(state, 2)
    assert _rows_equal(eng.tenant_state(cleared, 2), eng.tenant_engine(2).init_state())
    for t in (0, 1, 3):
        assert _rows_equal(eng.tenant_state(cleared, t), eng.tenant_state(state, t))
    restored = eng.set_tenant(cleared, 2, row)
    assert _rows_equal(restored, state)
    ref = eng.tenant_engine(1)
    partial = ref.update(ref.init_state(), xs[1, 1])
    grown = eng.merge_tenant(state, 1, partial)
    assert _rows_equal(eng.tenant_state(grown, 1), ref.merge(eng.tenant_state(state, 1), partial))
    assert _rows_equal(eng.tenant_state(state, 1), ref.update(ref.init_state(), xs[0, 1]))
    per_tenant = sum(v.numel() * v.element_size() for v in ref.init_state())
    assert eng.state_bytes() == T * per_tenant
    cls = QuantizedSketchEngineState if quant == "1bit" else SketchEngineState
    assert isinstance(state, cls)
    assert eng.owner_shard(3) == 0 and eng.shard_rows == T and eng.place_state(state) is state
    with pytest.raises(ValueError, match="out of range"):
        eng.owner_shard(T)
    assert f"T={T}" in repr(eng)


# -- the fleet kernels' plain versions, and the CUDA entries' refusals -----------


def test_fleet_kernel_plain_versions_loop_the_single_ones():
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((T, B, N)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((T, N, M)).astype(np.float32))
    beta = torch.from_numpy(rng.uniform(0, 1, (T, B)).astype(np.float32))
    dither = torch.from_numpy(rng.uniform(0, 6.28, (T, M)).astype(np.float32))
    c, s = fs.fourier_sketch_sums_fleet_plain(x, w, beta)
    qc, qs = fs.quantized_fourier_sketch_sums_fleet_plain(x, w, dither, 1)
    for t in range(T):
        assert _finals_equal((c[t], s[t]), fs.fourier_sketch_sums_plain(x[t], w[t], beta[t]))
        assert _finals_equal((qc[t], qs[t]),
                             fs.quantized_fourier_sketch_sums_plain(x[t], w[t], dither[t], 1))
    assert c.shape == (T, M) and qc.dtype == torch.int32
    with pytest.raises(ValueError, match="CUDA tensor"):
        fs.fourier_sketch_sums_fleet(x, w, beta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fs.quantized_fourier_sketch_sums_fleet(x, w, dither, 1)
    with pytest.raises(ValueError, match=r"\(T, B, n\)"):
        fs.fourier_sketch_sums_fleet_plain(x, w[:, :2], beta)


# -- operator specs ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["dense", "structured"])
def test_spec_rebuilds_the_same_leaves(name):
    op = fo.seeded_operator(name, 1234, 40, 5, 0.7, device="cpu")
    spec = op.spec()
    assert spec == fo.FreqOpSpec(name, 1234, 40, 5, 0.7)
    again = fo.from_spec(spec, device="cpu")
    leaves = (lambda o: (o.w,)) if name == "dense" else (lambda o: (o.diags, o.radii, o.rho))
    assert all(torch.equal(a, b) for a, b in zip(leaves(op), leaves(again)))
    assert again.spec() == spec
    assert fo.spec_wire_bytes(spec) == len(name) + len("adapted_radius") + len("float32") + 40
    eng = fl.FleetEngine([spec, fo.from_spec(spec, device="cpu")], device="cpu")
    assert eng.specs == (spec, spec) and eng.operator(1).spec() == spec


def test_operators_without_a_spec_raise():
    for op in (fo.as_operator(torch.zeros((3, 8))),
               fo.make_operator("dense", torch.Generator().manual_seed(0), 8, 3, 1.0,
                                device="cpu")):
        with pytest.raises(ValueError, match="no spec"):
            op.spec()
    eng = fl.FleetEngine([fo.as_operator(torch.zeros((3, 8)))] * 2, device="cpu")
    assert eng.specs == (None, None)


def test_core_exports_the_reference_fleet_names():
    """``repro_torch.core`` exports the reference's ``__all__``, the
    topology names included."""
    assert set(tcore.__all__) == set(jcore.__all__)
    for name in ("FLEET_BACKENDS", "FleetEngine", "fleet_specs", "fleet_quantizers",
                 "FreqOpSpec"):
        assert hasattr(tcore, name)


# -- parity with the reference ---------------------------------------------------


# The structured parity case at n = 10 of a d = 32 block: at n = 3 a few
# rows' restricted norms are tiny, their radii and phases huge, and the two
# frameworks' float32 phases round apart there by more than the bar.
WIDTH = {"dense": N, "structured": 10}


def _reference_fleet(backend, quant, name):
    specs = jfl.fleet_specs(jax.random.PRNGKey(0), T, name, M, WIDTH[name], 1.5)
    quants = jfl.fleet_quantizers(jax.random.PRNGKey(7), T, M, quant)
    kw = dict(block_n=32, block_m=32, interpret=True) if backend == "pallas" else {}
    return jfl.FleetEngine(specs, backend=backend, quantizers=quants, **kw)


def _port_of(jeng, name):
    if name == "dense":
        leaves = (np.stack([np.asarray(jeng.operator(t).w) for t in range(T)]),)
    else:
        leaves = tuple(np.stack([np.asarray(getattr(jeng.operator(t), f)) for t in range(T)])
                       for f in ("diags", "radii", "rho"))
    stacked = convert.stacked_operator_from_numpy(name, leaves, WIDTH[name], M, device="cpu")
    quants = None
    if jeng.quantized:
        quants = [convert.quantizer_from_numpy(jeng.bits, d, device="cpu")
                  for d in np.asarray(jeng.dither)]
    return fl.FleetEngine(stacked, quantizers=quants, device="cpu")


@pytest.mark.parametrize("backend,name", [("xla", "dense"), ("pallas", "dense"),
                                          ("xla", "structured"), ("pallas", "structured")])
@pytest.mark.parametrize("quant", QUANTS)
def test_parity_with_the_reference_fleet(backend, name, quant):
    jeng = _reference_fleet(backend, quant, name)
    teng = _port_of(jeng, name)
    xs = _batches(14, rounds=2, n=WIDTH[name]).numpy()
    js = jeng.merge(jeng.update(jeng.init_state(), jnp.asarray(xs[0])),
                    jeng.update(jeng.init_state(), jnp.asarray(xs[1])))
    ts = teng.merge(teng.update(teng.init_state(), torch.from_numpy(xs[0])),
                    teng.update(teng.init_state(), torch.from_numpy(xs[1])))
    for f in ("weight_sum", "lower", "upper", "count"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    if quant == "1bit":
        for t in range(T):
            op = jeng.operator(t)
            theta = np.concatenate([np.asarray(op.apply(jnp.asarray(xs[k, t]))) for k in (0, 1)])
            theta = theta + np.asarray(jeng.dither[t])
            assert_sums_within_flips((ts.qcos_acc[t], ts.qsin_acc[t]),
                                     (js.qcos_acc[t], js.qsin_acc[t]), theta, 1)
    jz, tz = np.asarray(jeng.finalize(js)[0]), teng.finalize(ts)[0].numpy()
    np.testing.assert_allclose(tz, jz, atol=Z_TOL, rtol=0)
    # The reference's state carried across finalizes as the reference's does.
    carried = convert.fleet_state_from_numpy(js, device="cpu")
    np.testing.assert_allclose(teng.finalize(carried)[0].numpy(), jz, atol=Z_TOL, rtol=0)


@pytest.mark.parametrize("quant", QUANTS)
def test_ingest_and_decay_parity_with_the_reference(quant):
    specs = jfl.fleet_specs(jax.random.PRNGKey(0), T, "dense", M, N, 1.5)
    quants = jfl.fleet_quantizers(jax.random.PRNGKey(7), T, M, quant)
    jeng = jfl.FleetEngine(specs, quantizers=quants, decay=0.5)
    base = _port_of(jfl.FleetEngine(specs, quantizers=quants), "dense")
    teng = fl.FleetEngine(base._stacked_op, quantizers=[base.quantizer(t) for t in range(T)]
                          if base.quantized else None, decay=0.5, device="cpu")
    xs = _batches(15, n_tenants=5).numpy()[0]
    ids = np.array([1, 0, 1, 3, 1])
    # A second ingest with no tick: each request's sentinel stamp resolves
    # to its row's current one (3), so every folded row is of tick 3.
    xs2 = _batches(16).numpy()[0]
    ids2 = np.array([3, 1, 0, 3])
    js0 = jeng.ingest(jeng.init_state(), ids, jnp.asarray(xs), t=3.0)
    js1 = jeng.ingest(js0, ids2, jnp.asarray(xs2))
    js = jeng.decay_to(js1, 5.0)
    ts0 = teng.ingest(teng.init_state(), ids, torch.from_numpy(xs), t=3.0)
    ts1 = teng.ingest(ts0, ids2, torch.from_numpy(xs2))
    ts = teng.decay_to(ts1, 5.0)
    for got, want, n_req in ((ts0, js0, 0), (ts1, js1, len(ids2)), (ts, js, len(ids2))):
        carried = convert.fleet_state_from_numpy(want, device="cpu")
        assert type(carried) is type(got)
        for f in ("lower", "upper", "count", "stamp", "gamma"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(carried, f).numpy())
        np.testing.assert_allclose(got.weight_sum.numpy(), carried.weight_sum.numpy(),
                                   rtol=1e-6)
        if quant == "1bit":
            # The newest segment's int32 sums, and the side channel's code
            # mass over its decay factor: both within the boundary flips of
            # each tenant's rows.
            stamp = got.stamp.numpy()
            factor = np.where(np.isfinite(stamp), 0.5 ** (stamp - 3.0), 1.0)
            for t in range(T):
                rows = np.concatenate([xs[ids == t], xs2[:n_req][ids2[:n_req] == t]])
                theta = np.asarray(jeng.operator(t).apply(jnp.asarray(rows))).reshape(-1, M)
                theta = theta + np.asarray(jeng.dither[t])
                assert_sums_within_flips((got.qcos_acc[t], got.qsin_acc[t]),
                                         (carried.qcos_acc[t], carried.qsin_acc[t]), theta, 1)
                side = [np.rint(np.asarray(s[t], np.float64) / factor[t]) for s in
                        (got.dcos_acc, got.dsin_acc, carried.dcos_acc, carried.dsin_acc)]
                for s, u in zip(side, (got.dcos_acc, got.dsin_acc, carried.dcos_acc,
                                       carried.dsin_acc)):
                    np.testing.assert_array_equal(s * factor[t], u[t].numpy())
                assert_sums_within_flips(side[:2], side[2:], theta, 1)
        np.testing.assert_allclose(teng.finalize(got)[0].numpy(),
                                   np.asarray(jeng.finalize(want)[0]), atol=Z_TOL, rtol=0)


def test_fleet_state_from_numpy_validates():
    with pytest.raises(ValueError, match="fields"):
        convert.fleet_state_from_numpy(fo.FreqOpSpec("dense", 0, 1, 1, 1.0), device="cpu")
    bad = SketchEngineState(*(np.zeros(s, np.float32) for s in ((2, 4), (2, 4), (3,), (2, 1),
                                                                 (2, 1), (2,))))
    with pytest.raises(ValueError, match="leading tenant axis"):
        convert.fleet_state_from_numpy(bad, device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        convert.stacked_operator_from_numpy("dense", (np.zeros((2, 3, 4)),) * 2, 3, 4,
                                            device="cpu")
