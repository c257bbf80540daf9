"""The port's tenant mesh: ``FleetEngine(sharding="mesh")`` under one
controller, p in {1, 2, 4} blocks on ``[cpu] * p``.

1. Mesh parity: float, 1-bit and decayed fleets; update, merge, finalize,
   decay_to, ingest and tenant surgery; every row bitwise the port's
   ``sharding="none"`` fleet and the tenant's isolated ``SketchEngine``, and
   within the fleet tests' bars of the reference ``FleetEngine`` (unsharded
   and at ``sharding="mesh", tenant_shards=1``) on shared numpy operators.
2. Config errors with the reference's messages.
3. The shard-routed ``FleetService`` under random submit / flush / evict /
   restore interleavings: bitwise isolated engines; every dispatch inside
   one block; the per-shard request counter.
4. ``tenant_mesh`` validation (no fallback to the CPU without cards),
   ``fleet_wire_cost_model`` beside the mesh, a window over a mesh fleet.
5. Zero collectives: ``torch.distributed``'s collectives and ``gather_rows``
   raise during the hot path, and every block's tensors stay on its device.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.obs as tobs
from _torch_codes import assert_sums_within_flips
from repro.core import fleet as jfl
from repro.core import topology as jtopo
from repro.parallel import sharding as jsharding
from repro_torch import convert
from repro_torch.core import SketchWindow, ckm
from repro_torch.core import fleet as fl
from repro_torch.core import topology as topo
from repro_torch.core.engine import SketchEngine
from repro_torch.parallel import TenantMesh, axis_extent, tenant_mesh
from repro_torch.serve import FleetService

pytestmark = pytest.mark.torch_port

T, B, N, M = 8, 12, 3, 32
Z_TOL = 1e-4  # on z, the engine backends' bar
CPU = torch.device("cpu")
PS = [1, 2, 4]
QUANTS = ["none", "1bit"]


@pytest.fixture(autouse=True)
def _clean_obs():
    tobs.disable()
    tobs.reset()
    yield
    tobs.disable()
    tobs.reset()


def _mesh(p, axis="tenant"):
    return tenant_mesh(p, axis, devices=[CPU] * p)


def _engine(quant="none", p=None, decay=None, name="dense", n_tenants=T):
    specs = fl.fleet_specs(0, n_tenants, name, M, N, 1.5)
    quants = fl.fleet_quantizers(7, n_tenants, M, quant, device="cpu")
    if p is None:
        return fl.FleetEngine(specs, quantizers=quants, decay=decay, device="cpu")
    return fl.FleetEngine(specs, quantizers=quants, decay=decay, sharding="mesh", mesh=_mesh(p))


def _batches(seed, rounds=1, n_tenants=T, batch=B):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((rounds, n_tenants, batch, N)).astype(np.float32))


def _rows_equal(row, ref):
    return type(row) is type(ref) and all(torch.equal(a, b) for a, b in zip(row, ref))


def _same_stacked(mesh_state, ref_state):
    return _rows_equal(fl.gather_rows(mesh_state, CPU), ref_state)


def _cheap_decode_cfg():
    return ckm.CKMConfig(k=2, decoder="sketch_shift", shift_candidates=2, shift_steps=3,
                         shift_polish_steps=2, nnls_iters=4)


# -- 1. mesh parity ----------------------------------------------------------------


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("p", PS)
def test_update_merge_finalize_parity(p, quant):
    """mesh(p) fleet == unsharded fleet == isolated engines, bitwise."""
    ref, eng = _engine(quant), _engine(quant, p)
    assert (eng.tenant_shards, eng.shard_rows, eng.sharding) == (p, T // p, "mesh")
    xs = _batches(1, rounds=2)
    s_ref = ref.merge(ref.update(ref.init_state(), xs[0]), ref.update(ref.init_state(), xs[1]))
    s = eng.merge(eng.update(eng.init_state(), xs[0]), eng.update(eng.init_state(), xs[1]))
    assert isinstance(s, fl.FleetShards) and len(s.blocks) == p
    assert _same_stacked(s, s_ref)
    for t in range(T):
        e = eng.tenant_engine(t)
        iso = e.merge(e.update(e.init_state(), xs[0, t]), e.update(e.init_state(), xs[1, t]))
        assert _rows_equal(eng.tenant_state(s, t), iso), t
        assert all(torch.equal(a, b) for a, b in zip(eng.finalize_tenant(s, t),
                                                     ref.finalize_tenant(s_ref, t)))
    fin = eng.finalize(s)
    assert all(isinstance(v, fl.FleetShards) for v in fin)
    assert all(torch.equal(a, b) for a, b in zip(fl.gather_rows(fin, CPU), ref.finalize(s_ref)))


@pytest.mark.parametrize("quant", QUANTS)
def test_structured_mesh_parity(quant):
    """A structured fleet's blocks launch the tenant-axis entry of kernel 4
    or 5 once a block: the same bits as the unsharded fleet."""
    ref, eng = _engine(quant, name="structured"), _engine(quant, 2, name="structured")
    xs = _batches(2, rounds=2)
    s_ref = ref.update(ref.update(ref.init_state(), xs[0]), xs[1])
    s = eng.update(eng.update(eng.init_state(), xs[0]), xs[1])
    assert _same_stacked(s, s_ref)
    assert torch.equal(fl.gather_rows(eng.finalize(s)[0], CPU), ref.finalize(s_ref)[0])


@pytest.mark.parametrize("p", PS)
def test_decayed_mesh_parity(p):
    """Scalar, per-tenant and reused ticks, then decay_to (scalar and
    per-tenant): bitwise the unsharded decayed fleet and isolated engines."""
    ref, eng = _engine(decay=0.9), _engine(p=p, decay=0.9)
    xs = _batches(3, rounds=3)
    ticks = [0.0, torch.linspace(1.0, 2.5, T), None]
    s_ref, s = ref.init_state(), eng.init_state()
    for r, tick in enumerate(ticks):
        s_ref = ref.update(s_ref, xs[r], t=tick)
        s = eng.update(s, xs[r], t=tick)
    assert _same_stacked(s, s_ref)
    for target in (4.0, np.linspace(4.0, 6.0, T).astype(np.float32)):
        assert _same_stacked(eng.decay_to(s, target), ref.decay_to(s_ref, target))
    for t in range(T):
        e = eng.tenant_engine(t)
        iso = e.init_state()
        for r, tick in enumerate(ticks):
            tt = None if tick is None else float(tick if r == 0 else tick[t])
            iso = e.update(iso, xs[r, t], t=tt)
        assert _rows_equal(eng.tenant_state(s, t), iso), t
    assert torch.equal(fl.gather_rows(eng.finalize(s)[0], CPU), ref.finalize(s_ref)[0])


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("p", PS)
def test_ingest_parity(p, quant):
    """Unique, duplicate and one-block requests, as tensors, numpy and a list;
    float weights: bitwise the unsharded fleet's ingest."""
    eng, ref = _engine(quant, p), _engine(quant)
    rng = np.random.default_rng(4)
    s, s_ref = eng.init_state(), ref.init_state()
    scripts = [rng.permutation(T), rng.integers(0, T, 23), np.array([T - 1, T - 2, T - 1])]
    for k, ids in enumerate(scripts):
        xs = rng.standard_normal((len(ids), B, N)).astype(np.float32)
        batches = [torch.from_numpy(xs), xs, list(xs)][k]
        s = eng.ingest(s, ids, batches)
        s_ref = ref.ingest(s_ref, ids, torch.from_numpy(xs))
        assert _same_stacked(s, s_ref), k
    if quant == "none":
        ids = rng.integers(0, T, 11)
        xs = torch.from_numpy(rng.standard_normal((11, B, N)).astype(np.float32))
        w = torch.from_numpy(rng.uniform(0.5, 2.0, (11, B)).astype(np.float32))
        assert _same_stacked(eng.ingest(s, ids, xs, w), ref.ingest(s_ref, ids, xs, w))


@pytest.mark.parametrize("p", [2, 4])
def test_decayed_ingest_parity(p):
    """Per-request ticks, a scalar tick and the row's own clock."""
    eng, ref = _engine(p=p, decay=0.5), _engine(decay=0.5)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, T, 13)
    xs = torch.from_numpy(rng.standard_normal((13, B, N)).astype(np.float32))
    ticks = torch.from_numpy(rng.uniform(0.0, 3.0, 13).astype(np.float32))
    s, s_ref = eng.ingest(eng.init_state(), ids, xs, t=ticks), ref.ingest(ref.init_state(), ids,
                                                                         xs, t=ticks)
    assert _same_stacked(s, s_ref)
    s, s_ref = eng.ingest(s, ids[:5], xs[:5], t=4.0), ref.ingest(s_ref, ids[:5], xs[:5], t=4.0)
    assert _same_stacked(s, s_ref)
    s, s_ref = eng.ingest(s, ids[5:], xs[5:]), ref.ingest(s_ref, ids[5:], xs[5:])
    assert _same_stacked(s, s_ref)


@pytest.mark.parametrize("p", [2, 4])
def test_tenant_surgery_goes_to_the_owner(p):
    eng, ref = _engine("1bit", p), _engine("1bit")
    xs = _batches(6)[0]
    s, s_ref = eng.update(eng.init_state(), xs), ref.update(ref.init_state(), xs)
    t = T - 1
    owner = eng.owner_shard(t)
    assert owner == p - 1 and eng.device_of(t) == CPU
    row = eng.tenant_state(s, t)
    cut = eng.reset_tenant(s, t)
    assert float(eng.tenant_state(cut, t).count) == 0.0
    # Only the owner's block changed; the others are shared, not copied.
    assert all(cut.blocks[b] is s.blocks[b] for b in range(p) if b != owner)
    back = eng.set_tenant(cut, t, row)
    assert _same_stacked(back, s_ref)
    e = eng.tenant_engine(t)
    part = e.update(e.init_state(), _batches(7)[0, 0])
    assert _same_stacked(eng.merge_tenant(s, t, part), ref.merge_tenant(s_ref, t, part))
    for u in range(T):
        assert torch.equal(eng.operator(u).w, ref.operator(u).w)
        assert eng.operator(u).spec() == ref.operator(u).spec() == ref.specs[u]
        assert torch.equal(eng.quantizer(u).dither, ref.quantizer(u).dither)
    assert eng.specs == ref.specs


@pytest.mark.parametrize("p", PS)
def test_place_state_and_gather_rows(p):
    eng, ref = _engine(p=p), _engine()
    s_ref = ref.update(ref.init_state(), _batches(8)[0])
    placed = eng.place_state(s_ref)
    assert _same_stacked(placed, s_ref)
    assert all(b.count.shape == (T // p,) for b in placed.blocks)
    assert _same_stacked(eng.place_state(placed), s_ref)
    assert ref.place_state(s_ref) is s_ref
    assert fl.gather_rows(s_ref, CPU).count.device == CPU
    assert eng.state_bytes() == ref.state_bytes()
    with pytest.raises(ValueError, match="rows"):
        eng.place_state(ref.tenant_state(s_ref, 0)._replace(count=torch.zeros(T + 1)))
    with pytest.raises(TypeError, match="FleetShards"):
        eng.update(s_ref, _batches(8)[0])
    with pytest.raises(ValueError, match=f"T = {T}"):
        eng.update(placed, _batches(8)[0][:-1])


# -- parity with the reference ---------------------------------------------------------


def _reference(quant, **kw):
    specs = jfl.fleet_specs(jax.random.PRNGKey(0), T, "dense", M, N, 1.5)
    quants = jfl.fleet_quantizers(jax.random.PRNGKey(7), T, M, quant)
    return jfl.FleetEngine(specs, quantizers=quants, **kw)


def _port_mesh_of(jeng, p):
    w = np.stack([np.asarray(jeng.operator(t).w) for t in range(T)])
    stacked = convert.stacked_operator_from_numpy("dense", (w,), N, M, device="cpu")
    quants = None
    if jeng.quantized:
        quants = [convert.quantizer_from_numpy(jeng.bits, d, device="cpu")
                  for d in np.asarray(jeng.dither)]
    return fl.FleetEngine(stacked, quantizers=quants, sharding="mesh", mesh=_mesh(p))


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("p", [2, 4])
def test_parity_with_the_reference_fleet(p, quant):
    """The port's mesh(p) against the reference unsharded and at
    ``sharding="mesh", tenant_shards=1``: exact bounds and counts, z to the
    bar, int32 code sums within their boundary flips."""
    jplain, jmesh = _reference(quant), _reference(quant, sharding="mesh", tenant_shards=1)
    teng = _port_mesh_of(jplain, p)
    xs = _batches(9, rounds=2).numpy()
    ids = np.array([5, 0, 5, 2, 7, 7])
    xr = np.random.default_rng(9).standard_normal((6, B, N)).astype(np.float32)
    ts = teng.merge(teng.update(teng.init_state(), xs[0]),
                    teng.update(teng.init_state(), torch.from_numpy(xs[1])))
    ts = fl.gather_rows(teng.ingest(teng.place_state(fl.gather_rows(ts, CPU)), ids, xr), CPU)
    for jeng in (jplain, jmesh):
        js = jeng.merge(jeng.update(jeng.init_state(), jnp.asarray(xs[0])),
                        jeng.update(jeng.init_state(), jnp.asarray(xs[1])))
        js = jeng.ingest(js, ids, jnp.asarray(xr))
        for f in ("weight_sum", "lower", "upper", "count"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
        if quant == "1bit":
            for t in range(T):
                rows = np.concatenate([xs[0, t], xs[1, t], xr[ids == t].reshape(-1, N)])
                theta = np.asarray(jeng.operator(t).apply(jnp.asarray(rows)))
                theta = theta + np.asarray(jeng.dither[t])
                assert_sums_within_flips((ts.qcos_acc[t], ts.qsin_acc[t]),
                                         (js.qcos_acc[t], js.qsin_acc[t]), theta, 1)
        tz = fl.gather_rows(teng.finalize(teng.place_state(ts))[0], CPU).numpy()
        np.testing.assert_allclose(tz, np.asarray(jeng.finalize(js)[0]), atol=Z_TOL, rtol=0)


# -- 2. config errors ----------------------------------------------------------------


class _DeviceMeshLike:
    mesh_dim_names = ("tenant",)


def _jmesh(axis="tenant"):
    return jsharding.tenant_mesh(1, axis=axis)


# case -> (the port's kwargs, the reference's kwargs or None, error, message)
_ERRORS = {
    "unknown sharding": (dict(sharding="grid", device="cpu"), lambda: dict(sharding="grid"),
                         ValueError, "sharding must be one of"),
    "mesh without mesh sharding": (dict(mesh=_mesh(1), device="cpu"),
                                   lambda: dict(mesh=_jmesh()), ValueError,
                                   r"require FleetEngine\(sharding='mesh'\)"),
    "shards without mesh sharding": (dict(tenant_shards=2, device="cpu"),
                                     lambda: dict(tenant_shards=2), ValueError,
                                     r"require FleetEngine\(sharding='mesh'\)"),
    "extent against the mesh": (dict(sharding="mesh", mesh=_mesh(1), tenant_shards=2),
                                lambda: dict(sharding="mesh", mesh=_jmesh(), tenant_shards=2),
                                ValueError, "axis has 1 devices"),
    "axis not in the mesh": (dict(sharding="mesh", mesh=_mesh(1, "rows")),
                             lambda: dict(sharding="mesh", mesh=_jmesh("rows")), ValueError,
                             "do not include the tenant shard axis 'tenant'"),
    "indivisible": (dict(sharding="mesh", mesh=_mesh(3)), None, ValueError,
                    "n_tenants=8 is not divisible by tenant_shards=3"),
    "device with a mesh": (dict(sharding="mesh", mesh=_mesh(2), device="cpu"), None, ValueError,
                           "in place of device="),
    "not a tenant mesh": (dict(sharding="mesh", mesh=_DeviceMeshLike()), None, TypeError,
                          "TenantMesh"),
}


@pytest.mark.parametrize("case", sorted(_ERRORS))
def test_config_errors_carry_the_reference_messages(case):
    port_kw, ref_kw, err, match = _ERRORS[case]
    with pytest.raises(err, match=match):
        fl.FleetEngine(fl.fleet_specs(0, T, "dense", M, N, 1.5), **port_kw)
    if ref_kw is not None:
        with pytest.raises(err, match=match):
            _reference("none", **ref_kw())


def test_mesh_refuses_mismatched_blocks_and_counts():
    a = fl.fleet_specs(0, 4, "dense", M, N, 1.0)
    b = fl.fleet_specs(1, 4, "structured", M, N, 1.0)
    with pytest.raises(ValueError, match="tenant 4 operator leaves do not match tenant 0"):
        fl.FleetEngine(a + b, sharding="mesh", mesh=_mesh(2))
    quants = fl.fleet_quantizers(0, 4, M, "1bit", device="cpu") + fl.fleet_quantizers(
        0, 4, M, "2bit", device="cpu")
    with pytest.raises(ValueError, match="bit width"):
        fl.FleetEngine(a + a, quantizers=quants, sharding="mesh", mesh=_mesh(2))
    with pytest.raises(ValueError, match="7 quantizers for 8 tenants"):
        fl.FleetEngine(a + a, quantizers=quants[:7], sharding="mesh", mesh=_mesh(2))
    eng = fl.FleetEngine(a + a, sharding="mesh", mesh=_mesh(2))
    for call in (lambda: eng.update(eng.init_state(), _batches(0)[0], t=1.0),
                 lambda: eng.ingest(eng.init_state(), [0], _batches(0)[0][:1], t=1.0),
                 lambda: eng.decay_to(eng.init_state(), 1.0)):
        with pytest.raises(ValueError, match="decay-enabled"):
            call()
    with pytest.raises(ValueError, match=r"lie in \[0, 8\)"):
        eng.ingest(eng.init_state(), [8], _batches(0)[0][:1])
    for bad in (-1, T):
        with pytest.raises(ValueError, match="out of range"):
            eng.owner_shard(bad)


def test_repr_and_state_bytes_name_the_shards():
    eng = _engine("1bit", 4, decay=0.5)
    text = repr(eng)
    assert "shards=4x2rows(axis='tenant')" in text and "devices=[cpu, cpu, cpu, cpu]" in text
    assert "bits=1" in text and "decay=0.5" in text
    assert eng.state_bytes() == _engine("1bit", decay=0.5).state_bytes()
    assert eng.device is None and eng.devices == (CPU,) * 4


# -- 3. the shard-routed service ---------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("p", [2, 4])
def test_mesh_service_interleavings_match_isolated(p, seed, tmp_path):
    """Random submit / flush (sync and async) / evict / restore / decode on a
    mesh(p) service leave every tenant bitwise an isolated SketchEngine fold
    of its own requests, and the whole state bitwise an unsharded
    service's under the same script."""
    rng = np.random.default_rng(seed)
    eng = _engine(p=p)
    plain = _engine()
    iso = [SketchEngine(eng.operator(t), device="cpu") for t in range(T)]
    iso_states = [e.init_state() for e in iso]
    svc = FleetService(eng, _cheap_decode_cfg(), checkpoint_dir=tmp_path / "mesh")
    ref = FleetService(plain, _cheap_decode_cfg(), checkpoint_dir=tmp_path / "plain")
    for op in rng.integers(0, 6 * T, 60).tolist():
        t, kind = op % T, op // T
        if kind <= 2:
            x = rng.standard_normal((int(rng.integers(3, 6)), N)).astype(np.float32)
            for s in (svc, ref):
                s.submit(t, x)
            iso_states[t] = iso[t].update(iso_states[t], torch.from_numpy(x))
        elif kind == 3:
            for s in (svc, ref):
                s.flush(async_ingest=bool(op % 2))
        elif kind == 4:
            for s in (svc, ref):
                s.flush()
                s.evict(t)
        else:
            assert svc.decode(t).centroids.device == CPU
    svc.flush()
    ref.flush()
    for t in range(T):
        for s in (svc, ref):
            if t in s.evicted:
                s.restore(t)
        assert _rows_equal(eng.tenant_state(svc.state, t), iso_states[t]), t
    assert _same_stacked(svc.state, ref.state)
    assert svc.stats.requests == ref.stats.requests
    assert [svc.version(t) for t in range(T)] == [ref.version(t) for t in range(T)]


@pytest.mark.parametrize("p", [2, 4])
def test_flush_dispatches_never_span_blocks(p, monkeypatch):
    """Every fleet ingest a flush makes touches one block, each tenant's
    requests keep their order, and ``fleet.flush.shard_requests{shard=s}``
    counts each block's requests."""
    eng = _engine(p=p)
    svc = FleetService(eng, _cheap_decode_cfg())
    seen = []
    inner = eng.ingest

    def recording(state, ids, batches, *a, **kw):
        seen.append((np.asarray(ids).copy(), [b.clone() for b in batches]))
        return inner(state, ids, batches, *a, **kw)

    monkeypatch.setattr(eng, "ingest", recording)
    tobs.enable()
    rng = np.random.default_rng(11)
    ids = rng.integers(0, T, 40)
    xs = rng.standard_normal((40, B, N)).astype(np.float32)
    for t, x in zip(ids, xs):
        svc.submit(int(t), x)
    assert svc.flush() == 40
    assert all(len(set(d_ids // eng.shard_rows)) == 1 for d_ids, _ in seen)
    assert svc.stats.flushes == len(seen) >= len(set(ids // eng.shard_rows))
    for t in range(T):
        got = [b for d_ids, bs in seen for i, b in zip(d_ids, bs) if i == t]
        want = [torch.from_numpy(x) for i, x in zip(ids, xs) if i == t]
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    snap = tobs.snapshot()
    counts = {s: snap.get(f"fleet.flush.shard_requests{{shard={s}}}", 0) for s in range(p)}
    assert sum(counts.values()) == 40
    assert counts == {s: int(np.sum(ids // eng.shard_rows == s)) for s in range(p)
                      if np.any(ids // eng.shard_rows == s)} | {
        s: 0 for s in range(p) if not np.any(ids // eng.shard_rows == s)}


def test_mesh_service_decodes_and_checkpoints_on_the_owner(tmp_path):
    """Decode, drift, evict and restore of tenants in different blocks: the
    restored row is bitwise the evicted one, on its owner's device; a
    windowed mesh service round-trips its bucket columns too."""
    eng = _engine(p=4, decay=0.9)
    svc = FleetService(eng, _cheap_decode_cfg(), checkpoint_dir=tmp_path / "a",
                       window_buckets=3)
    rng = np.random.default_rng(12)
    for tick in range(4):
        for t in range(T):
            svc.submit(t, rng.standard_normal((B, N)).astype(np.float32), t=float(tick))
        svc.flush(async_ingest=tick % 2 == 1)
    for t in (0, 2, 5, 7):
        res = svc.decode(t)
        assert res.centroids.shape == (2, N) and bool(torch.isfinite(res.centroids).all())
        assert svc.drift(t) >= 0.0
        row = eng.tenant_state(svc.state, t)
        column = svc.window.tenant_column(svc.window_state, t)
        svc.evict(t)
        assert float(eng.tenant_state(svc.state, t).count) == 0.0
        svc.restore(t)
        assert _rows_equal(eng.tenant_state(svc.state, t), row)
        assert all(_rows_equal(a, b) for a, b in
                   zip(svc.window.tenant_column(svc.window_state, t), column))


# -- 4. the mesh, the wire model and the window -------------------------------------


def test_tenant_mesh_validation():
    mesh = _mesh(4, "rows")
    assert isinstance(mesh, TenantMesh)
    assert mesh.mesh_dim_names == ("rows",) and mesh.shape == (4,)
    assert mesh.devices == (CPU,) * 4
    assert axis_extent(mesh, ("rows",)) == 4
    assert jsharding.tenant_mesh(1, axis="rows").axis_names == mesh.mesh_dim_names
    with pytest.raises(ValueError, match="shards must be >= 1"):
        tenant_mesh(0)
    with pytest.raises(ValueError, match="only 2 given"):
        tenant_mesh(3, devices=[CPU, CPU])
    if not torch.cuda.is_available():
        # No card: the default mesh refuses, it never falls back to the CPU.
        for p in (1, 2):
            with pytest.raises(ValueError, match=f"tenant_mesh needs {p} devices, only 0"):
                tenant_mesh(p)
        with pytest.raises(ValueError, match="only 0 available"):
            fl.FleetEngine(fl.fleet_specs(0, T, "dense", M, N, 1.0), sharding="mesh",
                           tenant_shards=2)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tenant_mesh(1, devices=["cuda"])


@pytest.mark.parametrize("p", PS)
def test_fleet_wire_cost_model_beside_the_mesh(p):
    """The model's placement is the mesh fleet's: rows a shard, a block's
    resident bytes, one row a checkpoint (one hop, host <-> owner), nothing
    on the hot path; and it is the reference's model."""
    eng = _engine("1bit", p)
    state = eng.init_state()
    row_bytes = sum(v.numel() * v.element_size() for v in eng.tenant_state(state, 0))
    model = topo.fleet_wire_cost_model(row_bytes, T, p, "tree")
    assert model == jtopo.fleet_wire_cost_model(row_bytes, T, p, "tree")
    assert model["rows_per_shard"] == eng.shard_rows
    assert all(model["shard_state_bytes"] == blk.state_bytes() for blk in eng.blocks)
    assert model["steady_state_bytes"] == 0
    assert (model["checkpoint_bytes"], model["checkpoint_hops"]) == (row_bytes, 1)


@pytest.mark.parametrize("p", [2, 4])
def test_window_over_a_mesh_fleet(p):
    """A SketchWindow over a mesh fleet: reads, state_bytes and the tenant
    columns are the unsharded window's."""
    eng, ref = _engine(p=p), _engine()
    w, wr = SketchWindow(eng, 3), SketchWindow(ref, 3)
    ws, wsr = w.init_state(), wr.init_state()
    rng = np.random.default_rng(13)
    for tick in range(5):
        xs = _batches(20 + tick)[0]
        ws, wsr = w.update(ws, xs, t=float(tick)), wr.update(wsr, xs, t=float(tick))
        ids = rng.integers(0, T, 6)
        xr = torch.from_numpy(rng.standard_normal((6, B, N)).astype(np.float32))
        ws, wsr = w.ingest(ws, ids, xr, t=float(tick)), wr.ingest(wsr, ids, xr, t=float(tick))
    assert _same_stacked(w.read(ws), wr.read(wsr))
    assert all(torch.equal(a, b) for a, b in zip(fl.gather_rows(w.finalize(ws), CPU),
                                                 wr.finalize(wsr)))
    assert w.state_bytes(ws) == wr.state_bytes(wsr) > 0
    t = T - 1
    column = w.tenant_column(ws, t)
    assert all(_rows_equal(a, b) for a, b in zip(column, wr.tenant_column(wsr, t)))
    cut = w.reset_tenant(ws, t)
    assert float(w.read(cut).blocks[-1].count[-1]) == 0.0
    assert _same_stacked(w.read(w.set_tenant_column(cut, t, column)), wr.read(wsr))


# -- 5. zero collectives ----------------------------------------------------------------


_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
                "reduce_scatter_tensor", "broadcast", "reduce", "gather", "scatter",
                "all_to_all", "all_to_all_single", "send", "recv", "isend", "irecv",
                "barrier", "init_process_group", "new_group")


@pytest.mark.parametrize("p", [2, 4])
def test_hot_path_makes_no_collective_and_no_gather(p, monkeypatch):
    """With every ``torch.distributed`` collective and ``gather_rows``
    raising, update, merge, ingest, decay_to, finalize and a service flush
    run, and every block's state, operator and dither stay on its device."""
    import torch.distributed as dist

    def refuse(*a, **k):
        raise AssertionError("the tenant mesh's hot path made a collective or a gather")

    mesh = tenant_mesh(p, devices=[torch.device("cpu")] * p)
    specs = fl.fleet_specs(0, T, "dense", M, N, 1.5)
    eng = fl.FleetEngine(specs, quantizers=fl.fleet_quantizers(7, T, M, "1bit", device="cpu"),
                         decay=0.9, sharding="mesh", mesh=mesh)
    for name in _COLLECTIVES:
        if hasattr(dist, name):
            monkeypatch.setattr(dist, name, refuse)
    monkeypatch.setattr(fl, "gather_rows", refuse)
    xs = _batches(30, rounds=2)
    s = eng.merge(eng.update(eng.init_state(), xs[0], t=1.0), eng.update(eng.init_state(), xs[1]))
    s = eng.ingest(s, np.array([0, T - 1, 3, 0]), xs[0][:4], t=2.0)
    s = eng.decay_to(s, 3.0)
    z, lo, hi = eng.finalize(s)
    svc = FleetService(eng, _cheap_decode_cfg())
    for t in range(T):
        svc.submit(t, np.ones((B, N), np.float32), t=4.0)
    svc.flush(async_ingest=True)
    for st in (s, svc.state):
        for dev, blk, block_state in zip(mesh.devices, eng.blocks, st.blocks):
            assert all(v.device == dev for v in block_state)
            assert all(v.device == dev for v in blk._stacked_op.leaves)
            assert blk.dither.device == dev and blk.device == dev
    for out in (z, lo, hi):
        assert all(b.device == d for b, d in zip(out.blocks, mesh.devices))


def test_fleet_engine_of_a_mesh_is_a_fleet_engine():
    """``sharding="mesh"`` gives a ``TenantMeshFleet``, still a ``FleetEngine``
    (the window and the service take it), and a spec-less stacked operator
    slices into the blocks."""
    eng = _engine(p=2)
    assert isinstance(eng, fl.FleetEngine) and isinstance(eng, fl.TenantMeshFleet)
    assert type(_engine()) is fl.FleetEngine
    stacked = _engine()._stacked_op
    by_stack = fl.FleetEngine(stacked, sharding="mesh", mesh=_mesh(4))
    assert by_stack.specs == (None,) * T
    assert all(torch.equal(a.leaves[0], stacked.leaves[0][2 * s:2 * s + 2])
               for s, a in enumerate(blk._stacked_op for blk in by_stack.blocks))
    assert dataclasses.is_dataclass(fl.FleetShards)
