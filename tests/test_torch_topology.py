"""The port's reduction topologies (host level) against the reference's
``core/topology.py``, in one process: the registry, the merge plans and
roots, the wire cost models, schedule and arrival-order invariance over
partials the port's engine built from shared numpy chunks, the straggler
merger, ``reduce_partials``, a user-registered topology, and the
``distributed_sketch.SketchState`` accumulator."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed_sketch as jds
from repro.core import engine as jeng
from repro.core import quantize as jqz
from repro.core import sketch as jsk
from repro.core import topology as jtopo
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch.core import distributed_sketch as tds
from repro_torch.core import topology as ttopo
from repro_torch.core.engine import SketchEngine
from repro_torch.data.pipeline import chunked

pytestmark = pytest.mark.torch_port

TOPOLOGY_NAMES = ("allreduce", "tree", "ring")


def _data(seed, npts=600, n=4, m=32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((npts, n)) * 2).astype(np.float32)
    w = rng.standard_normal((n, m)).astype(np.float32)
    dither = rng.uniform(0, 2 * np.pi, size=m).astype(np.float32)
    return x, w, dither


def _engine(w, dither=None, decay=None, topology="allreduce"):
    q = None if dither is None else convert.quantizer_from_numpy(1, dither, device="cpu")
    return SketchEngine(convert.operator_from_numpy(w, device="cpu"), device="cpu",
                        quantizer=q, decay=decay, reduce_topology=topology)


def _partials(eng, x, n_parts, ticks=False):
    """The engine's partial states of ``n_parts`` numpy chunks of ``x``
    (decayed engines stamp chunk i at tick i // 2)."""
    size = max(1, x.shape[0] // n_parts)
    out = []
    for i, b in enumerate(chunked(x, size)):
        kw = {"t": i // 2} if ticks else {}
        out.append(eng.update(eng.init_state(), torch.from_numpy(b), **kw))
    return out


def _assert_states_equal(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# -- registry ---------------------------------------------------------------


def test_registry_names_equal_the_reference():
    assert ttopo.available_topologies() == jtopo.available_topologies()
    assert set(ttopo.available_topologies()) >= set(TOPOLOGY_NAMES)
    with pytest.raises(ValueError, match="unknown reduce topology 'hypercube9000'"):
        ttopo.get_topology("hypercube9000")
    with pytest.raises(ValueError, match="unknown reduce topology"):
        _engine(np.ones((2, 4), np.float32), topology="hypercube9000")


def test_register_rejects_collisions():
    with pytest.raises(ValueError, match="topology 'tree' already registered"):
        ttopo.register_topology(ttopo.get_topology("tree"))


def test_exports_match_the_reference():
    assert set(jtopo.__all__) <= set(ttopo.__all__)
    for name in ("TOPOLOGIES", "StragglerMerger", "Topology", "available_topologies",
                 "axis_reduce", "reduce_states", "register_topology", "wire_cost_model"):
        assert getattr(tcore, name) is getattr(ttopo, name)
        assert name in tcore.__all__


@pytest.mark.parametrize("name", TOPOLOGY_NAMES)
def test_plans_and_roots_equal_the_reference(name):
    for n in range(1, 18):
        assert ttopo.merge_schedule(n, name) == jtopo.merge_schedule(n, name), (name, n)
        root = ttopo.get_topology(name).root(n)
        assert root == jtopo.get_topology(name).root(n), (name, n)
        srcs = [s for rnd in ttopo.merge_schedule(n, name) for _, s in rnd]
        assert sorted(srcs + [root]) == list(range(n)), (name, n)
    for bad in (0, -3):
        with pytest.raises(ValueError, match="need at least one partial state"):
            ttopo.merge_schedule(bad, name)


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as err:
        return ("ValueError", str(err))


@pytest.mark.parametrize("name", TOPOLOGY_NAMES)
def test_wire_cost_model_equals_the_reference(name):
    for state_bytes in (0, 1, 1024, 8008, 3 * 10**6):
        for p in (-1, 0, 1, 2, 3, 4, 7, 8, 16, 33):
            got = _outcome(ttopo.wire_cost_model, state_bytes, p, name)
            assert got == _outcome(jtopo.wire_cost_model, state_bytes, p, name), (state_bytes, p)
    costs = {t: ttopo.wire_cost_model(1024, 8, t) for t in TOPOLOGY_NAMES}
    assert costs["tree"]["hops"] == 3 and costs["ring"]["hops"] == 7
    assert (costs["allreduce"]["bytes_per_device"] < costs["tree"]["bytes_per_device"]
            < costs["ring"]["bytes_per_device"])
    with pytest.raises(ValueError, match="unknown reduce topology"):
        ttopo.wire_cost_model(8, 2, "star")


@pytest.mark.parametrize("name", TOPOLOGY_NAMES)
def test_fleet_wire_cost_model_equals_the_reference(name):
    for row_bytes in (8, 8016):
        for tenants in (-4, 0, 1, 6, 8, 1024):
            for shards in (-1, 0, 1, 2, 3, 4, 8):
                args = (row_bytes, tenants, shards, name)
                got = _outcome(ttopo.fleet_wire_cost_model, *args)
                assert got == _outcome(jtopo.fleet_wire_cost_model, *args), args


# -- schedule and arrival-order invariance -----------------------------------


@pytest.mark.parametrize("n_parts", [1, 2, 5, 9])
def test_quantized_partials_bitwise_under_every_topology_and_order(n_parts):
    x, w, dither = _data(n_parts)
    eng = _engine(w, dither)
    parts = _partials(eng, x, n_parts)
    rng = np.random.default_rng(n_parts)
    ref = ttopo.reduce_states(eng.merge, parts, "allreduce")
    for name in TOPOLOGY_NAMES:
        for _ in range(3):
            order = [int(i) for i in rng.permutation(len(parts))]
            _assert_states_equal(ttopo.reduce_states(eng.merge, parts, name, order=order), ref)
    whole = eng.update(eng.init_state(), torch.from_numpy(x))
    _assert_states_equal(ref, whole)  # and any split of the data


@pytest.mark.parametrize("n_parts", [2, 5, 9])
def test_float_partials_agree_across_schedules_and_with_the_reference(n_parts):
    x, w, _ = _data(10 + n_parts)
    eng = _engine(w)
    parts = _partials(eng, x, n_parts)
    finals = [eng.finalize(ttopo.reduce_states(eng.merge, parts, name))
              for name in TOPOLOGY_NAMES]
    for z, lo, hi in finals[1:]:
        np.testing.assert_allclose(z.numpy(), finals[0][0].numpy(), atol=1e-6)
        assert torch.equal(lo, finals[0][1]) and torch.equal(hi, finals[0][2])
    # The reference's reduce_states over its own engine's partials: 1e-4.
    je = jeng.SketchEngine(jnp.asarray(w), "xla", chunk=128)
    size = max(1, x.shape[0] // n_parts)
    jparts = [je.update(je.init_state(), jnp.asarray(b)) for b in chunked(x, size)]
    for name, (z, lo, hi) in zip(TOPOLOGY_NAMES, finals):
        jz, jlo, jhi = je.finalize(jtopo.reduce_states(je.merge, jparts, name))
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-4)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


@pytest.mark.parametrize("quantized", [False, True])
def test_decayed_partials_under_every_topology(quantized):
    """Decayed partials stamped at several ticks: the quantized twin is
    bitwise under every schedule and order, the float one to 1e-6, and both
    finalize within 1e-4 of the reference's decayed engine."""
    x, w, dither = _data(21, npts=480)
    eng = _engine(w, dither if quantized else None, decay=0.9)
    parts = _partials(eng, x, 6, ticks=True)
    ref = ttopo.reduce_states(eng.merge, parts, "allreduce")
    rng = np.random.default_rng(3)
    for name in TOPOLOGY_NAMES:
        order = [int(i) for i in rng.permutation(len(parts))]
        got = ttopo.reduce_states(eng.merge, parts, name, order=order)
        if quantized:
            for f in ("qcos_acc", "qsin_acc", "count", "stamp", "lower", "upper"):
                assert torch.equal(getattr(got, f), getattr(ref, f)), (name, f)
        np.testing.assert_allclose(eng.finalize(got)[0].numpy(), eng.finalize(ref)[0].numpy(),
                                   atol=1e-6)
    q = jqz.SketchQuantizer(1, jnp.asarray(dither)) if quantized else None
    je = jeng.SketchEngine(jnp.asarray(w), "xla", quantizer=q, decay=0.9)
    jparts = [je.update(je.init_state(), jnp.asarray(b), t=i // 2)
              for i, b in enumerate(chunked(x, 80))]
    jz, _, _ = je.finalize(jtopo.reduce_states(je.merge, jparts, "tree"))
    np.testing.assert_allclose(eng.finalize(ref)[0].numpy(), np.asarray(jz), atol=1e-4)


def test_straggler_merger_matches_the_schedules():
    x, w, dither = _data(11)
    eng = _engine(w, dither)
    parts = _partials(eng, x, 7)
    ref = ttopo.reduce_states(eng.merge, parts, "tree")
    sm = ttopo.StragglerMerger(eng.merge, eng.init_state())
    for i in np.random.default_rng(0).permutation(len(parts)):
        sm.add(parts[i])
    assert sm.arrived == len(parts)
    _assert_states_equal(sm.result(), ref)


def test_reduce_partials_and_bad_orders():
    x, w, _ = _data(3)
    eng = _engine(w)
    parts = _partials(eng, x, 5)
    z_a, *_ = eng.finalize(eng.reduce_partials(parts))
    z_r, *_ = eng.finalize(eng.reduce_partials(parts, "ring"))
    np.testing.assert_allclose(z_a.numpy(), z_r.numpy(), atol=1e-6)
    ring_eng = _engine(w, topology="ring")
    _assert_states_equal(ring_eng.reduce_partials(parts),
                         ttopo.reduce_states(eng.merge, parts, "ring"))
    with pytest.raises(ValueError, match=r"order must permute range\(5\)"):
        ttopo.reduce_states(eng.merge, parts, "tree", order=[0, 0, 1, 2, 3])
    with pytest.raises(ValueError, match="need at least one partial state"):
        ttopo.reduce_states(eng.merge, [], "tree")


def test_a_registered_topology_is_selectable_and_the_registry_restored():
    def reversed_plan(n):
        return [[(i - 1, i)] for i in range(n - 1, 0, -1)]

    topo = ttopo.Topology("reverse", reversed_plan, ttopo.get_topology("allreduce").device_reduce)
    saved = dict(ttopo.TOPOLOGIES)
    try:
        ttopo.register_topology(topo)
        assert "reverse" in ttopo.available_topologies()
        x, w, dither = _data(5)
        eng = _engine(w, dither, topology="reverse")
        parts = _partials(eng, x, 4)
        _assert_states_equal(eng.reduce_partials(parts),
                             ttopo.reduce_states(eng.merge, parts, "allreduce"))
        assert ttopo.wire_cost_model(64, 4, "reverse") == {
            "topology": "reverse", "p": 4, "bytes_per_device": None, "hops": None}
    finally:
        ttopo.TOPOLOGIES.clear()
        ttopo.TOPOLOGIES.update(saved)
    assert "reverse" not in ttopo.available_topologies()


# -- SketchState -------------------------------------------------------------


def test_sketch_state_update_merge_finalize_equals_the_batch_sketch():
    """Three uneven chunks through two accumulators, then merged: the
    reference's accumulator test, against the reference's sketch."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 4)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    wt = torch.from_numpy(w)
    a = tds.init_state(16, 4, device="cpu")
    b = tds.init_state(16, 4, device="cpu")
    a = tds.update(a, torch.from_numpy(x[:50]), wt)
    a = tds.update(a, torch.from_numpy(x[50:120]), wt)
    b = tds.update(b, torch.from_numpy(x[120:]), wt)
    z, lo, hi = tds.finalize(tds.merge(a, b))
    np.testing.assert_allclose(z.numpy(), np.asarray(jsk.sketch(jnp.asarray(x), jnp.asarray(w))),
                               atol=1e-5)
    np.testing.assert_allclose(lo.numpy(), x.min(0), atol=1e-6)
    np.testing.assert_allclose(hi.numpy(), x.max(0), atol=1e-6)
    ja = jds.update(jds.init_state(16, 4), jnp.asarray(x[:120]), jnp.asarray(w))
    jb = jds.update(jds.init_state(16, 4), jnp.asarray(x[120:]), jnp.asarray(w))
    for got, ref in zip(tds.merge(a, b), jds.merge(ja, jb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_sketch_state_merge_is_commutative():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((100, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    a = tds.update(tds.init_state(8, 3, device="cpu"), x[:40], w)
    b = tds.update(tds.init_state(8, 3, device="cpu"), x[40:], w)
    z1, *_ = tds.finalize(tds.merge(a, b))
    z2, *_ = tds.finalize(tds.merge(b, a))
    np.testing.assert_allclose(z1.numpy(), z2.numpy(), atol=1e-6)
    z0, lo0, hi0 = tds.finalize(tds.init_state(8, 3, device="cpu"))
    assert not z0.any() and torch.isinf(lo0).all() and torch.isinf(hi0).all()
