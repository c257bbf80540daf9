"""The port's decayed engine states and ``SketchWindow`` against the
reference's, on shared frequencies, dithers, points and ticks: float sums to
1e-4 of N, int32 code sums exact (under the boundary rule of
``_torch_codes``), bounds, counts and stamps equal; plus the decay algebra's
monoid laws and the window's read, reuse and late-arrival semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_codes import assert_sums_within_flips
from repro.core import engine as jeng_mod
from repro.core import quantize as jqz
from repro.core.engine import SketchEngine as JaxEngine
from repro.core.window import SketchWindow as JaxWindow
from repro_torch import convert
from repro_torch.core import ckm as tckm
from repro_torch.core import engine as eng_mod
from repro_torch.core import fleet as fleet_mod
from repro_torch.core.engine import (
    DecayedQuantizedSketchEngineState,
    DecayedSketchEngineState,
    SketchEngine,
)
from repro_torch.core.window import SketchWindow, WindowState

pytestmark = pytest.mark.torch_port

GAMMA = 0.5
M = 24
SUM_TOL = 1e-4  # on sums / N, the engine backends' bar


def _data(seed, n_pts=200, n=4, m=M):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_pts, n)) * 2).astype(np.float32)
    w = rng.standard_normal((n, m)).astype(np.float32)
    return x, w


def _quantizers(spec):
    """The reference's quantizer for ``spec`` and the port's copy of it."""
    if spec == "none":
        return None, None
    jq = jqz.make_quantizer(jax.random.PRNGKey(3), M, spec)
    return jq, convert.quantizer_from_numpy(jq.bits, np.asarray(jq.dither), device="cpu")


def _engines(w, spec="none", decay=GAMMA):
    jq, tq = _quantizers(spec)
    jeng = JaxEngine(jnp.asarray(w), "xla", quantizer=jq, decay=decay)
    teng = SketchEngine(convert.operator_from_numpy(w, device="cpu"), device="cpu",
                        quantizer=tq, decay=decay)
    return jeng, teng


def _states_equal(a, b):
    return type(a) is type(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_matches_reference(state, jstate, n_pts, phases=None, bits=None):
    """A port state against the reference's: float sums to SUM_TOL of N, the
    newest int32 segment under the boundary rule, the rest equal."""
    assert state._fields == jstate._fields
    exact = ("lower", "upper", "count", "stamp", "gamma")
    for f in (f for f in exact if f in state._fields):
        np.testing.assert_array_equal(getattr(state, f).numpy(), np.asarray(getattr(jstate, f)),
                                      err_msg=f)
    for f in state._fields:
        if f in exact or f.startswith("q"):
            continue
        got, ref = getattr(state, f).numpy(), np.asarray(getattr(jstate, f))
        np.testing.assert_allclose(got / n_pts, ref / n_pts, atol=SUM_TOL, rtol=0, err_msg=f)
    if bits is not None:
        assert_sums_within_flips((state.qcos_acc, state.qsin_acc),
                                 (jstate.qcos_acc, jstate.qsin_acc), phases, bits)


# -- the decayed states against the reference's ------------------------------


@pytest.mark.parametrize("spec", ["none", "1bit", "4bit"])
def test_decayed_state_matches_reference_engine(spec):
    """Batches folded at ticks 0, 1, 1, 4 through both engines; then the
    state advanced to tick 6 with decay_to; then finalized."""
    x, w = _data(0, n_pts=400)
    jeng, teng = _engines(w, spec)
    js, ts = jeng.init_state(), teng.init_state()
    for (lo, hi), tk in zip([(0, 100), (100, 170), (170, 300), (300, 400)], [0.0, 1.0, 1.0, 4.0]):
        js = jeng.update(js, jnp.asarray(x[lo:hi]), t=tk)
        ts = teng.update(ts, torch.from_numpy(x[lo:hi]), t=tk)
    bits = None if spec == "none" else jqz.parse_bits(spec)
    newest = x[300:400] @ w + (0.0 if bits is None else np.asarray(jeng.quantizer.dither))
    _assert_matches_reference(ts, js, 400, newest, bits)
    js, ts = jeng.decay_to(js, 6.0), teng.decay_to(ts, 6.0)
    _assert_matches_reference(ts, js, 400, newest, bits)
    for got, ref in zip(teng.finalize(ts), jeng.finalize(js)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=SUM_TOL, rtol=0)


@pytest.mark.parametrize("spec", ["none", "1bit"])
def test_cross_engine_merge_of_reference_partials(spec):
    """The reference's partial states carried over and merged by the port
    give the reference's merge."""
    x, w = _data(1)
    jeng, teng = _engines(w, spec)
    ja = jeng.update(jeng.init_state(), jnp.asarray(x[:90]), t=2.0)
    jb = jeng.update(jeng.init_state(), jnp.asarray(x[90:]), t=5.0)
    cls = type(teng.init_state())
    ta, tb = (cls(*(_t(v) for v in s)) for s in (ja, jb))
    _assert_matches_reference(teng.merge(ta, tb), jeng.merge(ja, jb), 200)
    assert bool(torch.equal(teng.merge(ta, tb)[0], teng.merge(tb, ta)[0]))


@pytest.mark.parametrize("gamma", [0.5, 0.37, 0.99, 1.0])
def test_decay_factor_edge_cases(gamma):
    """The reference's factors: dt = nan (identity with identity) and dt <= 0
    give exactly 1.0, dt = inf (the identity's zero sums folding into a
    stamped state) gives gamma**inf, positive dt gives gamma**dt."""
    dts = np.array([np.nan, np.inf, 0.0, -3.0, 2.0, 0.25, 37.0], np.float32)
    got = eng_mod._decay_factor(torch.tensor(gamma), torch.from_numpy(dts)).numpy()
    ref = np.asarray(jeng_mod._decay_factor(jnp.float32(gamma), jnp.asarray(dts)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert got[[0, 2, 3]].tolist() == [1.0, 1.0, 1.0]


# -- the decay algebra ----------------------------------------------------------


@pytest.mark.parametrize("spec", ["none", "1bit", "8bit"])
def test_identity_bitwise(spec):
    x, w = _data(0)
    _, e = _engines(w, spec)
    s = e.update(e.init_state(), torch.from_numpy(x[:120]), t=3.0)
    s = e.update(s, torch.from_numpy(x[120:]), t=7.0)
    assert _states_equal(e.merge(e.init_state(), s), s)
    assert _states_equal(e.merge(s, e.init_state()), s)
    assert _states_equal(e.merge(e.init_state(), e.init_state()), e.init_state())


@pytest.mark.parametrize("spec", ["none", "8bit"])
def test_commutativity_bitwise(spec):
    x, w = _data(1)
    _, e = _engines(w, spec)
    a = e.update(e.init_state(), torch.from_numpy(x[:80]), t=0.0)
    b = e.update(e.init_state(), torch.from_numpy(x[80:]), t=5.0)
    assert _states_equal(e.merge(a, b), e.merge(b, a))


def test_same_stamp_merge_equals_undecayed_bitwise():
    x, w = _data(2)
    _, e = _engines(w)
    base = SketchEngine(e.freq_op, device="cpu")
    xt = torch.from_numpy(x)
    ab = e.merge(e.update(e.init_state(), xt[:60], t=4.0), e.update(e.init_state(), xt[60:], t=4.0))
    ref = base.merge(base.update(base.init_state(), xt[:60]),
                     base.update(base.init_state(), xt[60:]))
    for f in ref._fields:
        assert torch.equal(getattr(ab, f), getattr(ref, f)), f


def test_same_stamp_associativity():
    """Bitwise on the quantized int segments; float sums to 1e-5."""
    x, w = _data(2)
    xt = torch.from_numpy(x)
    parts = (xt[:60], xt[60:130], xt[130:])
    for spec in ("1bit", "none"):
        _, e = _engines(w, spec)
        a, b, c = (e.update(e.init_state(), p, t=4.0) for p in parts)
        left, right = e.merge(e.merge(a, b), c), e.merge(a, e.merge(b, c))
        if spec == "1bit":
            assert _states_equal(left, right)
        for zl, zr in zip(e.finalize(left), e.finalize(right)):
            np.testing.assert_allclose(zl.numpy(), zr.numpy(), atol=1e-5)


@pytest.mark.parametrize("ticks", [(0, 3, 6), (6, 0, 2), (4, 4, 1), (5, 2, 5)])
def test_cross_stamp_associativity(ticks):
    x, w = _data(3)
    xt = torch.from_numpy(x)
    _, e = _engines(w)
    a, b, c = (e.update(e.init_state(), p, t=float(tk))
               for p, tk in zip((xt[:60], xt[60:130], xt[130:]), ticks))
    left, right = e.merge(e.merge(a, b), c), e.merge(a, e.merge(b, c))
    for zl, zr in zip(e.finalize(left), e.finalize(right)):
        np.testing.assert_allclose(zl.numpy(), zr.numpy(), atol=1e-5)
    assert float(left.stamp) == float(right.stamp) == max(ticks)


@pytest.mark.parametrize("ticks", [(0, 1), (0, 3, 4, 8), (2, 5, 6)])
def test_closed_form_exponential_reweighting(ticks):
    """Interleaved update / decay_to == direct gamma**dt reweighting of the
    per-batch partials."""
    x, w = _data(4, n_pts=60 * len(ticks))
    xt = torch.from_numpy(x)
    _, e = _engines(w)
    base = SketchEngine(e.freq_op, device="cpu")
    batches = [xt[i * 60:(i + 1) * 60] for i in range(len(ticks))]
    s = e.init_state()
    for tk, b in zip(ticks, batches):
        s = e.decay_to(s, float(tk))  # a gratuitous clock advance changes nothing
        s = e.update(s, b, t=float(tk))
    t_end = float(ticks[-1]) + 2.0
    z, lo, hi = e.finalize(e.decay_to(s, t_end))
    cos = sin = wsum = 0.0
    for tk, b in zip(ticks, batches):
        p = base._partial_state(b, None)
        f = GAMMA ** (t_end - tk)
        cos, sin, wsum = cos + f * p.cos_acc, sin + f * p.sin_acc, wsum + f * p.weight_sum
    np.testing.assert_allclose(z.numpy(), (torch.cat([cos, -sin]) / wsum).numpy(), atol=1e-5)
    assert torch.equal(lo, xt.amin(0)) and torch.equal(hi, xt.amax(0))
    assert float(s.count) == x.shape[0]


def test_full_decay_finalizes_to_zero_sketch():
    x, w = _data(4)
    _, e = _engines(w)
    s = e.decay_to(e.update(e.init_state(), torch.from_numpy(x), t=0.0), 1e4)
    assert bool(torch.all(e.finalize(s)[0] == 0.0))


def test_decay_to_is_a_noop_backwards():
    x, w = _data(5)
    _, e = _engines(w, "1bit")
    s = e.update(e.init_state(), torch.from_numpy(x), t=3.0)
    assert _states_equal(e.decay_to(s, 1.0), s) and _states_equal(e.decay_to(s, 3.0), s)


def test_errors():
    x, w = _data(6)
    xt = torch.from_numpy(x)
    _, e = _engines(w)
    base = SketchEngine(e.freq_op, device="cpu")
    with pytest.raises(TypeError, match="mismatched state flavours"):
        eng_mod._merge_states(e.update(e.init_state(), xt, t=0.0),
                              base.update(base.init_state(), xt))
    with pytest.raises(ValueError, match="decay-enabled"):
        base.update(base.init_state(), xt, t=1.0)
    with pytest.raises(ValueError, match="decay-enabled"):
        base.decay_to(base.init_state(), 1.0)
    for bad in (1.5, 0.0, -0.1):
        with pytest.raises(ValueError, match="decay must be in"):
            SketchEngine(e.freq_op, device="cpu", decay=bad)


@pytest.mark.parametrize("spec", ["none", "1bit"])
def test_constant_tick_bitwise_transparent(spec):
    """Everything folded at one tick finalizes bitwise as the lifetime
    engine: the decay layer adds no numeric perturbation of its own."""
    x, w = _data(8)
    xt = torch.from_numpy(x)
    _, e = _engines(w, spec)
    life = SketchEngine(e.freq_op, device="cpu", quantizer=e.quantizer)
    sd = e.update(e.update(e.init_state(), xt[:100], t=2.0), xt[100:], t=2.0)
    sl = life.update(life.update(life.init_state(), xt[:100]), xt[100:])
    assert isinstance(sd, DecayedQuantizedSketchEngineState if spec != "none"
                      else DecayedSketchEngineState)
    for zd, zl in zip(e.finalize(sd), life.finalize(sl)):
        assert torch.equal(zd, zl)
    # decay=1.0 at changing ticks decays nothing either.
    _, one = _engines(w, spec, decay=1.0)
    s1 = one.update(one.update(one.init_state(), xt[:100], t=0.0), xt[100:], t=9.0)
    for za, zb in zip(one.finalize(s1), life.finalize(sl)):
        np.testing.assert_allclose(za.numpy(), zb.numpy(), atol=1e-6)


def test_quantized_agrees_with_float_decay():
    x, w = _data(11, n_pts=400)
    xt = torch.from_numpy(x)
    _, ef = _engines(w)
    _, eq = _engines(w, "8bit")
    sf, sq = ef.init_state(), eq.init_state()
    for i, tk in enumerate([0.0, 1.0, 4.0]):
        sf = ef.update(sf, xt[i * 130:(i + 1) * 130], t=tk)
        sq = eq.update(sq, xt[i * 130:(i + 1) * 130], t=tk)
    np.testing.assert_allclose(eq.finalize(sq)[0].numpy(), ef.finalize(sf)[0].numpy(), atol=5e-3)


def test_quantized_same_tick_split_invariance_bitwise():
    x, w = _data(12)
    xt = torch.from_numpy(x)
    _, e = _engines(w, "1bit")
    one = e.update(e.init_state(), xt, t=5.0)
    two = e.update(e.update(e.init_state(), xt[:77], t=5.0), xt[77:], t=5.0)
    assert _states_equal(one, two)


def test_ckm_config_threads_decay():
    _, w = _data(13)
    op = convert.operator_from_numpy(w, device="cpu")
    e = tckm.make_engine(op, tckm.CKMConfig(k=2, decay=GAMMA), "cpu")
    assert e.decay == GAMMA and isinstance(e.init_state(), DecayedSketchEngineState)
    assert tckm.make_engine(op, tckm.CKMConfig(k=2), "cpu").decay is None


# -- SketchWindow against the reference's --------------------------------------


def _windows(w, buckets=3, decay=None, bucket_ticks=1.0):
    jeng, teng = _engines(w, decay=decay)
    return (JaxWindow(jeng, buckets, bucket_ticks=bucket_ticks),
            SketchWindow(teng, buckets, bucket_ticks=bucket_ticks))


def _drive(jw, tw, schedule):
    """The same (batch, t) schedule through both windows."""
    jws, tws = jw.init_state(), tw.init_state()
    for b, tk in schedule:
        jws = jw.update(jws, jnp.asarray(b), t=tk)
        tws = tw.update(tws, torch.from_numpy(b), t=tk)
    np.testing.assert_array_equal(tws.slot_tick, jws.slot_tick)
    assert tws.head == jws.head
    return jws, tws


@pytest.mark.parametrize("decay", [None, GAMMA])
@pytest.mark.parametrize("read_t", [None, 2.0, 5.0, 5.5, 7.0, 100.0])
def test_window_reads_match_reference(decay, read_t):
    """Six ticks through a W = 3 window; every read (newest, mid-ring,
    past the head, long after) equals the reference's window read."""
    x, w = _data(20, n_pts=600)
    jw, tw = _windows(w, decay=decay)
    jws, tws = _drive(jw, tw, [(x[t * 100:(t + 1) * 100], float(t)) for t in range(6)])
    got, ref = tw.read(tws, read_t), jw.read(jws, read_t)
    n_in = max(float(ref.count), 1.0)
    _assert_matches_reference(got, ref, n_in)
    for a, b in zip(tw.finalize(tws, read_t), jw.finalize(jws, read_t)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=SUM_TOL)


def test_merge_on_read_is_exactly_the_last_w_buckets():
    x, w = _data(20, n_pts=600)
    xt = torch.from_numpy(x)
    _, tw = _windows(w)
    e = tw.engine
    ws = tw.init_state()
    for t in range(6):
        ws = tw.update(ws, xt[t * 100:(t + 1) * 100], t=float(t))
    ref = e.init_state()
    for t in (3, 4, 5):
        ref = e.update(ref, xt[t * 100:(t + 1) * 100])
    assert _states_equal(tw.read(ws, 5.0), ref) and _states_equal(tw.read(ws), ref)
    assert tw.read(ws, 5.0) is not ref


def test_slot_reuse_never_leaks_and_late_arrival_is_dropped():
    """Tick 0 and tick 3 share slot 0 (W = 3): once tick 3 claims it, no read
    sees tick 0's poison; a batch older than the ring changes nothing; both
    as the reference does."""
    x, w = _data(21, n_pts=500)
    poison = x[:100] + 100.0
    jw, tw = _windows(w)
    sched = [(poison, 0.0)] + [(x[t * 100:(t + 1) * 100], float(t)) for t in (1, 2, 3, 4)]
    jws, tws = _drive(jw, tw, sched)
    assert int(tws.slot_tick[0]) == 3
    for read_t in (3.0, 4.0, 5.0, 100.0):
        st = tw.read(tws, read_t)
        if float(st.count) > 0:
            assert float(st.upper.max()) < 50.0
    before = tw.read(tws, 4.0)
    late = tw.update(tws, torch.from_numpy(x[:100] + 999.0), t=0.0)
    jlate = jw.update(jws, jnp.asarray(x[:100] + 999.0), t=0.0)
    assert _states_equal(tw.read(late, 4.0), before)
    np.testing.assert_array_equal(late.slot_tick, jlate.slot_tick)


def test_bucket_ticks_scaling_matches_reference():
    x, w = _data(22, n_pts=400)
    jw, tw = _windows(w, buckets=2, bucket_ticks=10.0)
    sched = [(x[:100], 3.0), (x[100:200], 9.9), (x[200:300], 10.0), (x[300:], 25.0)]
    jws, tws = _drive(jw, tw, sched)
    for read_t in (15.0, 25.0):
        _assert_matches_reference(tw.read(tws, read_t), jw.read(jws, read_t), 400)


def test_window_validation_memory_and_fleet_methods():
    _, w = _data(23)
    _, e = _engines(w, decay=None)
    with pytest.raises(ValueError, match="buckets"):
        SketchWindow(e, 0)
    with pytest.raises(ValueError, match="bucket_ticks"):
        SketchWindow(e, 3, bucket_ticks=0.0)
    w2, w8 = SketchWindow(e, 2), SketchWindow(e, 8)
    assert w8.state_bytes(w8.init_state()) == 4 * w2.state_bytes(w2.init_state())
    assert isinstance(w2.init_state(), WindowState)
    for call in (lambda: w2.ingest(w2.init_state(), [0], [np.zeros((1, 4))], t=0.0),
                 lambda: w2.tenant_column(w2.init_state(), 0),
                 lambda: w2.set_tenant_column(w2.init_state(), 0, ()),
                 lambda: w2.reset_tenant(w2.init_state(), 0)):
        with pytest.raises(TypeError, match="fleet engine"):
            call()


# -- the fleet window ---------------------------------------------------------------


T_FLEET, B_FLEET, N_FLEET, M_FLEET = 3, 8, 3, 32


def _fleet_window(quant="none", decay=GAMMA, buckets=3):
    specs = fleet_mod.fleet_specs(0, T_FLEET, "dense", M_FLEET, N_FLEET, 1.5)
    quants = fleet_mod.fleet_quantizers(7, T_FLEET, M_FLEET, quant, device="cpu")
    fe = fleet_mod.FleetEngine(specs, quantizers=quants, decay=decay, device="cpu")
    return fe, SketchWindow(fe, buckets)


@pytest.mark.parametrize("decay", [None, GAMMA])
@pytest.mark.parametrize("quant", ["none", "1bit"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_window_bitwise_vs_isolated_tenant_windows(seed, quant, decay):
    """Seeded timestamped schedules of aligned updates, routed ingests (with
    duplicate ids) and tenant-column evict/restore on a fleet window ==
    each tenant's isolated engine window, bitwise, read at the same t."""
    rng = np.random.default_rng(seed)
    fe, fw = _fleet_window(quant, decay)
    refs = [fe.tenant_engine(t) for t in range(T_FLEET)]
    rws = [SketchWindow(e, fw.buckets) for e in refs]
    ws, rstates = fw.init_state(), [w.init_state() for w in rws]
    clock = 0.0
    for _ in range(8):
        clock += float(rng.integers(0, 3))
        action = rng.choice(["update", "ingest", "evict_restore"])
        if action == "update":
            blk = torch.from_numpy(rng.normal(size=(T_FLEET, B_FLEET, N_FLEET)).astype(np.float32))
            ws = fw.update(ws, blk, t=clock)
            rstates = [w.update(s, blk[t], t=clock) for t, (w, s) in enumerate(zip(rws, rstates))]
        elif action == "ingest":
            r = int(rng.integers(1, 5))
            ids = rng.integers(0, T_FLEET, r)
            bt = torch.from_numpy(rng.normal(size=(r, B_FLEET, N_FLEET)).astype(np.float32))
            ws = fw.ingest(ws, ids, bt, t=clock)
            for j, tid in enumerate(ids):
                rstates[tid] = rws[tid].update(rstates[tid], bt[j], t=clock)
        else:
            tid = int(rng.integers(0, T_FLEET))
            col = fw.tenant_column(ws, tid)
            ws = fw.set_tenant_column(fw.reset_tenant(ws, tid), tid, col)
    merged = fw.read(ws, clock)
    for t in range(T_FLEET):
        ref = rws[t].read(rstates[t], clock)
        assert _states_equal(fe.tenant_state(merged, t), ref), f"tenant {t} diverged"
        assert all(torch.equal(a, b)
                   for a, b in zip(fe.finalize_tenant(merged, t), refs[t].finalize(ref)))


def test_fleet_window_column_reset_restore_and_rotation():
    """A reset column reads as the identity in every bucket while the other
    tenants keep theirs; restoring it gives the state back bitwise; a
    wrapped ring drops the expired block's data; a column of the wrong
    length is refused."""
    fe, fw = _fleet_window("none", decay=None)
    rng = np.random.default_rng(5)
    ws = fw.init_state()
    poison = torch.full((T_FLEET, B_FLEET, N_FLEET), 100.0)
    ws = fw.update(ws, poison, t=0.0)
    for t in (1, 2, 3):
        ws = fw.update(ws, torch.from_numpy(
            rng.normal(size=(T_FLEET, B_FLEET, N_FLEET)).astype(np.float32)), t=float(t))
    assert float(fw.read(ws, 3.0).upper.max()) < 50.0
    col = fw.tenant_column(ws, 1)
    cleared = fw.reset_tenant(ws, 1)
    identity = fe.tenant_engine(1).init_state()
    assert all(_states_equal(fe.tenant_state(b, 1), identity) for b in cleared.buckets)
    for t in (0, 2):
        assert _states_equal(fe.tenant_state(fw.read(cleared), t), fe.tenant_state(fw.read(ws), t))
    back = fw.set_tenant_column(cleared, 1, col)
    assert all(_states_equal(a, b) for a, b in zip(back.buckets, ws.buckets))
    with pytest.raises(ValueError, match="buckets"):
        fw.set_tenant_column(ws, 1, col[:2])
