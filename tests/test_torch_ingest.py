"""The port's async ingest against the sync fold and the reference: the
producer keeps order and content, relays a source's error and stops on an
early exit; the async fold gives the sync fold's bits (float and quantized),
resumes from a state, donates without touching the caller's state; async
``fit_streaming`` gives the sync result's bits and the reference's sketch."""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ckm as jckm
from repro.core import ingest as jing
from repro.core import quantize as jqz
from repro.core.engine import SketchEngine as JaxEngine
from repro_torch import convert
from repro_torch.core import ckm as tckm
from repro_torch.core import ingest as ing
from repro_torch.core.engine import SketchEngine

pytestmark = pytest.mark.torch_port


def _blobs(n_pts=2000, n=3, m=40, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_pts, n)) * 2).astype(np.float32)
    w = rng.standard_normal((n, m)).astype(np.float32)
    return x, w


def _chunks(x, size):
    return [x[i:i + size] for i in range(0, x.shape[0], size)]


def _engine(w, spec="none"):
    q = None
    if spec != "none":
        jq = jqz.make_quantizer(jax.random.PRNGKey(4), w.shape[1], spec)
        q = convert.quantizer_from_numpy(jq.bits, np.asarray(jq.dither), device="cpu")
    return SketchEngine(convert.operator_from_numpy(w, device="cpu"), device="cpu", quantizer=q)


def _sync_fold(e, batches, state=None):
    state = e.init_state() if state is None else state
    for b in batches:
        state = e.update(state, torch.from_numpy(b))
    return state


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("prefetch", [1, 2, 5])
def test_prefetched_keeps_order_and_content(prefetch):
    x, _ = _blobs(n_pts=997)  # ragged tail
    got = list(ing.prefetched(_chunks(x, 100), prefetch))
    ref = list(jing.prefetched(_chunks(x, 100), prefetch))
    assert len(got) == len(ref) == 10
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


@pytest.mark.parametrize("bad", [0, -1])
def test_bad_depth_rejected(bad):
    with pytest.raises(ValueError, match="prefetch depth"):
        list(ing.prefetched([np.zeros((2, 2))], prefetch=bad))


def test_source_error_reaches_the_consumer():
    def bad():
        yield np.zeros((4, 2), np.float32)
        raise RuntimeError("disk on fire")

    with pytest.raises(RuntimeError, match="disk on fire"):
        list(ing.prefetched(bad(), 2))
    _, w = _blobs(n=2)
    with pytest.raises(RuntimeError, match="disk on fire"):
        ing.ingest_stream(_engine(w), bad())


def test_failing_placement_raises_and_never_falls_back(monkeypatch):
    """A placement that fails (on the card: pinning, the side stream or the
    copy) reaches the consumer as an exception; no batch is folded by
    another route."""
    x, w = _blobs(n_pts=300)
    e = _engine(w)
    folded = []
    real_update = e.update
    monkeypatch.setattr(e, "update", lambda s, b: folded.append(b) or real_update(s, b))

    def broken(batch):
        raise RuntimeError("pinned allocation failed")

    monkeypatch.setattr(ing, "_place_cpu", broken)
    with pytest.raises(RuntimeError, match="pinned allocation failed"):
        ing.ingest_stream(e, _chunks(x, 100))
    assert folded == []


def test_early_consumer_exit_stops_the_producer():
    x, _ = _blobs(n_pts=4000)
    it = ing.prefetched(_chunks(x, 100), 2)
    next(it)
    assert any(t.name == "sketch-ingest" for t in threading.enumerate())
    it.close()  # joins the producer (5 s at most)
    assert not any(t.name == "sketch-ingest" for t in threading.enumerate())


@pytest.mark.parametrize("spec", ["none", "1bit", "4bit"])
@pytest.mark.parametrize("prefetch", [1, 3])
def test_async_fold_is_bitwise_the_sync_fold(spec, prefetch):
    x, w = _blobs(n_pts=1503)
    e = _engine(w, spec)
    batches = _chunks(x, 200)
    sync = _sync_fold(e, batches)
    state, stats = ing.ingest_stream(e, batches, prefetch=prefetch)
    assert _equal(state, sync)
    assert stats.batches == 8 and stats.points == 1503
    assert 0.0 <= stats.overlap_efficiency <= 1.0 and stats.wall_s > 0.0


def test_async_fold_matches_the_reference_engine():
    """The port's async fold against the reference's async fold on the same
    W and batches: sums to 1e-4 of N, bounds equal."""
    x, w = _blobs(n_pts=1200)
    jstate, _ = jing.ingest_stream(JaxEngine(jnp.asarray(w), "xla"), _chunks(x, 250))
    state, _ = ing.ingest_stream(_engine(w), _chunks(x, 250))
    for f in ("cos_acc", "sin_acc", "weight_sum"):
        np.testing.assert_allclose(getattr(state, f).numpy() / 1200,
                                   np.asarray(getattr(jstate, f)) / 1200, atol=1e-4, err_msg=f)
    for f in ("lower", "upper", "count"):
        np.testing.assert_array_equal(getattr(state, f).numpy(), np.asarray(getattr(jstate, f)))


def test_resumes_from_an_existing_state():
    x, w = _blobs(n_pts=1000)
    e = _engine(w)
    head = e.update(e.init_state(), torch.from_numpy(x[:300]))
    tail, _ = ing.ingest_stream(e, _chunks(x[300:], 250), state=head)
    assert _equal(tail, _sync_fold(e, _chunks(x[300:], 250), head))
    for zs, zo in zip(e.finalize(tail), e.sketch(torch.from_numpy(x))):
        np.testing.assert_allclose(zs.numpy(), zo.numpy(), atol=1e-5)


@pytest.mark.parametrize("spec", ["none", "1bit"])
def test_donate_keeps_the_caller_state_and_the_bits(spec):
    x, w = _blobs(n_pts=1200)
    e = _engine(w, spec)
    head = e.update(e.init_state(), torch.from_numpy(x[:300]))
    saved = tuple(t.clone() for t in head)
    plain, _ = ing.ingest_stream(e, _chunks(x[300:], 300), state=head)
    donated, _ = ing.ingest_stream(e, _chunks(x[300:], 300), state=head, donate=True)
    assert _equal(head, saved)
    assert _equal(donated, plain)


def test_engine_sketch_stream_async_flag():
    x, w = _blobs(n_pts=800)
    e = _engine(w)
    z_s = e.sketch_stream(torch.from_numpy(b) for b in _chunks(x, 150))
    z_a = e.sketch_stream(_chunks(x, 150), async_ingest=True, prefetch=3)
    assert _equal(z_s, z_a)


SMALL = dict(m=60, sigma2=1.0, atom_steps=25, joint_steps=15, nnls_iters=25, final_steps=30)


@pytest.mark.parametrize("spec", ["none", "1bit"])
def test_async_fit_streaming_equals_sync(spec):
    x, _ = _blobs(n_pts=3000, n=2, seed=7)
    cfg = tckm.CKMConfig(k=3, sketch_quantization=spec, **SMALL)
    res_sync = tckm.fit_streaming(2, iter(_chunks(x, 500)), cfg, device="cpu")
    acfg = dataclasses.replace(cfg, ingest="async", ingest_prefetch=3)
    res_async = tckm.fit_streaming(2, iter(_chunks(x, 500)), acfg, device="cpu")
    for f in ("sketch", "centroids", "weights", "cost"):
        assert torch.equal(getattr(res_sync, f), getattr(res_async, f)), f
    assert _equal(res_sync.bounds, res_async.bounds)


def test_async_sketch_matches_the_reference_sketch():
    """The async streaming sketch against the reference's async streaming
    sketch on the same operator (carried over) and batches: 1e-4."""
    x, _ = _blobs(n_pts=3000, n=2, seed=7)
    jcfg = jckm.CKMConfig(k=3, m=60, sigma2=1.0, ingest="async")
    jz, jop, _, (jlo, jhi), _ = jckm.compute_sketch_streaming(
        jax.random.PRNGKey(2), iter(_chunks(x, 500)), jcfg)
    e = SketchEngine(convert.operator_from_numpy(np.asarray(jop.materialize()), device="cpu"),
                     device="cpu")
    z, lo, hi = e.sketch_stream(_chunks(x, 500), async_ingest=True)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-4)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


@pytest.mark.parametrize("mode", ["psychic", "ASYNC", ""])
def test_bad_ingest_mode_rejected(mode):
    x, _ = _blobs(n_pts=100)
    with pytest.raises(ValueError, match="ingest"):
        tckm.fit_streaming(0, iter(_chunks(x, 50)), tckm.CKMConfig(k=2, ingest=mode),
                           device="cpu")


def test_batch_source_protocol():
    x, _ = _blobs(n_pts=64)
    assert isinstance(_chunks(x, 32), ing.BatchSource)
    assert isinstance(iter(_chunks(x, 32)), ing.BatchSource)
    assert not isinstance(3, ing.BatchSource)


def test_async_fold_under_a_short_switch_interval():
    """Threads switched every microsecond, many small ragged batches and a
    queue of one: the fold still sees every batch once, in order (the sync
    fold's bits and its count)."""
    import sys

    x, w = _blobs(n_pts=3001, seed=3)
    e = _engine(w)
    batches = _chunks(x, 37)
    want = _sync_fold(e, batches)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for prefetch in (1, 2):
            state, stats = ing.ingest_stream(e, batches, prefetch=prefetch)
            assert _equal(state, want) and stats.points == 3001
    finally:
        sys.setswitchinterval(old)
