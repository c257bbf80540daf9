"""The port's CKM parts of the training substrate against the reference:
``data/clustering.CompressiveBalancer`` (the streaming sketch of document
embeddings, its reservoir, the decode and the balanced weights) and
``train/monitor.ActivationMonitor`` (the sketch of pooled hidden states,
through a dense and a structured operator; its drift scores).

The sketch states are held to the reference's ``distributed_sketch.update``
on the same operator (carried by ``convert``) to 1e-4 of their largest
magnitude, the engine's cross-backend bar; the reservoir (numpy's draws)
and ``drift`` (the same numpy arithmetic) exactly; the decode, which draws
from torch generators, by what the reference's ``TestBalancer`` asks of it
(the planted 0.6 / 0.3 / 0.1 masses within 0.08)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ckm as jckm
from repro.data import clustering as jclu
from repro.train import monitor as jmon
from repro_torch import convert
from repro_torch.core import ckm as tckm
from repro_torch.core import distributed_sketch as tds
from repro_torch.data import clustering as tclu
from repro_torch.train import monitor as tmon

pytestmark = pytest.mark.torch_port

TOL = 1e-4


def _close_state(got: tds.SketchState, want, what):
    for f, a, b in zip(got._fields, got, want, strict=True):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=TOL * max(float(np.max(np.abs(b))), 1.0),
                                   err_msg=f"{what}.{f}")


def _planted(seed, dim=4, counts=(1800, 900, 300)):
    """Three clusters of masses 0.6 / 0.3 / 0.1 at 8 sigma spacing, in
    order (the first batch is all of the heaviest cluster)."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((len(counts), dim)) * 8.0
    return np.concatenate([c + rng.standard_normal((n, dim)) for c, n in zip(cents, counts)]
                          ).astype(np.float32)


def test_balancer_sketch_and_reservoir_match_the_reference():
    """At a given sigma^2 and the reference's operator, four batches: the
    sketch state to the bar, the reservoir (256 rows of 600 seen) exactly."""
    pts = _planted(1)[::5]
    ref = jclu.CompressiveBalancer(k=3, dim=4, sigma2=2.5, seed=5)
    port = tclu.CompressiveBalancer(k=3, dim=4, sigma2=2.5, seed=5, device="cpu")
    assert port.m_ == ref.m_ == 120
    port.freqs = convert.operator_from_numpy(np.asarray(ref.freqs.w), device="cpu")
    for i in range(0, pts.shape[0], 150):
        ref.update(jnp.asarray(pts[i:i + 150]))
        port.update(pts[i:i + 150])
    _close_state(port.state, ref.state, "balancer")
    assert port._seen == ref._seen == pts.shape[0]
    np.testing.assert_array_equal(port._reservoir, ref._reservoir)


def test_balancer_recovers_planted_imbalance():
    """The reference's TestBalancer on the port: CKM from the sketch finds
    the domain masses, and the balancer inverts them."""
    pts = _planted(0)
    bal = tclu.CompressiveBalancer(k=3, dim=4, seed=5, device="cpu")
    for i in range(0, pts.shape[0], 500):
        bal.update(torch.from_numpy(pts[i:i + 500]))
    res = bal.cluster()
    alpha = np.sort(res.weights.numpy())[::-1]
    np.testing.assert_allclose(alpha, [0.6, 0.3, 0.1], atol=0.08)
    w = bal.balanced_weights(res)
    assert abs(float(w.sum()) - 1.0) < 1e-9
    assert np.argmin(w) == np.argmax(res.weights.numpy())
    labels = bal.assign_clusters(pts[:10], res)
    assert labels.dtype == torch.int64 and labels.shape == (10,)


def test_balancer_merge_adds_states():
    pts = _planted(2)[::10]
    a, b, both = (tclu.CompressiveBalancer(k=3, dim=4, sigma2=1.0, device="cpu")
                  for _ in range(3))
    a.update(pts[:100])
    b.update(pts[100:])
    both.update(pts)
    a.merge(b)
    for x, y in zip(a.state, both.state, strict=True):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dim,m,freq_op", [
    pytest.param(64, None, None, id="None"),
    pytest.param(64, None, "structured", id="structured"),
    pytest.param(4100, 8192, None, id="wide"),
])
def test_monitor_sketch_matches_the_reference(dim, m, freq_op):
    """dim 64: the default (dense below 512) and the structured operator;
    dim 4100 (the default, structured): one 8192-wide block, the width that
    the CUDA kernel takes since d_model > 2048 reaches it; each operator
    carried from the reference's; three batches of four pooled rows."""
    ref = jmon.ActivationMonitor(dim=dim, k=2, m=m, freq_op=freq_op)
    port = tmon.ActivationMonitor(dim=dim, k=2, m=m, freq_op=freq_op, device="cpu")
    assert port.freq_op == ref.freq_op and port.m_ == ref.m_ == (m or 8 * dim)
    if ref.freq_op == "dense":
        port.freqs = convert.operator_from_numpy(np.asarray(ref.freqs.w), device="cpu")
    else:
        op = ref.freqs
        port.freqs = convert.structured_operator_from_numpy(
            np.asarray(op.diags), np.asarray(op.radii), np.asarray(op.rho), op.n, op.m, "cpu")
    rng = np.random.default_rng(3)
    js, ts = ref.init_state(), port.init_state()
    for _ in range(3):
        pooled = rng.standard_normal((4, dim)).astype(np.float32)
        js = ref.update(js, jnp.asarray(pooled))
        ts = port.update(ts, torch.from_numpy(pooled).requires_grad_(True))
    _close_state(ts, js, f"monitor {ref.freq_op}")
    res = port.decode(ts)
    assert tuple(res.centroids.shape) == (2, dim) and bool(torch.isfinite(res.centroids).all())
    assert abs(float(res.weights.sum()) - 1.0) < 1e-4
    # sketch_drift on the same state and decoded model, both packages.
    jres = jckm.CKMResult(jnp.asarray(res.centroids.numpy()), jnp.asarray(res.weights.numpy()),
                          None, None, ref.freqs, None, None)
    want = ref.sketch_drift(js, jres)
    assert abs(port.sketch_drift(ts, res) - want) <= 1e-5 * max(abs(want), 1.0)


def test_monitor_picks_structured_at_512():
    assert tmon.ActivationMonitor(dim=512, k=2, device="cpu").freq_op == "structured"
    assert tmon.ActivationMonitor(dim=511, k=2, device="cpu").freq_op == "dense"


def test_monitor_drift_is_the_reference_drift():
    """``drift`` (greedy matched displacement, mass-weighted) exactly."""
    rng = np.random.default_rng(9)
    a, b = rng.standard_normal((2, 5, 7)).astype(np.float32)
    wa = rng.dirichlet(np.ones(5)).astype(np.float32)

    def result(mod, c, w):
        return mod.CKMResult(c, w, None, None, None, None, None)

    want = jmon.ActivationMonitor.drift(result(jckm, jnp.asarray(a), jnp.asarray(wa)),
                                        result(jckm, jnp.asarray(b), None))
    got = tmon.ActivationMonitor.drift(result(tckm, torch.from_numpy(a), torch.from_numpy(wa)),
                                       result(tckm, torch.from_numpy(b), None))
    assert got == want
    assert tmon.ActivationMonitor.drift(result(tckm, torch.from_numpy(a), torch.from_numpy(wa)),
                                        result(tckm, torch.from_numpy(a), None)) == 0.0
