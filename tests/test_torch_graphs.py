"""The decoder loops that run as CUDA graphs on the card (``core.graphs``),
on the CPU.

- The step bodies, run eagerly, give the bits of the loops they replaced:
  projected Adam and NNLS are held against verbatim copies of the earlier
  eager loops, whose bias corrections and momentum were host scalars.
- A rehearsal of the graph path: ``graphs._graphable`` is forced true and
  ``graphs._record`` replaced by a stand-in whose "capture" and "replays"
  run the captured steps eagerly (a replay with the launch counts held, as
  a real replay leaves them).  Each decoder, with its kernels' wrappers
  replaced by counted calls of their plain versions, then gives the eager
  decode's bits and launch counts, and captures each body once per fit.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import ckm, graphs
from repro_torch.core import nnls as tnnls
from repro_torch.core.decoders import common as tcommon
from repro_torch.kernels import amp_denoise as kamp
from repro_torch.kernels import ops as kops
from repro_torch.kernels import sketch_shift as kshift

pytestmark = pytest.mark.torch_port


def _old_adam(loss_fn, params, steps, lr, project):
    """``core.decoders.common.adam`` as it ran before the graphs."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    one = np.float32(1.0)
    p = tuple(t.detach() for t in params)
    m = tuple(torch.zeros_like(t) for t in p)
    v = tuple(torch.zeros_like(t) for t in p)
    for i in range(1, steps + 1):
        leaves = tuple(q.detach().requires_grad_(True) for q in p)
        grads = torch.autograd.grad(loss_fn(leaves), leaves)
        with torch.no_grad():
            t = np.float32(i + 1)
            mhat_scale = float(one / (one - np.float32(b1) ** t))
            vhat_scale = float(one / (one - np.float32(b2) ** t))
            m = tuple(b1 * m_ + (1 - b1) * g for m_, g in zip(m, grads))
            v = tuple(b2 * v_ + (1 - b2) * g * g for v_, g in zip(v, grads))
            p = tuple(
                p_ - lr * (m_ * mhat_scale) / (torch.sqrt(v_ * vhat_scale) + eps)
                for p_, m_, v_ in zip(p, m, v)
            )
            p = project(p)
    return tuple(t.detach() for t in p)


def _old_nnls(a, z, mask, iters=200, power_iters=16):
    """``core.nnls.nnls`` as it ran before the graphs."""
    import math

    maskf = mask.to(a.dtype)
    a = torch.where(maskf[None, :] > 0, a, torch.zeros((), dtype=a.dtype, device=a.device))
    gram = a.T @ a
    atz = a.T @ z
    v = torch.ones((a.shape[1],), dtype=a.dtype, device=a.device) / math.sqrt(a.shape[1])
    for _ in range(power_iters):
        v = gram @ v
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30)
    lam = v @ (gram @ v)
    step = torch.where(
        lam > 1e-12, 1.0 / (2.0 * torch.clamp(lam, min=1e-12)), torch.zeros_like(lam)
    )
    beta = torch.zeros((a.shape[1],), dtype=a.dtype, device=a.device)
    y = beta
    t = np.float32(1.0)
    for _ in range(iters):
        grad = 2.0 * (gram @ y - atz)
        beta_next = torch.clamp(y - step * grad, min=0.0) * maskf
        t_next = np.float32(0.5) * (np.float32(1.0) + np.sqrt(np.float32(1.0) + np.float32(4.0) * t * t))
        y = beta_next + float((t - np.float32(1.0)) / t_next) * (beta_next - beta)
        beta, t = beta_next, t_next
    return beta


def _problem(seed, n=3, m=40, k=4):
    rng = np.random.default_rng(seed)
    w = convert.operator_from_numpy(rng.standard_normal((n, m)).astype(np.float32), "cpu")
    z = torch.from_numpy(rng.standard_normal(2 * m).astype(np.float32))
    lo = torch.from_numpy(-rng.uniform(1, 2, n).astype(np.float32))
    span = torch.from_numpy(rng.uniform(2, 4, n).astype(np.float32))
    s = torch.from_numpy(rng.uniform(size=(k, n)).astype(np.float32))
    alpha = torch.from_numpy(rng.uniform(size=k).astype(np.float32))
    return w, z, lo, span, s, alpha


@pytest.mark.parametrize("seed,steps", [(0, 1), (1, 37), (2, 200)])
def test_adam_gives_the_bits_of_the_old_loop(seed, steps):
    w, z, lo, span, s, alpha = _problem(seed)
    got = tcommon.adam(tcommon.polish_loss, (s, alpha), steps, 0.02, tcommon.clip_joint,
                       (z, lo, span), w)

    def closure_loss(p):
        return tcommon.polish_loss(p, w, z, lo, span)

    want = _old_adam(closure_loss, (s, alpha), steps, 0.02, tcommon.clip_joint)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


@pytest.mark.parametrize("mask", [[1, 1, 1, 1, 1], [1, 0, 1, 1, 0], [0, 0, 0, 0, 0]])
@pytest.mark.parametrize("iters", [1, 40, 150])
def test_nnls_gives_the_bits_of_the_old_loop(mask, iters):
    rng = np.random.default_rng(iters)
    a = torch.from_numpy(rng.standard_normal((30, 5)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal(30).astype(np.float32))
    mask = torch.tensor(mask, dtype=torch.bool)
    assert torch.equal(tnnls.nnls(a, z, mask, iters=iters), _old_nnls(a, z, mask, iters=iters))


def test_unroll_is_the_largest_divisor_under_the_cap():
    assert [graphs.unroll_for(s, 10) for s in (1, 7, 20, 75, 150, 300, 1000)] == [
        1, 7, 10, 5, 10, 10, 10]
    assert graphs.unroll_for(75, 25) == 25 and graphs.unroll_for(150, 150) == 150


class _StandInGraph:
    """What ``_record`` returns in the rehearsal: the "capture" runs the
    captured steps once (as the real capture enqueues them), a replay runs
    them again with the launch counts held (a real replay does not call the
    wrappers; the loop adds the counts the capture recorded)."""

    def __init__(self, run):
        self.run = run
        run()

    def replay(self):
        before = graphs._counts()
        self.run()
        graphs._set_counts(before)


@pytest.fixture
def rehearsal(monkeypatch):
    """Graphs on the CPU (when ``on``), and the decoder kernels' wrappers
    as counted plain calls; called after the sketch is made, whose kernels
    are left alone."""

    def counted(mod, fn):
        def call(*args):
            mod.LAUNCHES += 1
            return fn(*args)
        return call

    monkeypatch.setattr(kshift, "sketch_shift_sums",
                        counted(kshift, kshift.sketch_shift_sums_plain))
    monkeypatch.setattr(kamp, "amp_denoise", counted(kamp, kamp.amp_denoise_plain))
    graphs.clear()
    yield lambda on: (
        monkeypatch.setattr(kops, "_on_cuda", lambda x: True),
        monkeypatch.setattr(graphs, "_graphable", lambda t: on),
        monkeypatch.setattr(graphs, "_record", lambda run, dev: _StandInGraph(run)),
    )
    graphs.clear()


_SMALL = dict(atom_steps=20, joint_steps=12, nnls_iters=30, final_steps=30,
              shift_steps=15, shift_polish_steps=20, amp_iters=12, amp_polish_steps=20)


@pytest.mark.parametrize("decoder,freq_op", [
    ("clompr", "dense"), ("clompr", "structured"), ("sketch_shift", "dense"), ("amp", "dense"),
])
def test_rehearsed_graphs_give_the_eager_bits_and_counts(rehearsal, decoder, freq_op):
    rng = np.random.default_rng(3)
    means = rng.uniform(-4, 4, (3, 2))
    x = (means[rng.integers(0, 3, 3000)] + 0.5 * rng.standard_normal((3000, 2)))
    x = torch.from_numpy(x.astype(np.float32))
    cfg = ckm.CKMConfig(k=3, m=60, decoder=decoder, freq_op=freq_op, **_SMALL)
    z, op, _, (lo, hi) = ckm.compute_sketch(0, x, cfg, device="cpu")

    def decode(on, eager):
        rehearsal(on)
        kshift.LAUNCHES = kamp.LAUNCHES = 0
        graphs.CAPTURES = graphs.REPLAYS = 0
        out = ckm.decode_sketch(1, z, op, lo, hi, cfg, device="cpu", eager=eager)
        return out, (kshift.LAUNCHES, kamp.LAUNCHES), (graphs.CAPTURES, graphs.REPLAYS)

    want, counts, _ = decode(False, False)
    switched, switched_counts, none = decode(True, True)
    got, got_counts, (captures, replays) = decode(True, False)
    again, again_counts, (recaptures, _) = decode(True, False)
    assert none == (0, 0)  # eager=True takes no graph
    for out, n in ((switched, switched_counts), (got, got_counts), (again, again_counts)):
        assert all(torch.equal(a, b) for a, b in zip(out, want))
        assert n == counts
    assert captures >= 3 and replays > 0
    assert recaptures == 0  # one capture per body per operator
    if decoder == "sketch_shift":
        assert counts[0] == 3 * (cfg.shift_steps + 1)
    if decoder == "amp":
        assert counts[1] == cfg.amp_iters


class _InertGraph:
    """A stand-in that, like a real graph, keeps no reference to what it
    captured (its replays do nothing)."""

    def replay(self):
        pass


def test_graphs_go_with_their_operator(rehearsal, monkeypatch):
    rehearsal(True)
    monkeypatch.setattr(graphs, "_record", lambda run, dev: _InertGraph())
    w, z, lo, span, s, alpha = _problem(4)
    tcommon.adam(tcommon.polish_loss, (s, alpha), 20, 0.02, tcommon.clip_joint,
                 (z, lo, span), w)
    assert id(w) in graphs._BY_OP and len(graphs._BY_OP[id(w)]) == 1
    key = id(w)
    del w
    gc.collect()
    assert key not in graphs._BY_OP


def test_decoders_take_the_eager_switch_through_the_registry():
    from repro_torch.core import decoders as tdec

    cfg = ckm.CKMConfig(k=2, m=30, **_SMALL)
    for name in tdec.available_decoders():
        cfg_d = dataclasses.replace(cfg, decoder=name)
        rng = np.random.default_rng(5)
        x = torch.from_numpy(rng.standard_normal((500, 2)).astype(np.float32))
        z, op, _, (lo, hi) = ckm.compute_sketch(0, x, cfg_d, device="cpu")
        a = tdec.get_decoder(name)(torch.Generator().manual_seed(0), z, op, lo, hi, cfg_d,
                                   eager=True)
        b = tdec.get_decoder(name)(torch.Generator().manual_seed(0), z, op, lo, hi, cfg_d)
        assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("decoder", ["clompr", "sketch_shift", "amp"])
def test_rehearsed_graphs_give_the_eager_traces(rehearsal, decoder):
    """With tracing on, the graphed decode (rehearsed) gives the eager
    decode's series bitwise, and the untraced decode's centroids: the amp
    series are written inside the graphed GAMP body at the step index it
    reads from its schedule."""
    rng = np.random.default_rng(3)
    means = rng.uniform(-4, 4, (3, 2))
    x = (means[rng.integers(0, 3, 3000)] + 0.5 * rng.standard_normal((3000, 2)))
    x = torch.from_numpy(x.astype(np.float32))
    cfg = ckm.CKMConfig(k=3, m=60, decoder=decoder, **_SMALL)
    z, op, _, (lo, hi) = ckm.compute_sketch(0, x, cfg, device="cpu")
    traced = dataclasses.replace(cfg, trace_convergence=True)
    from repro_torch.core import decoders as tdec

    def decode(c, on, eager):
        rehearsal(on)
        graphs.REPLAYS = 0
        out = tdec.get_decoder(decoder)(torch.Generator().manual_seed(1), z, op, lo, hi, c,
                                        eager=eager)
        return out, graphs.REPLAYS

    untraced, _ = decode(cfg, False, False)
    eager, _ = decode(traced, True, True)
    graphed, replays = decode(traced, True, False)
    assert all(torch.equal(a, b) for a, b in zip(untraced, eager[:3]))
    assert all(torch.equal(a, b) for a, b in zip(eager[:3], graphed[:3]))
    assert sorted(eager[3]) == sorted(graphed[3])
    for name in eager[3]:
        assert torch.equal(eager[3][name], graphed[3][name]), name
        assert bool((eager[3][name] > 0).all()), name
    assert replays > 0
