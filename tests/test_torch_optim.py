"""The port's optimizers (``repro_torch.optim.optimizers``) against the
reference's, on shared numpy parameters and gradients: AdamW, its int8-state
twin, Adafactor and SGD over three updates, the warmup-cosine schedule, the
global-norm clip, the int8 block quantiser, the chunked leaf update, and the
reference's own ``TestOptimizers`` checks run on the port.

Bars: 1e-6 (absolute and relative) for every float32 parameter and state
entry: the arithmetic is the reference's in its order, so only the order of
the clip's and Adafactor's reductions differs.  The int8 payloads of
``adamw8`` are equal except where a value sits on a rounding boundary: there
they differ by one step, and the port's own unrounded value is within 1e-3
of a half step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_map

from repro.optim import optimizers as jopt
from repro_torch.optim import optimizers as topt

pytestmark = pytest.mark.torch_port

NAMES = ("adamw", "adamw8", "adafactor", "sgd")
TOL = 1e-6
# Leaves of ranks 0-3; the 3-d one and the 40 x 96 matrix also exercise
# Adafactor's factored rows and columns, the 33-vector the int8 padding.
SHAPES = {"w": (40, 96), "b": (33,), "stack": (3, 8, 16), "s": ()}
CFG = dict(lr=0.05, warmup=2, total_steps=10, weight_decay=0.01, clip_norm=1.0)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)), tree)


def _from_reference(js, jp):
    """The reference's AdamW8 state and params as the port's (copies)."""
    ts = {key: {k: topt.Q8(torch.from_numpy(np.array(q.q)), torch.from_numpy(np.array(q.scale)))
                for k, q in js[key].items()} for key in ("m", "v")}
    ts["count"] = torch.tensor(int(js["count"]), dtype=torch.int32)
    return ts, _t(jax.tree.map(np.asarray, jp))


def _run_both(name, steps=3):
    """Three updates of both packages from shared params and grads; the
    port's (params, state, previous states, metrics) and the reference's.
    AdamW8 starts each update from the reference's state and params: a
    payload that rounds the other way on a boundary changes the next
    update's step at that entry (by up to one int8 step of the state), so
    the updates are compared one at a time."""
    jo = jopt.make_optimizer(jopt.OptConfig(name=name, **CFG))
    to = topt.make_optimizer(topt.OptConfig(name=name, **CFG))
    p0 = _tree(0)
    jp, tp = jax.tree.map(jnp.asarray, p0), _t(p0)
    js, ts = jo.init(jp), to.init(tp)
    prev, metrics = [], []
    for i in range(steps):
        g = _tree(10 + i, scale=0.3 if i else 3.0)  # the first step is clipped
        if name == "adamw8":
            ts, tp = _from_reference(js, jp)
        prev.append(tree_map(torch.clone, ts))
        jp, js, jm = jo.update(jax.tree.map(jnp.asarray, g), js, jp, jnp.asarray(i))
        tp, ts, tm = to.update(_t(g), ts, tp, torch.tensor(i))
        metrics.append((jm, tm, g))
    return (tp, ts, prev, metrics), (jp, js)


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("name", NAMES)
def test_three_updates_match_the_reference(name):
    (tp, ts, prev, metrics), (jp, js) = _run_both(name)
    for k in SHAPES:
        _close(tp[k], jp[k], f"{name} params[{k}]")
    assert int(ts["count"]) == int(js["count"]) == 3 and ts["count"].dtype == torch.int32
    for jm, tm, _ in metrics:
        _close(tm["lr"], jm["lr"], f"{name} lr")
        _close(tm["gnorm"], jm["gnorm"], f"{name} gnorm")
    if name == "adamw":
        for key in ("m", "v"):
            for k in SHAPES:
                _close(ts[key][k], js[key][k], f"adamw {key}[{k}]")
    elif name == "adafactor":
        for k in SHAPES:
            assert sorted(ts["stats"][k]) == sorted(js["stats"][k])
            for f in ts["stats"][k]:
                _close(ts["stats"][k][f], js["stats"][k][f], f"adafactor {k}.{f}")
    elif name == "adamw8":
        _check_q8_states(ts, js, prev, metrics)


def _check_q8_states(ts, js, prev, metrics):
    """The scales to the float bar; the int8 payloads equal except on
    rounding boundaries, judged by the port's own unrounded values of the
    last update (recomputed in float64 from its previous state)."""
    cfg = topt.OptConfig(name="adamw8", **CFG)
    _, tm, g_last = metrics[-1]
    clip = min(1.0, cfg.clip_norm / max(float(tm["gnorm"]), 1e-9))
    for key, sqrt_domain, beta in (("m", False, cfg.b1), ("v", True, cfg.b2)):
        for k, shape in SHAPES.items():
            got, want = ts[key][k], js[key][k]
            _close(got.scale, want.scale, f"adamw8 {key}[{k}].scale")
            q, q_ref = got.q.numpy().astype(np.int32), np.asarray(want.q).astype(np.int32)
            differ = q != q_ref
            if not differ.any():
                continue
            assert np.abs(q - q_ref)[differ].max() == 1, (key, k)
            old = topt._dequantize(prev[-1][key][k], shape, sqrt_domain).numpy().astype(np.float64)
            gc = g_last[k].astype(np.float64) * clip
            new = beta * old + (1 - beta) * (gc if key == "m" else gc * gc)
            flat = np.sqrt(np.maximum(new, 0)) if sqrt_domain else new
            flat = np.pad(flat.reshape(-1), (0, q.size - flat.size)).reshape(q.shape)
            u = flat / np.maximum(got.scale.numpy()[:, None], 1e-12) * 127.0
            assert np.all(np.abs(np.abs(u - np.floor(u)) - 0.5)[differ] < 1e-3), (key, k)


@pytest.mark.parametrize("step", [0, 1, 2, 5, 10, 12])
def test_warmup_cosine_matches_the_reference(step):
    """Steps 0 and the warm-up's middle, the warm-up's end, the cosine's
    middle, the total and past it."""
    want = jopt.warmup_cosine(0.3, 2, 10)(jnp.asarray(step))
    got = topt.warmup_cosine(0.3, 2, 10)(torch.tensor(step))
    assert got.dtype == torch.float32
    _close(got, want, f"lr({step})")


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    """A clip that scales (0.5) and one that does not (1e3); the port scales
    its gradients in place."""
    g = _tree(3)
    jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tg = _t(g)
    out, tn = topt.clip_by_global_norm(tg, max_norm)
    assert out is tg
    _close(tn, jn, "gnorm")
    for k in SHAPES:
        _close(tg[k], jg[k], f"clipped {k}")


@pytest.mark.parametrize("sqrt_domain", [False, True])
def test_quantize_matches_the_reference(sqrt_domain):
    """Blocks of 128 with a ragged tail, half-to-even rounding: the same
    payload and scales, and the same dequantised values."""
    x = np.random.default_rng(4).standard_normal(3 * 128 + 45).astype(np.float32)
    if sqrt_domain:
        x = x * x
    jq = jopt._quantize(jnp.asarray(x), sqrt_domain)
    tq = topt._quantize(torch.from_numpy(x), sqrt_domain)
    assert tq.q.dtype == torch.int8 and tuple(tq.q.shape) == (4, 128)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    _close(tq.scale, jq.scale, "scale")
    _close(topt._dequantize(tq, x.shape, sqrt_domain),
           jopt._dequantize(jq, x.shape, sqrt_domain), "dequantized")


def test_round_half_to_even():
    """``jnp.round`` and ``torch.round`` both round halves to even."""
    v = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(v)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(v))))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_chunked_leaf_update_is_the_whole_leaf_update(name, monkeypatch):
    """A leaf over the chunk bound is updated one slice of its leading axis at
    a time, with the bits of the whole-leaf update."""
    whole = _run_both(name, steps=2)[0]
    monkeypatch.setattr(topt, "_CHUNK_UPDATE_BYTES", 64)
    chunked = _run_both(name, steps=2)[0]
    for a, b in zip(tree_flatten(whole[:2])[0], tree_flatten(chunked[:2])[0]):
        assert torch.equal(a, b)


# The reference's TestOptimizers, on the port.


def _quadratic_converges(name):
    cfg = topt.OptConfig(name=name, lr=0.1, warmup=5, total_steps=300, weight_decay=0.0)
    opt = topt.make_optimizer(cfg)
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(5.0)}
    state = opt.init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    for step in range(300):
        grads = {k: 2 * v.clone() for k, v in params.items()}  # d loss / dp
        params, state, _ = opt.update(grads, state, params, torch.tensor(step))
    assert float(loss(params)) < 1e-2, (name, float(loss(params)))


@pytest.mark.parametrize("name", NAMES)
def test_converges_on_quadratic(name):
    _quadratic_converges(name)


def test_adamw8_tracks_adamw():
    """int8 state quantisation stays close to exact Adam trajectories."""
    rng = np.random.default_rng(0)
    w0 = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    target = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))

    def run(name):
        opt = topt.make_optimizer(topt.OptConfig(name=name, lr=0.05, warmup=1,
                                                 total_steps=100, weight_decay=0.0))
        p = {"w": w0.clone()}
        s = opt.init(p)
        for i in range(60):
            g = {"w": 2 * (p["w"] - target) / p["w"].numel()}
            p, s, _ = opt.update(g, s, p, torch.tensor(i))
        return p["w"]

    exact, quant = run("adamw"), run("adamw8")
    rel = float(torch.linalg.vector_norm(exact - quant) / torch.linalg.vector_norm(exact))
    assert rel < 0.10, rel


def test_adafactor_memory_factored():
    opt = topt.make_optimizer(topt.OptConfig(name="adafactor"))
    st = opt.init({"w": torch.zeros((512, 256))})
    leaves = tree_flatten(st["stats"])[0]
    assert sum(leaf.numel() for leaf in leaves) == 512 + 256
    with pytest.raises(ValueError):
        topt.make_optimizer(topt.OptConfig(name="lion"))
