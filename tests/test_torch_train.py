"""The port's training half (dense family, one card) against the reference,
in float32 on the CPU at ``get_smoke_config("llama3.2-1b")``: ``lm_loss``
and its gradients under the three ``remat`` modes, ``chunked_ce_loss`` with
padding and ignored labels, the bf16 softmax's backward, two train steps
from one state carried by ``convert.train_state_from_numpy``, the state's
shapes, ``SyntheticLM``'s batches, and the train loop's restart and
preemption contract (the reference's own loop test fails on this JAX, so
the port is held to the invariant it states).

S = 64 is two whole ``q_block``s of 32: the reference's padded q tail takes
wrong positions (ROADMAP Queue 3), and a padded S would hold the port to it.

Bars: the loss to 1e-5 relative; each gradient leaf within 1e-4 of its
largest reference magnitude (the engine's cross-backend bar); the bf16
softmax and the bf16 score path to two bf16 ulps (2^-7) of the largest
magnitude, since a last-bit difference of a float32 sum can flip one bf16
rounding; the restart to the reference test's rtol of 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_map

from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.models import layers as JL
from repro.models import transformer as jtfm
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models import transformer as ttfm
from repro_torch.optim import optimizers as topt
from repro_torch.train import train_loop as tloop

pytestmark = pytest.mark.torch_port

ARCH = "llama3.2-1b"
B, S = 2, 64
LOSS_RTOL, GRAD_TOL, BF16_TOL = 1e-5, 1e-4, 2.0**-7
F32 = torch.float32
_CACHE: dict = {}


def _setup():
    """(reference cfg, port cfg, reference params), cached."""
    if "setup" not in _CACHE:
        jcfg, tcfg = jbase.get_smoke_config(ARCH), tbase.get_smoke_config(ARCH)
        _CACHE["setup"] = jcfg, tcfg, jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    return _CACHE["setup"]


def _port_params(jparams, tcfg):
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    for p in tree_flatten(params)[0]:
        p.requires_grad_(True)
    return params


def _batch(seed, vocab, s=S):
    tok = np.random.default_rng(seed).integers(0, vocab, (B, s + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _ref_value_and_grad(remat, cfg=None, dtype=jnp.float32):
    jcfg, _, jparams = _setup()
    cfg = cfg or jcfg
    batch = _jbatch(_batch(1, cfg.vocab_size))
    fn = jax.jit(jax.value_and_grad(
        lambda p: jtfm.lm_loss(p, cfg, batch, dtype=dtype, remat=remat)))
    return fn(jparams)


def _port_value_and_grad(remat, cfg=None):
    _, tcfg, jparams = _setup()
    cfg = cfg or tcfg
    params = _port_params(jparams, cfg)
    loss, grads = ttrain.loss_and_grads(
        lambda p: ttfm.lm_loss(p, cfg, _tbatch(_batch(1, cfg.vocab_size)), dtype=F32,
                               remat=remat), params)
    return loss.detach(), grads


def _grad_errors(grads, jgrads, tcfg):
    """Each leaf's max |port - reference| over its max |reference|."""
    want = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jgrads), tcfg, "cpu")
    out = []
    for got, ref in zip(tree_flatten(grads)[0], tree_flatten(want)[0], strict=True):
        assert got.shape == ref.shape
        out.append(float(torch.amax(torch.abs(got - ref))) / max(float(torch.amax(torch.abs(ref))),
                                                                 1e-30))
    return out


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_lm_loss_and_grads_match_the_reference(remat):
    _, tcfg, _ = _setup()
    jloss, jgrads = _ref_value_and_grad(remat)
    loss, grads = _port_value_and_grad(remat)
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    errs = _grad_errors(grads, jgrads, tcfg)
    assert max(errs) <= GRAD_TOL, errs


def test_remat_modes_agree_bitwise():
    """``full`` recomputes each group and ``dots`` saves its products: the
    same loss and gradients, bit for bit, as without remat."""
    base_loss, base = _port_value_and_grad("none")
    for remat in ("full", "dots"):
        loss, grads = _port_value_and_grad(remat)
        assert torch.equal(loss, base_loss), remat
        for a, b in zip(tree_flatten(grads)[0], tree_flatten(base)[0], strict=True):
            assert torch.equal(a, b), remat


def test_remat_recomputes_what_it_does_not_save():
    """Counted in the backward: ``full`` recomputes each group's products
    (more ``mm`` than without remat), ``dots`` keeps its ``mm`` outputs (the
    same count) and recomputes the rest (the attention's ``bmm``)."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] += 1
            return func(*args, **(kwargs or {}))

    _, tcfg, jparams = _setup()
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    counts = {}
    for remat in ("none", "dots", "full"):
        params = _port_params(jparams, tcfg)
        x, _ = ttfm.forward(params, tcfg, _tbatch(_batch(1, tcfg.vocab_size)), dtype=F32,
                            remat=remat)
        with Count() as c:
            torch.autograd.grad(x.sum(), tree_flatten(params)[0])
        counts[remat] = (c.ops[mm], c.ops[bmm])
    assert counts["dots"][0] == counts["none"][0] < counts["full"][0], counts
    assert counts["none"][1] < counts["dots"][1] == counts["full"][1], counts
    with pytest.raises(ValueError, match="remat"):
        ttfm.forward(_port_params(jparams, tcfg), tcfg, _tbatch(_batch(1, 256)), remat="some")


def test_chunked_ce_loss_pads_and_ignores_labels():
    """S = 40 in chunks of 16 (the last padded with -100), labels -100 and -1
    ignored: the loss and its gradients (hidden states and the tied table)
    against the reference's; all labels ignored gives 0, not 0/0."""
    jcfg, tcfg, jparams = _setup()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 40, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (B, 40)).astype(np.int32)
    labels[0, :7] = -100
    labels[1, 30:] = -1

    def ref(p, xx):
        return jtfm.chunked_ce_loss(p, jcfg, xx, jnp.asarray(labels), chunk=16)

    jloss, (jg_p, jg_x) = jax.value_and_grad(ref, argnums=(0, 1))(jparams, jnp.asarray(x))
    params = _port_params(jparams, tcfg)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = ttfm.chunked_ce_loss(params, tcfg, xt, torch.from_numpy(labels), chunk=16)
    g_table, g_x = torch.autograd.grad(loss, [params["embed"]["table"], xt])
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    for got, want in ((g_table, jg_p["embed"]["table"]), (g_x, jg_x)):
        want = np.array(want)
        assert float(torch.amax(torch.abs(got - torch.from_numpy(want)))) <= GRAD_TOL * float(
            np.max(np.abs(want)))
    none = ttfm.chunked_ce_loss(params, tcfg, xt, torch.full((B, 40), -100, dtype=torch.int32))
    assert float(none.detach()) == 0.0


def test_chunked_ce_loss_keeps_one_chunk_of_logits():
    """Only each chunk's input is saved for the backward: no float32 logits
    (B, chunk, V) outlive their chunk."""
    jcfg, tcfg, jparams = _setup()
    params = _port_params(jparams, tcfg)
    x = torch.randn((B, 64, jcfg.d_model), generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ttfm.chunked_ce_loss(params, tcfg, x, torch.zeros((B, 64), dtype=torch.int32), chunk=16)
    assert not any(s and s[-1] == jcfg.vocab_size for s in shapes), shapes


def test_bf16_softmax_backward_matches_the_reference():
    """Forward within one bf16 ulp; the backward against the reference's
    ``_softmax_bf16_bwd`` on the port's probabilities and the same upstream
    gradient; only the bf16 probabilities are saved."""
    rng = np.random.default_rng(2)
    scores = (rng.standard_normal((2, 3, 5, 40)) * 4).astype(np.float32)
    g = rng.standard_normal((2, 3, 5, 40)).astype(np.float32)
    sb = torch.from_numpy(scores).to(torch.bfloat16).requires_grad_(True)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    p = TL._softmax_bf16(sb)
    assert p.dtype == torch.bfloat16
    saved = p.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].dtype == torch.bfloat16
    (grad,) = torch.autograd.grad(p, sb, gb)
    jp = JL._softmax_bf16(jnp.asarray(scores, jnp.bfloat16))
    np.testing.assert_allclose(p.detach().float().numpy(), np.asarray(jp, np.float32), rtol=0,
                               atol=2.0**-8)
    p_j = jnp.asarray(p.detach().float().numpy(), jnp.bfloat16)
    (want,) = JL._softmax_bf16_bwd(p_j, jnp.asarray(g, jnp.bfloat16))
    want = np.asarray(want, np.float32)
    err = float(np.max(np.abs(grad.float().numpy() - want)))
    assert grad.dtype == torch.bfloat16 and err <= BF16_TOL * float(np.max(np.abs(want))), err


def test_bf16_score_path_grads_match_the_reference():
    """``score_dtype="bf16"`` (no shipped config sets it): lm_loss's
    gradients through the bf16 scores and the custom backward, against the
    reference's, to the bf16 bar."""
    jcfg, tcfg, _ = _setup()
    jloss, jgrads = _ref_value_and_grad("none", dataclasses.replace(jcfg, score_dtype="bf16"))
    loss, grads = _port_value_and_grad("none", dataclasses.replace(tcfg, score_dtype="bf16"))
    assert abs(float(loss) - float(jloss)) <= BF16_TOL * abs(float(jloss))
    errs = _grad_errors(grads, jgrads, tcfg)
    assert max(errs) <= BF16_TOL, errs


def test_two_train_steps_match_the_reference():
    """The reference's ``build_train_step(..., mesh=None)`` and the port's,
    AdamW, remat "full", from one state: the losses, the clip norms and the
    learning rates agree, and so do the parameters wherever Adam's first
    moment is not tiny (its first steps are sign steps: where |m| is near 0
    the sign of a rounding error decides the step)."""
    jcfg, tcfg, jparams = _setup()
    opt_cfg = jopt.OptConfig()
    jo, to = jopt.make_optimizer(opt_cfg), topt.make_optimizer(topt.OptConfig())
    jstate = {"params": jparams, "opt": jo.init(jparams), "step": jnp.zeros((), jnp.int32)}
    tstate = convert.train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                            topt.OptConfig(), "cpu")
    p0 = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    jstep = jax.jit(jtrain.build_train_step(jcfg, jo, mesh=None, remat="full", dtype=jnp.float32))
    tstep = ttrain.build_train_step(tcfg, to, remat="full", dtype=F32)
    for i in range(2):
        batch = _batch(20 + i, jcfg.vocab_size)
        jstate, jm = jstep(jstate, _jbatch(batch))
        tstate, tm = tstep(tstate, _tbatch(batch))
        for k in ("loss", "gnorm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= LOSS_RTOL * abs(float(jm[k])), k
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    ref = {k: convert.lm_params_from_numpy(jax.tree.map(np.asarray, t), tcfg, "cpu")
           for k, t in (("params", jstate["params"]), ("m", jstate["opt"]["m"]))}
    counted = 0
    for p, m, w, wm, w0 in zip(*(tree_flatten(t)[0] for t in (
            tstate["params"], tstate["opt"]["m"], ref["params"], ref["m"], p0)), strict=True):
        big = torch.abs(wm) > 1e-2 * float(torch.amax(torch.abs(wm)))
        step_ref = w - w0
        err = float(torch.amax(torch.abs((p.detach() - w)[big])))
        assert err <= 1e-2 * float(torch.amax(torch.abs(step_ref))), err
        assert float(torch.amax(torch.abs(m - wm))) <= GRAD_TOL * float(torch.amax(torch.abs(wm)))
        counted += int(big.sum())
    assert counted > 0.5 * sum(t.numel() for t in tree_flatten(p0)[0])


def _shapes_by_path(tree):
    """{path: shape} of a tree of tensors or ``sds`` records."""
    from torch.utils._pytree import tree_flatten_with_path

    from repro_torch.launch.specs import sds

    leaves = tree_flatten_with_path(tree, is_leaf=lambda t: isinstance(t, sds))[0]
    return {str(path): tuple(leaf.shape) for path, leaf in leaves}


def test_state_shapes_mirror_the_reference():
    """The port's state on the meta device: every parameter and AdamW moment
    the reference's ``eval_shape`` gives (unstacked), an int32 count and
    step; AdamW8's int8 blocks; nothing allocated."""
    jcfg, tcfg, _ = _setup()
    for name in ("adamw", "adamw8"):
        jshapes = jtrain.state_shapes(jcfg, jopt.make_optimizer(jopt.OptConfig(name=name)))
        tshapes = ttrain.state_shapes(tcfg, topt.make_optimizer(topt.OptConfig(name=name)))
        assert tshapes["step"].dtype == torch.int32 and tshapes["opt"]["count"].dtype == torch.int32
        ref = convert.lm_params_from_numpy(
            jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jshapes["params"]), tcfg, "cpu")
        got = _shapes_by_path(tshapes["params"])
        assert got == _shapes_by_path(ref)
        if name == "adamw":
            assert _shapes_by_path(tshapes["opt"]["m"]) == got
        else:
            q = tshapes["opt"]["v"]["embed"]["table"]
            assert q.q.dtype == torch.int8 and tuple(q.q.shape) == (256 * 64 // 128, 128)
    assert ttrain.default_opt_config(tbase.get_config("llama3.2-1b")).name == "adamw"
    assert ttrain.default_opt_config(tbase.get_config("mistral-large-123b")).name == "adafactor"
    assert ttrain.default_param_dtype(tbase.get_config("llama3.2-1b")) == torch.float32


@pytest.mark.parametrize("name", ["adamw8", "adafactor"])
def test_opt_state_carried_from_the_reference(name):
    """After one reference update, the port's carried state gives the
    reference's next update to the float bar.  The exceptions are the
    layers' vectors (the RMSNorm scales), which the reference holds stacked
    as a (groups, d) matrix: AdamW8's blocks straddle its groups (their
    values are dequantised and quantised again, within one int8 step, and
    the next step within a tenth of the learning rate), and Adafactor
    factors it across groups (the port's vector keeps a full v, carried as
    the reference's estimate; the next steps differ, so they are not
    compared)."""
    from torch.utils._pytree import tree_flatten_with_path

    jcfg, tcfg, jparams = _setup()
    cfg = dict(lr=0.01, warmup=1, total_steps=10)
    jo = jopt.make_optimizer(jopt.OptConfig(name=name, **cfg))
    to_cfg = topt.OptConfig(name=name, **cfg)
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32) * 0.1,
                          jparams) for _ in range(2)]
    p1, s1, _ = jo.update(grads[0], jo.init(jparams), jparams, jnp.asarray(0))
    p2, s2, m2 = jo.update(grads[1], s1, p1, jnp.asarray(1))
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, p1), tcfg, "cpu")
    state = convert.opt_state_from_numpy(jax.tree.map(np.asarray, s1), to_cfg, params, "cpu")
    assert int(state["count"]) == 1
    ref_g0 = s1["m" if name == "adamw8" else "stats"]["groups"]["0"]
    got_g1 = state["m" if name == "adamw8" else "stats"]["groups"][1]["0"]
    if name == "adamw8":
        table = s1["v"]["embed"]["table"]
        assert np.array_equal(state["v"]["embed"]["table"].q.numpy(), np.asarray(table.q))
        ref_q = np.asarray(ref_g0["mixer"]["wq"].q)
        assert np.array_equal(got_g1["mixer"]["wq"].q.numpy(), ref_q[ref_q.shape[0] // 2:])
        norm = got_g1["norm1"]["scale"]
        ref_norm = np.asarray(jopt._dequantize(ref_g0["norm1"]["scale"], (2, 64)))
        one_step = float(norm.scale[0]) / 127
        assert np.max(np.abs(topt._dequantize(norm, (64,)).numpy() - ref_norm[1])) <= one_step
    else:
        np.testing.assert_array_equal(got_g1["mixer"]["wq"]["vr"].numpy(),
                                      np.asarray(ref_g0["mixer"]["wq"]["vr"])[1])
        vr, vc = (np.asarray(ref_g0["norm1"]["scale"][k]) for k in ("vr", "vc"))
        np.testing.assert_allclose(got_g1["norm1"]["scale"]["v"].numpy(),
                                   vr[1] * vc / np.mean(vr), rtol=1e-6)
    g = convert.lm_params_from_numpy(jax.tree.map(np.asarray, grads[1]), tcfg, "cpu")
    new, _, tm = topt.make_optimizer(to_cfg).update(g, state, params, torch.tensor(1))
    want = convert.lm_params_from_numpy(jax.tree.map(np.asarray, p2), tcfg, "cpu")
    lr = float(m2["lr"])
    for (path, got), ref in zip(tree_flatten_with_path(new)[0], tree_flatten(want)[0],
                                strict=True):
        stacked_vector = str(path[0]) == "['groups']" and got.ndim == 1
        err = float(torch.amax(torch.abs(got - ref)))
        if not stacked_vector:
            assert err <= 1e-6, (path, err)
        elif name == "adamw8":
            assert err <= 0.1 * lr, (path, err)


def test_synthetic_lm_batches_are_bitwise():
    """Tokens, labels, document embeddings and domains of several steps, and
    again after a re-weighting of the domains: the reference's bits."""
    jcfg, tcfg, _ = _setup()
    shape = tbase.ShapeConfig("t", 48, 3, "train")
    jshape = jbase.ShapeConfig("t", 48, 3, "train")
    data = dict(seed=4, n_domains=4)
    ref = jpipe.SyntheticLM(jcfg, jshape, jpipe.DataConfig(**data))
    port = tpipe.SyntheticLM(tcfg, shape, tpipe.DataConfig(**data), device="cpu")
    for weights in (None, [0.7, 0.1, 0.1, 0.1]):
        if weights is not None:
            ref.set_domain_weights(weights)
            port.set_domain_weights(weights)
        for step in (0, 1, 17):
            want, got = ref.batch(step), port.batch(step)
            assert sorted(got) == sorted(want)
            for k in want:
                w = np.asarray(want[k])
                assert got[k].numpy().dtype == w.dtype and np.array_equal(got[k].numpy(), w), k
    stream = list(port.embedding_stream(2, 2))
    assert np.array_equal(stream[1].numpy(), np.asarray(ref.batch(3)["_doc_embeds"]))
    first = next(port.iter(5))
    assert np.array_equal(first["tokens"].numpy(), np.asarray(ref.batch(5)["tokens"]))


def _loop(ckpt_dir, steps, **kw):
    _, tcfg, _ = _setup()
    loop = tloop.LoopConfig(steps=steps, ckpt_dir=str(ckpt_dir), ckpt_every=3, monitor_k=2,
                            log_every=2, dtype=F32, **kw)
    return tloop.run(tcfg, tbase.ShapeConfig("t", 32, 4, "train"), None, loop,
                     tpipe.DataConfig(seed=0), device="cpu")


def test_restart_matches_uninterrupted(tmp_path):
    """Six steps straight against three, a restart from the checkpoint and
    three more: the same final loss (the reference test's invariant), and
    the monitor decodes finite centroids."""
    straight = _loop(tmp_path / "a", 6)
    first = _loop(tmp_path / "b", 3)
    assert Checkpointer(tmp_path / "b").latest_step() == 3
    resumed = _loop(tmp_path / "b", 6)
    assert [h["step"] for h in resumed["history"]] == [4, 6]
    np.testing.assert_allclose(resumed["history"][-1]["loss"], straight["history"][-1]["loss"],
                               rtol=1e-4)
    assert first["history"][-1]["step"] == 3
    for out in (straight, resumed):
        cents = out["monitor_result"].centroids
        assert tuple(cents.shape) == (2, 64) and bool(torch.isfinite(cents).all())
    for a, b in zip(tree_flatten(straight["state"]["params"])[0],
                    tree_flatten(resumed["state"]["params"])[0], strict=True):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-4, atol=1e-6)


def test_preempt_file_flushes_a_checkpoint_and_stops(tmp_path):
    """With the preemption file present the loop saves synchronously after
    its first step and stops; without it, a rerun resumes there."""
    flag = tmp_path / "preempt"
    flag.touch()
    out = _loop(tmp_path / "c", 6, preempt_file=str(flag))
    assert int(out["state"]["step"]) == 1 and out["history"] == []
    assert Checkpointer(tmp_path / "c").all_steps() == [1]
    flag.unlink()
    resumed = _loop(tmp_path / "c", 4, preempt_file=str(flag))
    assert int(resumed["state"]["step"]) == 4 and [h["step"] for h in resumed["history"]] == [2, 4]


# The loop's CLOMPR decodes at a thirtieth of their default depth, one
# restart: the wall-time test checks that the balancer's decodes are timed,
# not how good they are.
SHALLOW_DECODE = {"atom_steps": 10, "joint_steps": 5, "nnls_iters": 10,
                  "final_steps": 20, "atom_restarts": 1}


def test_loop_reports_its_wall_time_and_the_balancer_decodes(tmp_path, monkeypatch):
    """Each logged step carries the step function's time and the loop's
    wall time per step since the previous log point, which holds the
    balancer's decodes (one every ``balance_every`` steps, each timed).
    The loop's CLOMPR decodes run at SHALLOW_DECODE's depth in this test
    only."""
    from repro_torch.data import clustering as tclust

    decode = tclust.ckm_mod.decode_sketch
    depths = []

    def shallow(seed, z, freqs, lo, hi, cfg, **kw):
        depths.append(cfg.atom_steps)
        return decode(seed, z, freqs, lo, hi, dataclasses.replace(cfg, **SHALLOW_DECODE), **kw)

    monkeypatch.setattr(tclust.ckm_mod, "decode_sketch", shallow)
    out = _loop(tmp_path / "w", 4, balance_every=2)
    # The balancer's two decodes (and the activation monitor's last one).
    assert len(depths) >= 2 and all(d > SHALLOW_DECODE["atom_steps"] for d in depths)
    hist, decodes = out["history"], out["balance_s"]
    assert [h["step"] for h in hist] == [2, 4] and len(decodes) == 2
    assert all(t > 0 for t in decodes)
    for h, t in zip(hist, decodes, strict=True):
        assert h["step_ms"] > 0 and h["wall_ms"] * 2 >= h["step_ms"] + t * 1e3
    assert out["balance_weights"] is not None


def test_a_mesh_and_the_compressed_step_raise():
    _, tcfg, _ = _setup()
    opt = topt.make_optimizer(topt.OptConfig())
    for call in (
        lambda: ttrain.build_train_step(tcfg, opt, mesh=object()),
        lambda: ttrain.build_compressed_train_step(tcfg, opt, mesh=object()),
        lambda: tloop.run(tcfg, tbase.ShapeConfig("t", 32, 2, "train"), object(),
                          tloop.LoopConfig(steps=1)),
        lambda: ttfm.lm_loss({}, tcfg, {}, mesh=object()),
    ):
        with pytest.raises(NotImplementedError, match="item 22 \\(b\\), part 2"):
            call()


def test_cli_and_example_train_on_the_cpu(tmp_path, capsys):
    from repro_torch.examples import train_lm

    ttrain.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2", "--seq", "32",
                 "--device", "cpu"])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("step ")]
    assert len(lines) == 2 and all(np.isfinite(float(l.split()[-1])) for l in lines)
    out = train_lm.main(["--steps", "2", "--batch", "2", "--seq", "32", "--ckpt-dir",
                         str(tmp_path / "ex"), "--device", "cpu"])
    assert np.isfinite(out["history"][-1]["loss"])
    weights = out["monitor_result"].weights
    assert abs(float(weights.sum()) - 1.0) < 1e-4
