"""The port's training half for the nine configs other than llama3.2-1b
(``tests/test_torch_train.py`` holds that one), against the reference in
float32 on the CPU, each at its smoke config with the reference's parameters
carried across by ``convert.lm_params_from_numpy`` and one numpy batch fed
to both (``patches`` for internvl2, ``frames`` for whisper, as
``tests/test_archs.py::_batch`` builds them):

- ``lm_loss`` (the MoE families' aux term included) and its gradients, the
  port's under remat ``"none"``, ``"full"`` and ``"dots"``, against the
  reference's ``jax.value_and_grad`` (run once a family, without remat: the
  reference's remat changes which values XLA keeps, not the values, and
  tracing the reference takes most of this file's time, ~13 s a mode for
  jamba);
- the port's ``"full"`` and ``"dots"`` against its ``"none"``, bit for bit:
  this is what holds Mamba's chunked scan, sLSTM's time loop and the MoE's
  dispatch under recompute;
- one train step with the optimizer and parameter dtype the *published*
  config defaults to (Adafactor for jamba, mistral-large and kimi-k2, bf16
  parameters for kimi-k2, AdamW elsewhere), from the reference's state
  carried by ``convert.train_state_from_numpy``, against the reference's own
  step;
- ``train_loop.run`` for two steps with the monitor (K = 2) and the
  balancer on, and the restart invariant at jamba's smoke config, whose
  period holds Mamba, attention, dense and MoE layers;
- mLSTM's gradients where its gate's exponent overflows (ROADMAP Queue 3
  fault 6).

S = 32 text positions (internvl2: 24 after its 8 patches) is one whole
``q_block``: the reference's padded q tail takes wrong positions (ROADMAP
Queue 3), and a padded S would hold the port to it.

Bars (``tests/test_torch_train.py``'s): the loss to 1e-5 relative; each
gradient leaf, and each parameter after the step, within 1e-4 of its largest
reference magnitude; what kimi-k2's bf16 parameters give (the parameters
after the step, the gradients' norm, Adafactor's statistics) within two bf16
ulps (2^-7) of its largest magnitude."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import keystr, tree_flatten, tree_flatten_with_path

from repro.configs import base as jbase
from repro.launch import train as jtrain
from repro.models import transformer as jtfm
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttfm
from repro_torch.optim import optimizers as topt
from repro_torch.train import train_loop as tloop

pytestmark = pytest.mark.torch_port

ARCHS = tuple(a for a in jbase.ARCHS if a != "llama3.2-1b")
B, S = 2, 32
LOSS_RTOL, GRAD_TOL, BF16_TOL = 1e-5, 1e-4, 2.0**-7
REMATS = ("none", "full", "dots")
F32 = torch.float32


@dataclasses.dataclass
class Setup:
    arch: str
    jcfg: jbase.ModelConfig
    tcfg: tbase.ModelConfig
    jparams: dict
    batch: dict  # numpy
    ref: tuple  # the reference's (loss, grads)
    port: dict = dataclasses.field(default_factory=dict)  # remat -> the port's (loss, grads)

    def port_params(self):
        params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, self.jparams), self.tcfg,
                                              "cpu")
        for p in tree_flatten(params)[0]:
            p.requires_grad_(True)
        return params

    def tbatch(self):
        return {k: torch.from_numpy(v.copy()) for k, v in self.batch.items()}


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    s_text = S - (cfg.frontend_len if cfg.frontend == "vision" else 0)
    tok = rng.integers(0, cfg.vocab_size, (B, s_text + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.frontend in ("vision", "audio"):
        key = "patches" if cfg.frontend == "vision" else "frames"
        batch[key] = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def setup(request) -> Setup:
    arch = request.param
    jcfg, tcfg = jbase.get_smoke_config(arch), tbase.get_smoke_config(arch)
    jparams = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    batch = _batch(jcfg, ARCHS.index(arch))
    return Setup(arch, jcfg, tcfg, jparams, batch, _ref_value_and_grad(jcfg, jparams, batch))


def _ref_value_and_grad(jcfg, jparams, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(jax.value_and_grad(
        lambda p: jtfm.lm_loss(p, jcfg, jb, dtype=jnp.float32)))(jparams)


def _port_value_and_grad(su: Setup, remat: str):
    """The port's (loss, gradients) under ``remat``, once a family."""
    if remat not in su.port:
        loss, grads = ttrain.loss_and_grads(
            lambda p: ttfm.lm_loss(p, su.tcfg, su.tbatch(), dtype=F32, remat=remat),
            su.port_params())
        su.port[remat] = loss.detach(), grads
    return su.port[remat]


def _leaf_errors(got_tree, want_tree):
    """Each leaf's max |got - want| over its max |want|, by path."""
    out = {}
    for (path, got), want in zip(tree_flatten_with_path(got_tree)[0], tree_flatten(want_tree)[0],
                                 strict=True):
        assert got.shape == want.shape, path
        got, want = got.detach().float(), want.float()
        scale = max(float(torch.amax(torch.abs(want))), 1e-30)
        out[keystr(path)] = float(torch.amax(torch.abs(got - want))) / scale
    return out


@pytest.mark.parametrize("remat", REMATS)
def test_lm_loss_and_grads_match_the_reference(setup, remat):
    su = setup
    jloss, jgrads = su.ref
    loss, grads = _port_value_and_grad(su, remat)
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss)), (float(loss),
                                                                              float(jloss))
    want = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jgrads), su.tcfg, "cpu")
    errs = _leaf_errors(grads, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


def test_remat_modes_agree_bitwise(setup):
    """``full`` recomputes each group (Mamba's scan, sLSTM's loop, the MoE's
    dispatch included) and ``dots`` saves its products: the same loss and
    gradients, bit for bit, as without remat."""
    base_loss, base = _port_value_and_grad(setup, "none")
    for remat in ("full", "dots"):
        loss, grads = _port_value_and_grad(setup, remat)
        assert torch.equal(loss, base_loss), remat
        for (path, a), b in zip(tree_flatten_with_path(grads)[0], tree_flatten(base)[0],
                                strict=True):
            assert torch.equal(a, b), (remat, keystr(path))


def test_one_step_of_the_published_optimizer_matches_the_reference(setup):
    """One train step with the published config's default optimizer and
    parameter dtype, from the reference's initial state carried across: the
    port's ``build_train_step`` (remat "full", float32 compute) against the
    reference optimizer's ``update`` on the reference's own gradients at
    that dtype (its train step's body; remat does not change them).  The
    loss, the clip norm and the learning rate to 1e-5 relative; the
    parameters after the step within 1e-4 of each leaf's max-abs (a bf16
    leaf within 2^-7); the optimizer's new statistics within 1e-4 of each
    leaf's max-abs (2^-7 where they are squares of bf16 gradients, which
    round apart in the two packages); and, since a first step moves a parameter by about the
    learning rate only, the step itself (new minus old parameters, float32
    leaves) within 1e-2 of its leaf's largest step wherever the reference
    gradient is over 1e-2 of its leaf's max-abs (AdamW's first step is a
    sign step: where the gradient is near 0 the sign of a rounding error
    decides it).  The exception is Adafactor on a layer's vectors (the
    RMSNorm scales): the reference factors the stack (groups, d) across
    groups where the port keeps each vector's full v (ROADMAP Queue 3), so
    their statistics and steps are not compared."""
    su = setup
    published = tbase.get_config(su.arch)
    opt_cfg = ttrain.default_opt_config(published)
    dtype = ttrain.default_param_dtype(published)
    jopt_cfg = jtrain.default_opt_config(jbase.get_config(su.arch))
    jdtype = jtrain.default_param_dtype(jbase.get_config(su.arch))
    assert opt_cfg == topt.OptConfig(name=jopt_cfg.name) and jopt_cfg == jopt.OptConfig(
        name=jopt_cfg.name)
    assert opt_cfg.name == ("adafactor" if su.arch in ("jamba-v0.1-52b", "mistral-large-123b",
                                                       "kimi-k2-1t-a32b") else "adamw")
    assert dtype == (torch.bfloat16 if su.arch == "kimi-k2-1t-a32b" else F32)
    assert (jdtype == jnp.bfloat16) == (dtype == torch.bfloat16)
    jparams = jax.tree.map(lambda p: p.astype(jdtype) if p.dtype == jnp.float32 else p,
                           su.jparams)
    jloss, jgrads = su.ref if dtype == F32 else _ref_value_and_grad(su.jcfg, jparams, su.batch)
    jo = jopt.make_optimizer(jopt_cfg)
    jstate = {"params": jparams, "opt": jo.init(jparams), "step": jnp.zeros((), jnp.int32)}
    tstate = convert.train_state_from_numpy(jax.tree.map(np.asarray, jstate), su.tcfg, opt_cfg,
                                            "cpu")
    p0 = [p.detach().clone() for p in tree_flatten(tstate["params"])[0]]
    assert all(p.dtype == dtype for p in p0)
    tstep = ttrain.build_train_step(su.tcfg, topt.make_optimizer(opt_cfg), remat="full",
                                    dtype=F32)
    tstate, tm = tstep(tstate, su.tbatch())
    jnew, jopt_state, jm = jax.jit(jo.update)(jgrads, jstate["opt"], jparams, jstate["step"])
    # bf16 gradients (kimi-k2) round apart: their norm is held to the bf16 bar.
    for k, want, bar in (("loss", jloss, LOSS_RTOL), ("lr", jm["lr"], LOSS_RTOL),
                         ("gnorm", jm["gnorm"], LOSS_RTOL if dtype == F32 else BF16_TOL)):
        assert abs(float(tm[k]) - float(want)) <= bar * abs(float(want)), k
    assert int(tstate["step"]) == 1

    def port(tree):
        return convert.lm_params_from_numpy(jax.tree.map(np.asarray, tree), su.tcfg, "cpu")

    want = port(jnew)
    errs = _leaf_errors(tstate["params"], want)
    bar = BF16_TOL if dtype == torch.bfloat16 else GRAD_TOL
    worst = max(errs, key=errs.get)
    assert errs[worst] <= bar, (worst, errs[worst])

    moved = 0
    paths = [keystr(k) for k, _ in tree_flatten_with_path(tstate["params"])[0]]
    for path, p, w, w0, g in zip(paths, tree_flatten(tstate["params"])[0],
                                 tree_flatten(want)[0], p0, tree_flatten(port(jgrads))[0],
                                 strict=True):
        vector = opt_cfg.name == "adafactor" and path.startswith("['groups']") and p.ndim == 1
        if dtype != F32 or vector:
            continue
        step, step_ref = p.detach() - w0, w - w0
        big = torch.abs(g) > 1e-2 * float(torch.amax(torch.abs(g)))
        err = float(torch.amax(torch.abs(step - step_ref)[big]))
        assert err <= 1e-2 * float(torch.amax(torch.abs(step_ref))), (path, err)
        moved += int(big.sum())
    assert dtype != F32 or moved > 0.5 * sum(p.numel() for p in p0)

    got_opt = {k: v for k, v in tstate["opt"].items() if k != "count"}
    ref_opt = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jopt_state), opt_cfg,
                                           tstate["params"], "cpu")
    assert int(tstate["opt"]["count"]) == int(ref_opt.pop("count")) == 1
    errs = _leaf_errors(got_opt, ref_opt)
    if opt_cfg.name == "adafactor":
        errs = {p: e for p, e in errs.items() if not (p.startswith("['stats']['groups']")
                                                      and p.endswith("['v']"))}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= bar, (worst, errs[worst])


def test_mlstm_grads_stay_finite_where_the_gate_exponent_overflows():
    """mLSTM's chunkwise gate exp(cum_f[i] - cum_f[j] + log_i[j]) is masked
    above the diagonal, where the exponent passes float32's exp range once
    the forget gates decay a chunk by more than 88 (xlstm-125m's chunk of
    256 at S >= 512 did, on the card: a NaN gradient norm).  The reference
    masks after the exp, so its gradient there is NaN (inf times a zero
    gradient); the port masks the exponent.  Held here: at a chunk of 64 on
    forget gates near their clamp of -8 (the overflow asserted), the port's
    loss and gradients, finite, against the reference's at a chunk of 8,
    where nothing overflows (the chunking changes only the float order),
    to 1e-4 of each one's max-abs."""
    import jax.nn as jnn

    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm

    d, s = 16, 64
    jp = jax.tree.map(np.asarray, jssm.init_mlstm(jax.random.PRNGKey(4),
                                                   jssm.MLSTMDims(d, 2, 2, 8)))
    jp["w_gates"] = jp["w_gates"].copy()
    jp["w_gates"][:, 2:] *= 40.0  # the forget gates: log_sigmoid near its clamp
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    w_out = rng.standard_normal((2, s, d)).astype(np.float32)
    log_f = np.maximum(np.asarray(jnn.log_sigmoid(x @ jp["w_gates"][:, 2:])), -8.0)
    cum = np.cumsum(log_f, axis=1)
    assert float(np.max(cum[:, :, None] - cum[:, None, :])) > 89.0  # exp overflows

    def ref_loss(p, xx):
        return jnp.sum(jssm.mlstm_apply(p, jssm.MLSTMDims(d, 2, 2, 8), xx)[0] * w_out)

    jloss, jgrads = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = torch.sum(tssm.mlstm_apply(tp, tssm.MLSTMDims(d, 2, 2, 64), tx)[0]
                     * torch.from_numpy(w_out))
    grads = torch.autograd.grad(loss, [*tp.values(), tx])
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    for name, got, want in zip([*tp, "x"], grads, [*(jgrads[0][k] for k in tp), jgrads[1]],
                               strict=True):
        want = torch.from_numpy(np.array(want))
        assert bool(torch.isfinite(got).all()), name
        err = float(torch.amax(torch.abs(got - want))) / float(torch.amax(torch.abs(want)))
        assert err <= GRAD_TOL, (name, err)


# The loops' CLOMPR decodes (the balancer's and the monitor's) at a
# thirtieth of their default depth, one restart, as in
# tests/test_torch_train.py: these tests hold the loop around each family,
# not the decodes, which take most of a loop's time on the CPU at full depth.
SHALLOW_DECODE = {"atom_steps": 10, "joint_steps": 5, "nnls_iters": 10,
                  "final_steps": 20, "atom_restarts": 1}


@pytest.fixture
def shallow_decodes(monkeypatch):
    from repro_torch.data import clustering as tclust

    decode = tclust.ckm_mod.decode_sketch

    def shallow(seed, z, freqs, lo, hi, cfg, **kw):
        return decode(seed, z, freqs, lo, hi, dataclasses.replace(cfg, **SHALLOW_DECODE), **kw)

    monkeypatch.setattr(tclust.ckm_mod, "decode_sketch", shallow)


def _loop(cfg, ckpt_dir, steps, **kw):
    loop = tloop.LoopConfig(steps=steps, ckpt_dir=str(ckpt_dir), monitor_k=2, log_every=1,
                            dtype=F32, **kw)
    return tloop.run(cfg, tbase.ShapeConfig("t", S, 4, "train"), None, loop,
                     tpipe.DataConfig(seed=0, n_domains=4), device="cpu")


def test_train_loop_runs_the_family(setup, tmp_path, shallow_decodes):
    """Two steps of ``train_loop.run`` with the monitor (K = 2) and the
    balancer (a decode after step 2) on: finite losses and gradient norms,
    the monitor's centroids finite, the balancer's weights a distribution."""
    out = _loop(setup.tcfg, tmp_path, 2, balance_every=2, ckpt_every=2)
    assert [h["step"] for h in out["history"]] == [1, 2]
    for h in out["history"]:
        assert np.isfinite(h["loss"]) and np.isfinite(h["gnorm"]), h
    cents = out["monitor_result"].centroids
    assert tuple(cents.shape) == (2, setup.tcfg.d_model) and bool(torch.isfinite(cents).all())
    weights = out["balance_weights"]
    assert len(weights) == 4 and abs(float(np.sum(weights)) - 1.0) < 1e-5


def test_restart_matches_uninterrupted_on_jamba(tmp_path, shallow_decodes):
    """Jamba's smoke config (Mamba, attention, dense and MoE layers): six
    steps straight against three, a restart from the checkpoint and three
    more; the same final loss, to the reference test's rtol of 1e-4, and the
    same parameters."""
    cfg = tbase.get_smoke_config("jamba-v0.1-52b")
    straight = _loop(cfg, tmp_path / "a", 6, ckpt_every=3)
    _loop(cfg, tmp_path / "b", 3, ckpt_every=3)
    assert Checkpointer(tmp_path / "b").latest_step() == 3
    resumed = _loop(cfg, tmp_path / "b", 6, ckpt_every=3)
    assert [h["step"] for h in resumed["history"]] == [4, 5, 6]
    np.testing.assert_allclose(resumed["history"][-1]["loss"], straight["history"][-1]["loss"],
                               rtol=1e-4)
    for a, b in zip(tree_flatten(straight["state"]["params"])[0],
                    tree_flatten(resumed["state"]["params"])[0], strict=True):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-4, atol=1e-6)
    assert bool(torch.isfinite(resumed["monitor_result"].centroids).all())
