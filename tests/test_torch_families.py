"""The other LM families on the port's model stack, against the reference in
float32 on the CPU: granite-moe and kimi-k2 (MoE), xlstm (mLSTM / sLSTM),
whisper (the encoder and cross-attention), jamba (Mamba, MoE and attention,
with its CKM-compressed long-context cache) and internvl2 (the vision
prefix), each at its smoke config, with the reference's parameters carried
across by ``convert.lm_params_from_numpy`` and shared numpy inputs.

For each architecture: ``forward`` and its MoE aux loss; ``lm_loss``'s
value; prefill then decode steps against the reference's logits and cache
and against the port's own ``forward``; the decode cache's structure
(full and long-context) and the serve layer's shapes; the serve steps.
Then jamba's ``"ck"`` decode on the reference's compressed cache, and
``cross_attention_apply`` / ``encoder_kv``.

Bars: 1e-4 of the largest reference magnitude against the reference;
``tests/test_archs.py``'s (atol 2e-2, rtol 1e-2) for prefill -> decode
against the port's own forward."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import serve as jserve
from repro.models import layers as JL
from repro.models import transformer as jtfm
from repro.serve import kv_clustering as jkvc
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as ttfm

pytestmark = pytest.mark.torch_port

FAMILIES = ("granite-moe-1b-a400m", "kimi-k2-1t-a32b", "xlstm-125m", "whisper-small",
            "jamba-v0.1-52b", "internvl2-26b")
TOL = 1e-4
ATOL, RTOL = 2e-2, 1e-2
B, S_PROMPT, N_STEPS = 2, 16, 4
F32 = jnp.float32


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol=TOL, what=""):
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x {scale:.3e}"


def _flatten(tree, prefix=""):
    """Port trees (lists for ``groups``) and reference trees (stacked) as
    ``{dotted name: leaf}``."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flatten(v, f"{prefix}{k}.").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flatten(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _close_tree(got, want, cfg, what):
    """The port's cache against the reference's, unstacked by ``convert``."""
    want = _flatten(convert.lm_cache_from_numpy(jax.tree.map(np.asarray, want), cfg, "cpu"))
    got = _flatten(got)
    assert got.keys() == want.keys(), what
    for name, t in got.items():
        _close(t, want[name].numpy(), what=f"{what} {name}")


@dataclasses.dataclass
class Setup:
    arch: str
    jcfg: jbase.ModelConfig
    tcfg: tbase.ModelConfig
    jparams: dict
    tparams: dict
    batch: dict  # numpy: tokens (B, S_PROMPT + N_STEPS), labels, patches / frames
    jforward: callable
    jprefill: callable
    jdecode: callable

    def tbatch(self, s=None):
        out = {k: _t(v) for k, v in self.batch.items()}
        if s is not None:
            out["tokens"] = out["tokens"][:, :s]
        return out

    def jbatch(self, s=None):
        out = dict(self.batch)
        if s is not None:
            out["tokens"] = out["tokens"][:, :s]
        return out


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S_PROMPT + N_STEPS)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)).astype(
            np.float32)
    elif cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)).astype(
            np.float32)
    return batch


@pytest.fixture(scope="module", params=FAMILIES)
def setup(request) -> Setup:
    arch = request.param
    jcfg, tcfg = jbase.get_smoke_config(arch), tbase.get_smoke_config(arch)
    jparams = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    cache_len = S_PROMPT + N_STEPS + (jcfg.frontend_len if jcfg.frontend == "vision" else 0)
    return Setup(
        arch, jcfg, tcfg, jparams, tparams, _batch(jcfg, FAMILIES.index(arch)),
        jax.jit(lambda p, b: jtfm.forward(p, jcfg, b, dtype=F32)),
        jax.jit(lambda p, b: jtfm.prefill(p, jcfg, b, cache_len, dtype=F32)),
        jax.jit(lambda p, tok, c, i: jtfm.decode_step(p, jcfg, tok, c, i, dtype=F32)),
    )


def _prompt_len(su: Setup) -> int:
    """Positions before the first decoded token: the vision prefix and the
    prompt."""
    return S_PROMPT + (su.tcfg.frontend_len if su.tcfg.frontend == "vision" else 0)


# ---------------------------------------------------------------------------
# Each family
# ---------------------------------------------------------------------------


def test_forward_and_aux_match_the_reference(setup):
    su = setup
    x, aux = ttfm.forward(su.tparams, su.tcfg, su.tbatch(), dtype=torch.float32)
    jx, jaux = su.jforward(su.jparams, su.jbatch())
    _close(x, jx, what=f"{su.arch} hidden")
    _close(ttfm.logits_fn(su.tparams, su.tcfg, x), jtfm.logits_fn(su.jparams, su.jcfg, jx),
           what=f"{su.arch} logits")
    _close(aux.reshape(1), np.asarray(jaux).reshape(1), what=f"{su.arch} aux")
    assert (float(jaux) > 0) == (su.tcfg.moe_experts > 0)


def test_lm_loss_matches_the_reference(setup):
    """The loss value (the forward, the chunked CE over the text positions
    only, plus 0.01 x the MoE aux loss)."""
    su = setup
    with torch.no_grad():
        loss = ttfm.lm_loss(su.tparams, su.tcfg, su.tbatch(), dtype=torch.float32)
    want = jtfm.lm_loss(su.jparams, su.jcfg, su.jbatch(), dtype=F32)
    _close(loss.reshape(1), np.asarray(want).reshape(1), what=f"{su.arch} loss")


def test_prefill_and_decode_match_the_reference_and_forward(setup):
    """prefill's logits and cache, then N_STEPS decode steps (each from the
    reference's own cache, carried across) against the reference's logits
    and cache, and the port's chain of decode steps from its own prefill
    against its own forward (test_archs' bar)."""
    su = setup
    n0 = _prompt_len(su)
    logits, cache, index = ttfm.prefill(su.tparams, su.tcfg, su.tbatch(S_PROMPT),
                                        n0 + N_STEPS, dtype=torch.float32)
    jlogits, jcache, jindex = su.jprefill(su.jparams, su.jbatch(S_PROMPT))
    assert index == int(jindex) == n0
    _close(logits, jlogits, what=f"{su.arch} prefill logits")
    _close_tree(cache, jcache, su.tcfg, f"{su.arch} prefill cache")

    x, _ = ttfm.forward(su.tparams, su.tcfg, su.tbatch(), dtype=torch.float32)
    ref = ttfm.logits_fn(su.tparams, su.tcfg, x)
    torch.testing.assert_close(logits[:, 0], ref[:, n0 - 1], atol=ATOL, rtol=RTOL)
    tok = su.batch["tokens"]
    for t in range(N_STEPS):
        step = tok[:, S_PROMPT + t][:, None]
        logits, cache = ttfm.decode_step(su.tparams, su.tcfg, _t(step), cache, index + t,
                                         dtype=torch.float32)
        torch.testing.assert_close(logits[:, 0], ref[:, n0 + t], atol=ATOL, rtol=RTOL)
        ported = convert.lm_cache_from_numpy(jax.tree.map(np.asarray, jcache), su.tcfg, "cpu")
        plogits, pcache = ttfm.decode_step(su.tparams, su.tcfg, _t(step), ported, index + t,
                                           dtype=torch.float32)
        jlogits, jcache = su.jdecode(su.jparams, step, jcache, jindex + t)
        _close(plogits, jlogits, what=f"{su.arch} decode step {t} logits")
        _close_tree(pcache, jcache, su.tcfg, f"{su.arch} decode step {t} cache")


@pytest.mark.parametrize("mode", ["full", "ckm"])
def test_init_cache_matches_the_reference(setup, mode):
    su = setup
    cache = ttfm.init_cache(su.tcfg, 3, 40, mode, torch.float32, device="cpu")
    ref = _flatten(convert.lm_cache_from_numpy(
        jax.tree.map(np.asarray, jtfm.init_cache(su.jcfg, 3, 40, mode, F32)), su.tcfg, "cpu"))
    got = _flatten(cache)
    assert got.keys() == ref.keys()
    for name, t in got.items():
        assert (t.shape, t.dtype) == (ref[name].shape, ref[name].dtype), name
        assert torch.equal(t, ref[name]), name  # zeros, and sLSTM's n ones


def _shapes(tree, cfg):
    """A reference shape tree as the port's names and (shape, dtype)."""
    dt = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}
    stacked = {"groups.": cfg.n_layers // cfg.period, "encoder.groups.": cfg.encoder_layers}
    out = {}
    for name, leaf in _flatten(tree).items():
        head = next((h for h in stacked if name.startswith(h)), None)
        if head is None:
            out[name] = (tuple(leaf.shape), dt[leaf.dtype])
            continue
        for g in range(stacked[head]):
            out[f"{head}{g}.{name[len(head):]}"] = (tuple(leaf.shape[1:]), dt[leaf.dtype])
    return out


def test_serve_layer_shapes_match_the_reference(setup):
    """``params_shapes`` and ``cache_shapes`` of the published config (every
    shape cell; jamba's long_500k in the ``"ckm"`` form), built on the meta
    device, against the reference's."""
    jcfg, tcfg = jbase.get_config(setup.arch), tbase.get_config(setup.arch)
    for shape in jbase.SHAPES:
        jshape, tshape = jbase.SHAPES[shape], tbase.SHAPES[shape]
        assert tserve.cache_mode(tcfg, tshape) == jserve.cache_mode(jcfg, jshape)
        got = {n: (tuple(s.shape), s.dtype)
               for n, s in _flatten(tserve.cache_shapes(tcfg, tshape)).items()}
        assert got == _shapes(jserve.cache_shapes(jcfg, jshape), tcfg), shape
    got = {n: (tuple(s.shape), s.dtype) for n, s in _flatten(tserve.params_shapes(tcfg)).items()}
    assert got == _shapes(jserve.params_shapes(jcfg), tcfg)
    if setup.arch == "jamba-v0.1-52b":
        assert tserve.cache_mode(tcfg, tbase.SHAPES["long_500k"]) == "ckm"


def test_serve_steps_run_the_family(setup):
    """The serve layer's prefill and serve steps on the bf16 serving model,
    with the frontend's inputs passed through: ``prefill`` / ``decode_step``'s
    bits, finite logits; ``init_lm(dtype=bf16)`` is ``serving_params`` of
    the float32 model."""
    su = setup
    n0 = _prompt_len(su)
    shape = tbase.ShapeConfig("t", n0 + 2, B, "prefill")
    params = tserve.serving_params(su.tparams)
    prefill, (_, bspecs) = tserve.make_prefill(su.tcfg, shape)
    assert sorted(bspecs) == sorted(k for k in su.batch if k != "labels")
    step, _ = tserve.make_serve_step(su.tcfg, shape)
    batch = su.tbatch(S_PROMPT)
    batch.pop("labels")
    logits, cache, index = prefill(params, batch)
    assert index == n0
    want, wcache, _ = ttfm.prefill(params, su.tcfg, batch, n0 + 2)
    assert logits.dtype == torch.bfloat16 and torch.equal(logits, want)
    tok = su.tbatch()["tokens"][:, S_PROMPT:S_PROMPT + 1]
    logits, cache = step(params, tok, cache, index)
    want, _ = ttfm.decode_step(params, su.tcfg, tok, wcache, index)
    assert torch.equal(logits, want) and bool(torch.isfinite(logits.float()).all())

    f32 = _flatten(ttfm.init_lm(5, su.tcfg, device="cpu"))
    bf16 = _flatten(ttfm.init_lm(5, su.tcfg, device="cpu", dtype=torch.bfloat16))
    assert f32.keys() == bf16.keys()
    assert all(torch.equal(bf16[n], t.to(torch.bfloat16)) for n, t in f32.items())


# ---------------------------------------------------------------------------
# jamba's compressed long-context cache, and whisper's cross-attention
# ---------------------------------------------------------------------------


def test_jamba_ck_decode_matches_the_reference():
    """The reference compresses the prefill's attention layer with its own
    ``build_compressed_cache`` (Lloyd; the two frameworks' k-means++ draws
    differ, so the port takes the reference's arrays); both packages then
    decode N_STEPS tokens on that ``"ck"`` cache beside the carried Mamba
    states: logits and caches to 1e-4."""
    arch = "jamba-v0.1-52b"
    jcfg, tcfg = jbase.get_smoke_config(arch), tbase.get_smoke_config(arch)
    jparams = jtfm.init_lm(jax.random.PRNGKey(1), jcfg)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    tok = _batch(jcfg, 9)["tokens"]
    _, jcache, jindex = jtfm.prefill(jparams, jcfg, {"tokens": tok[:, :S_PROMPT]},
                                     S_PROMPT + N_STEPS, dtype=F32)
    attn = [i for i in range(jcfg.period) if jcfg.mixer_pattern[i] == "attn"]
    assert attn and jcfg.n_layers == jcfg.period
    groups = dict(jcache["groups"])
    for i in attn:
        c = groups[str(i)]
        comp = jkvc.build_compressed_cache(jax.random.PRNGKey(2 + i), c["k"][0, :, :S_PROMPT],
                                           c["v"][0, :, :S_PROMPT], 4, 4, "lloyd")
        groups[str(i)] = jax.tree.map(lambda a: a[None], comp)
    jcache = {**jcache, "groups": groups}
    cache = convert.lm_cache_from_numpy(jax.tree.map(np.asarray, jcache), tcfg, "cpu")
    assert "ck" in cache["groups"][0][str(attn[0])]
    for t in range(N_STEPS):
        step = tok[:, S_PROMPT + t][:, None]
        logits, cache = ttfm.decode_step(tparams, tcfg, _t(step), cache, S_PROMPT + t,
                                         dtype=torch.float32)
        jlogits, jcache = jtfm.decode_step(jparams, jcfg, step, jcache, jindex + t, dtype=F32)
        _close(logits, jlogits, what=f"ck decode step {t} logits")
        _close_tree(cache, jcache, tcfg, f"ck decode step {t} cache")


@pytest.mark.parametrize("kvh", [4, 2])
def test_cross_attention_and_encoder_kv_match_the_reference(kvh):
    dims = (JL.AttnDims(32, 4, kvh, 8), TL.AttnDims(32, 4, kvh, 8))
    rng = np.random.default_rng(kvh)
    p = {"wq": (32, 32), "wk": (32, kvh * 8), "wv": (32, kvh * 8), "wo": (32, 32)}
    p = {k: rng.standard_normal(s).astype(np.float32) / 4 for k, s in p.items()}
    enc = rng.standard_normal((2, 11, 32)).astype(np.float32)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    jkv = JL.encoder_kv(p, dims[0], enc)
    tkv = TL.encoder_kv(tp, dims[1], _t(enc))
    for got, want in zip(tkv, jkv):
        _close(got, want, what="encoder_kv")
    _close(TL.cross_attention_apply(tp, dims[1], _t(x), tkv),
           JL.cross_attention_apply(p, dims[0], x, jkv), what="cross_attention_apply")
    bf = TL.cross_attention_apply(tp, dims[1], _t(x).to(torch.bfloat16),
                                  tuple(t.to(torch.bfloat16) for t in tkv))
    assert bf.dtype == torch.bfloat16 and bool(torch.isfinite(bf.float()).all())
