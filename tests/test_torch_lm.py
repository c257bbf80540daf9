"""The port's LM serving path (dense family) against the reference, in
float32 on the CPU: the configs and their counts (all ten architectures,
whose smoke configs ``init_lm`` builds with the reference's tree; the other
families' models are held in ``tests/test_torch_families.py``); each layer
function;
``forward``, ``prefill`` and ``decode_step`` for llama3.2-1b, gemma3-1b and
smollm-360m at their smoke configs, with the reference's parameters carried
across by ``convert.lm_params_from_numpy``; the cache's structure; the serve
layer's steps and shapes; and the port's own prefill -> decode against its
own forward.

Bars: 1e-4 of the largest reference magnitude for float32 paths (the
engine's cross-backend bar); the bf16 score path to two bf16 ulps (2^-7) of
the largest output, since a last-bit difference of the float32 products can
flip one bf16 rounding of a score; the prefill -> decode consistency to
``tests/test_archs.py``'s bar (atol 2e-2, rtol 1e-2)."""

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
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as ttfm

pytestmark = pytest.mark.torch_port

DENSE = ("llama3.2-1b", "gemma3-1b", "smollm-360m")
TOL = 1e-4
BF16_TOL = 2.0**-7
B, S_PROMPT, N_STEPS = 2, 16, 4
_CACHE: dict = {}


def _close(got, want, tol=TOL, what=""):
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x {scale:.3e}"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _setup(arch):
    """(reference cfg, port cfg, reference params, port params), cached."""
    if arch not in _CACHE:
        jcfg, tcfg = jbase.get_smoke_config(arch), tbase.get_smoke_config(arch)
        jparams = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
        tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
        _CACHE[arch] = jcfg, tcfg, jparams, tparams
    return _CACHE[arch]


def _tokens(cfg, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s)).astype(np.int32)


def _close_tree(got, want, what):
    """The port's cache (groups a list) against the reference's (stacked)."""
    if isinstance(want, dict):
        keys = [k for k in want if k != "groups"]
        assert sorted(k for k in got if k != "groups") == sorted(keys), what
        for k in keys:
            _close_tree(got[k], want[k], f"{what}.{k}")
        if "groups" in want:
            for g, gt in enumerate(got["groups"]):
                _close_tree(gt, jax.tree.map(lambda a, g=g: a[g], want["groups"]),
                            f"{what}.groups[{g}]")
        return
    _close(got, want, what=what)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jbase.ARCHS)
@pytest.mark.parametrize("which", ["config", "smoke"])
def test_config_and_counts_match_the_reference(arch, which):
    get_j = jbase.get_config if which == "config" else jbase.get_smoke_config
    get_t = tbase.get_config if which == "config" else tbase.get_smoke_config
    jcfg, tcfg = get_j(arch), get_t(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert (tcfg.period, tcfg.head_dim_, tcfg.layer_kinds()) == (
        jcfg.period, jcfg.head_dim_, jcfg.layer_kinds())


def test_registry_and_shapes_match_the_reference():
    assert tbase.ARCHS == jbase.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}


@pytest.mark.parametrize("arch", jbase.ARCHS)
def test_init_lm_builds_every_smoke_config(arch):
    """``init_lm`` builds each architecture's smoke config on the CPU with
    the reference's tree (groups and the encoder's layers unstacked), its
    shapes and dtypes, every value finite."""
    tcfg = tbase.get_smoke_config(arch)
    jcfg = jbase.get_smoke_config(arch)
    got = _flatten(ttfm.init_lm(0, tcfg, device="cpu"))
    jtree = jax.eval_shape(lambda: jtfm.init_lm(jax.random.PRNGKey(0), jcfg))
    want = _flatten(convert.lm_params_from_numpy(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jtree), tcfg, "cpu"))
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert (t.shape, t.dtype) == (want[name].shape, want[name].dtype), name
        assert bool(torch.isfinite(t).all()), name


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def test_rmsnorm_rope_mlp_and_embeddings_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 48)).astype(np.float32) * 3
    scale = rng.standard_normal(48).astype(np.float32)
    _close(TL.rmsnorm({"scale": _t(scale)}, _t(x), 1e-5),
           JL.rmsnorm({"scale": scale}, x, 1e-5), what="rmsnorm")
    xh = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(100, 107), (2, 1)).astype(np.int32)
    for theta in (1e4, 5e5):
        _close(TL.rope(_t(xh), _t(pos), theta), JL.rope(xh, pos, theta), what=f"rope {theta}")
    mlp = {n: rng.standard_normal(s).astype(np.float32) * 0.2
           for n, s in (("w_gate", (48, 96)), ("w_up", (48, 96)), ("w_down", (96, 48)))}
    _close(TL.mlp_apply({k: _t(v) for k, v in mlp.items()}, _t(x)), JL.mlp_apply(mlp, x),
           what="mlp")
    table = rng.standard_normal((50, 48)).astype(np.float32)
    tok = rng.integers(0, 50, (2, 7)).astype(np.int32)
    _close(TL.embed({"table": _t(table)}, _t(tok), torch.float32),
           JL.embed({"table": table}, tok, jnp.float32), what="embed")
    _close(TL.unembed({"table": _t(table)}, _t(x)), JL.unembed({"table": table}, x),
           what="unembed")
    head = rng.standard_normal((48, 50)).astype(np.float32)
    _close(TL.lm_head({"w": _t(head)}, _t(x)), JL.lm_head({"w": head}, x), what="lm_head")


def test_bf16_activations_round_as_the_reference():
    """rmsnorm and rope in bf16: statistics in float32, the result in bf16,
    to one bf16 ulp."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    xb, xt = jnp.asarray(x, jnp.bfloat16), _t(x).to(torch.bfloat16)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
    got = TL.rope(xt, _t(pos), 1e4)
    assert got.dtype == torch.bfloat16
    _close(got, JL.rope(xb, pos, 1e4), tol=2.0**-8, what="rope bf16")
    scale = rng.standard_normal(32).astype(np.float32)
    got = TL.rmsnorm({"scale": _t(scale)}, xt)
    assert got.dtype == torch.bfloat16
    _close(got, JL.rmsnorm({"scale": scale}, xb), tol=2.0**-7, what="rmsnorm bf16")


def _attn_case(window, q_block, score_dtype, s, seed=2):
    rng = np.random.default_rng(seed)
    jd = JL.AttnDims(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16, window=window,
                     q_block=q_block, score_dtype=score_dtype)
    td = TL.AttnDims(**dataclasses.asdict(jd))
    p = {n: rng.standard_normal(sh).astype(np.float32) / np.sqrt(sh[0])
         for n, sh in (("wq", (32, 64)), ("wk", (32, 32)), ("wv", (32, 32)), ("wo", (64, 32)))}
    x = rng.standard_normal((2, s, 32)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    return jd, td, p, {k: _t(v) for k, v in p.items()}, x, pos


@pytest.mark.parametrize("score_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 8])
def test_attention_apply_chunked_matches_the_reference(score_dtype, window):
    """q_block 8 divides S = 40: the same five blocks on both sides; keys and
    values returned as the reference's."""
    jd, td, jp, tp, x, pos = _attn_case(window, 8, score_dtype, 40)
    tol = TOL if score_dtype == "f32" else BF16_TOL
    out, (k, v) = TL.attention_apply(tp, td, _t(x), _t(pos), return_kv=True)
    jout, (jk, jv) = JL.attention_apply(jp, jd, x, pos, return_kv=True)
    _close(out, jout, tol, f"attention {score_dtype} window {window}")
    _close(k, jk, what="k")
    _close(v, jv, what="v")


@pytest.mark.parametrize("score_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 8])
def test_attention_apply_padded_tail(score_dtype, window):
    """q_block 32 against S = 40: the last block is padded.  The port's
    output equals its own one-block output and the reference's one-block
    output (the reference's chunked one gives the tail rows the positions of
    an earlier window: ROADMAP Queue 3)."""
    jd, td, jp, tp, x, pos = _attn_case(window, 32, score_dtype, 40)
    tol = TOL if score_dtype == "f32" else BF16_TOL
    out = TL.attention_apply(tp, td, _t(x), _t(pos))
    whole = TL.attention_apply(tp, dataclasses.replace(td, q_block=64), _t(x), _t(pos))
    _close(out, whole.numpy(), tol, "padded vs one block")
    ref_whole = JL.attention_apply(jp, dataclasses.replace(jd, q_block=64), x, pos)
    _close(out, ref_whole, tol, "padded vs the reference's one block")
    # The reference's own chunked output differs in the tail rows alone.
    ref_chunked = np.asarray(JL.attention_apply(jp, jd, x, pos))
    gap = np.abs(ref_chunked - np.asarray(ref_whole)).max(axis=(0, 2))
    assert gap[:32].max() <= tol * np.abs(ref_whole).max() < gap[32:].min()


@pytest.mark.parametrize("window,cache_len,index", [(0, 24, 17), (8, 8, 5), (8, 8, 13),
                                                    (8, 8, 23)])
def test_attention_decode_matches_the_reference(window, cache_len, index):
    """A full cache, a ring before its wrap, and a ring past it: output and
    the updated cache."""
    jd, td, jp, tp, x, _ = _attn_case(window, 512, "f32", 1, seed=3)
    rng = np.random.default_rng(4)
    ck = rng.standard_normal((2, cache_len, 2, 16)).astype(np.float32)
    cv = rng.standard_normal((2, cache_len, 2, 16)).astype(np.float32)
    out, nk, nv = TL.attention_decode(tp, td, _t(x), _t(ck), _t(cv), index)
    jout, jk, jv = JL.attention_decode(jp, jd, x, ck, cv, jnp.asarray(index))
    _close(out, jout, what="decode out")
    _close(nk, jk, what="decode k")
    _close(nv, jv, what="decode v")


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_the_reference(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    tok = _tokens(jcfg, S_PROMPT + N_STEPS)
    x, aux = ttfm.forward(tparams, tcfg, {"tokens": _t(tok)}, dtype=torch.float32)
    jx, _ = jtfm.forward(jparams, jcfg, {"tokens": tok}, dtype=jnp.float32)
    _close(x, jx, what=f"{arch} hidden")
    _close(ttfm.logits_fn(tparams, tcfg, x), jtfm.logits_fn(jparams, jcfg, jx),
           what=f"{arch} logits")
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_the_reference(arch):
    """prefill's logits and cache, then N_STEPS decode steps from the
    reference's own prefill cache (carried across): logits and every cache
    entry after each step.  gemma3-1b's window of 16 wraps its rings."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    tok = _tokens(jcfg, S_PROMPT + N_STEPS, seed=2)
    cache_len = S_PROMPT + N_STEPS
    logits, cache, index = ttfm.prefill(tparams, tcfg, {"tokens": _t(tok[:, :S_PROMPT])},
                                        cache_len, dtype=torch.float32)
    jlogits, jcache, jindex = jtfm.prefill(jparams, jcfg, {"tokens": tok[:, :S_PROMPT]},
                                           cache_len, dtype=jnp.float32)
    assert index == int(jindex) == S_PROMPT
    _close(logits, jlogits, what=f"{arch} prefill logits")
    _close_tree(cache, jcache, f"{arch} prefill cache")
    cache = convert.lm_cache_from_numpy(jax.tree.map(np.asarray, jcache), tcfg, "cpu")
    for t in range(N_STEPS):
        step = tok[:, S_PROMPT + t][:, None]
        logits, cache = ttfm.decode_step(tparams, tcfg, _t(step), cache, index + t,
                                         dtype=torch.float32)
        jlogits, jcache = jtfm.decode_step(jparams, jcfg, step, jcache, jindex + t,
                                           dtype=jnp.float32)
        _close(logits, jlogits, what=f"{arch} decode step {t} logits")
        _close_tree(cache, jcache, f"{arch} decode step {t} cache")


@pytest.mark.parametrize("arch", DENSE)
def test_port_prefill_then_decode_matches_its_forward(arch):
    """``tests/test_archs.py``'s consistency check on the port alone, on its
    own parameters (``init_lm`` on the CPU)."""
    _, tcfg, _, _ = _setup(arch)
    params = ttfm.init_lm(7, tcfg, device="cpu")
    tok = _t(_tokens(tcfg, S_PROMPT + N_STEPS, seed=3))
    x, _ = ttfm.forward(params, tcfg, {"tokens": tok}, dtype=torch.float32)
    ref = ttfm.logits_fn(params, tcfg, x)
    logits, cache, index = ttfm.prefill(params, tcfg, {"tokens": tok[:, :S_PROMPT]},
                                        S_PROMPT + N_STEPS, dtype=torch.float32)
    torch.testing.assert_close(logits[:, 0], ref[:, S_PROMPT - 1], atol=2e-2, rtol=1e-2)
    for t in range(N_STEPS):
        logits, cache = ttfm.decode_step(params, tcfg, tok[:, S_PROMPT + t][:, None], cache,
                                         index + t, dtype=torch.float32)
        torch.testing.assert_close(logits[:, 0], ref[:, S_PROMPT + t], atol=2e-2, rtol=1e-2)


def test_init_lm_draws_the_reference_distributions():
    """Shapes, dtypes and structure of the reference's tree (groups
    unstacked); dense matrices with std 1/sqrt(fan_in), the embedding 0.02,
    norms 1; a seed gives the same bits."""
    jcfg, tcfg, jparams, _ = _setup("gemma3-1b")
    params = ttfm.init_lm(3, tcfg, device="cpu")
    ref = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    flat, ref_flat = _flatten(params), _flatten(ref)
    assert flat.keys() == ref_flat.keys()
    for name, t in flat.items():
        assert (t.shape, t.dtype) == (ref_flat[name].shape, ref_flat[name].dtype), name
        if name.endswith("scale"):
            assert torch.equal(t, torch.ones_like(t)), name
        elif name.endswith("table"):
            assert abs(float(t.std()) - 0.02) < 0.002, name
        else:
            assert abs(float(t.std()) * t.shape[0] ** 0.5 - 1.0) < 0.1, name
    again = _flatten(ttfm.init_lm(3, tcfg, device="cpu"))
    assert all(torch.equal(again[n], t) for n, t in flat.items())


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flatten(v, f"{prefix}{k}.").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flatten(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-1b"])
@pytest.mark.parametrize("mode", ["full", "ckm"])
def test_init_cache_structure_matches_the_reference(arch, mode):
    jcfg, tcfg, _, _ = _setup(arch)
    cache = ttfm.init_cache(tcfg, 3, 40, mode, torch.float32, device="cpu")
    jcache = jtfm.init_cache(jcfg, 3, 40, mode, jnp.float32)
    ref = _flatten(convert.lm_cache_from_numpy(jax.tree.map(np.asarray, jcache), tcfg, "cpu"))
    got = _flatten(cache)
    assert got.keys() == ref.keys()
    for name, t in got.items():
        assert (t.shape, t.dtype) == (ref[name].shape, ref[name].dtype), name
        assert not t.any(), name
    if mode == "ckm":
        assert any(n.endswith("clogw") for n in got)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-1b"])
def test_serve_layer_shapes_match_the_reference(arch):
    """``cache_shapes`` (full and long-context) and ``params_shapes``: the
    reference's shapes and dtypes, groups unstacked; built on the meta
    device."""
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    dt = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}
    for shape in ("decode_32k", "long_500k"):
        jshape, tshape = jbase.SHAPES[shape], tbase.SHAPES[shape]
        assert tserve.cache_mode(tcfg, tshape) == jserve.cache_mode(jcfg, jshape)
        ref = jserve.cache_shapes(jcfg, jshape)
        got = tserve.cache_shapes(tcfg, tshape)
        _same_shapes(got, ref, dt, tcfg)
    _same_shapes(tserve.params_shapes(tcfg), jserve.params_shapes(jcfg), dt, tcfg)


def _same_shapes(got, ref, dt, cfg):
    n_groups = cfg.n_layers // cfg.period
    want = {}
    for name, leaf in _flatten_jax(ref).items():
        if name.startswith("groups."):
            for g in range(n_groups):
                want[f"groups.{g}.{name[7:]}"] = (tuple(leaf.shape[1:]), dt[leaf.dtype])
        else:
            want[name] = (tuple(leaf.shape), dt[leaf.dtype])
    assert {n: (tuple(s.shape), s.dtype) for n, s in _flatten(got).items()} == want


def _flatten_jax(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flatten_jax(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


def test_serve_steps_run_the_model():
    """``make_prefill`` / ``make_serve_step`` on the serving (bf16) cast of
    the model give ``prefill`` / ``decode_step``'s bits; the cast keeps
    non-float32 leaves; the prefill's cache has room for the decode."""
    _, tcfg, _, tparams = _setup("gemma3-1b")
    shape = tbase.ShapeConfig("t", S_PROMPT + 2, B, "prefill")
    params = tserve.serving_params(tparams)
    assert all(t.dtype == torch.bfloat16 for t in _flatten(params).values())
    assert tserve.serving_params({"i": torch.arange(3)})["i"].dtype == torch.int64
    prefill, (pshapes, bspecs) = tserve.make_prefill(tcfg, shape)
    assert tuple(bspecs["tokens"].shape) == (B, S_PROMPT + 2)
    step, (_, tok_spec, cshapes, ispec) = tserve.make_serve_step(tcfg, shape)
    assert tuple(tok_spec.shape) == (B, 1) and tuple(ispec.shape) == ()
    tok = _t(_tokens(tcfg, S_PROMPT + 1, seed=4))
    logits, cache, index = prefill(params, {"tokens": tok[:, :S_PROMPT]})
    want, wcache, _ = ttfm.prefill(params, tcfg, {"tokens": tok[:, :S_PROMPT]}, S_PROMPT + 2)
    assert logits.dtype == torch.bfloat16 and torch.equal(logits, want)
    logits, cache = step(params, tok[:, S_PROMPT:], cache, index)
    want, _ = ttfm.decode_step(params, tcfg, tok[:, S_PROMPT:], wcache, index)
    assert torch.equal(logits, want)
    assert bool(torch.isfinite(logits.float()).all())


# ---------------------------------------------------------------------------
# The design's guards
# ---------------------------------------------------------------------------


def test_the_model_calls_no_library_attention_and_no_kernel_8(monkeypatch):
    """Prefill and decode run with SDPA and every flash-attention entry
    point raising."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    def refuse(*args, **kwargs):
        raise AssertionError("the model called a library attention or kernel 8")

    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention", refuse)
    for name in dir(fa):
        if "attention" in name and callable(getattr(fa, name)):
            monkeypatch.setattr(fa, name, refuse)
    monkeypatch.setattr(ops, "flash_attention", refuse)
    _, tcfg, _, tparams = _setup("gemma3-1b")
    tok = _t(_tokens(tcfg, S_PROMPT + 1, seed=5))
    ttfm.forward(tparams, tcfg, {"tokens": tok}, dtype=torch.float32)
    _, cache, index = ttfm.prefill(tparams, tcfg, {"tokens": tok[:, :S_PROMPT]}, S_PROMPT + 1,
                                   dtype=torch.float32)
    ttfm.decode_step(tparams, tcfg, tok[:, S_PROMPT:], cache, index, dtype=torch.float32)
    assert fa.LAUNCHES == 0


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = tbase.get_smoke_config("llama3.2-1b")
    for call in (lambda: ttfm.init_lm(0, cfg), lambda: ttfm.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_a_mesh_raises():
    _, tcfg, _, tparams = _setup("llama3.2-1b")
    tok = _t(_tokens(tcfg, 4))
    shape = tbase.SHAPES["decode_32k"]
    for call in (
        lambda: ttfm.forward(tparams, tcfg, {"tokens": tok}, mesh=object()),
        lambda: ttfm.prefill(tparams, tcfg, {"tokens": tok}, 8, mesh=object()),
        lambda: tserve.make_serve_step(tcfg, shape, mesh=object()),
        lambda: tserve.make_prefill(tcfg, shape, mesh=object()),
    ):
        with pytest.raises(NotImplementedError, match="item 22 \\(b\\)"):
            call()


def test_lm_params_from_numpy_checks_the_head():
    jcfg, tcfg, jparams, _ = _setup("llama3.2-1b")
    tree = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="lm_head"):
        convert.lm_params_from_numpy({**tree, "lm_head": {"w": np.zeros((64, 256))}}, tcfg,
                                     "cpu")
    untied = dataclasses.replace(tcfg, tie_embeddings=False)
    with pytest.raises(ValueError, match="lacks an lm_head"):
        convert.lm_params_from_numpy(tree, untied, "cpu")
    jun = dataclasses.replace(jcfg, tie_embeddings=False)
    jp = jtfm.init_lm(jax.random.PRNGKey(1), jun)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), untied, "cpu")
    tok = _tokens(jun, 6)
    jx, _ = jtfm.forward(jp, jun, {"tokens": tok}, dtype=jnp.float32)
    x, _ = ttfm.forward(tp, untied, {"tokens": _t(tok)}, dtype=torch.float32)
    _close(ttfm.logits_fn(tp, untied, x), jtfm.logits_fn(jp, jun, jx), what="untied logits")
