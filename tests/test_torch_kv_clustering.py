"""The port's CKM-compressed KV cache against the reference: the compressed
decode attention on the same cache (1e-5), a head's centroid keys, values
and log-weights for the same centroids, ``compress_kv``'s head layout, the
compressed cache's ring slots (exactly) and CKM's configuration; then the
four cases of ``tests/test_kv_clustering.py`` on the port alone (exact when
every key is its own centroid, duplicates collapse, clustered fidelity
under 0.15 for Lloyd and CKM, the ring receives the new token), and the
clustered regime at head_dim 256 in both packages
(``tests/_torch_kv_ckm_probe.py``).  The clusterers are stochastic, so they
are judged by quality, not by bits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import lloyd as jlloyd
from repro.models import layers as JL
from repro.serve import kv_clustering as jkv
from repro_torch.configs import base as tbase
from repro_torch.core import lloyd as tlloyd
from repro_torch.models import layers as TL
from repro_torch.models import transformer as ttfm
from repro_torch.serve import kv_clustering as tkv

import _torch_kv_ckm_probe as probe

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _one_thread():
    """CKM's CLOMPR decode is tens of thousands of tiny CPU ops: one intra-op
    thread runs them as fast as eight alone, and does not stall when the
    suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

TOL = 1e-5
KVH, HD, D = 2, 16, 64  # the llama3.2-1b smoke config's attention


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _dims():
    jd = JL.AttnDims(d_model=D, n_heads=4, n_kv_heads=KVH, head_dim=HD)
    return jd, TL.AttnDims(**dataclasses.asdict(jd))


def _mixer(seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(s).astype(np.float32) / np.sqrt(s[0])
            for n, s in (("wq", (D, 64)), ("wk", (D, 32)), ("wv", (D, 32)), ("wo", (64, D)))}


def _close(got, want, tol=TOL, what=""):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got.numpy() - want)))
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("index", [21, 45])
def test_attention_decode_compressed_matches_the_reference(index):
    """The same cache (with an empty centroid at -1e30), a ring of 16 before
    and after its wrap: the output and the ring with the new token."""
    rng = np.random.default_rng(1)
    jd, td = _dims()
    p = _mixer()
    x = rng.standard_normal((2, 1, D)).astype(np.float32)
    cache = {
        "ck": rng.standard_normal((2, 10, KVH, HD)).astype(np.float32) * 2,
        "cv": rng.standard_normal((2, 10, KVH, HD)).astype(np.float32),
        "clogw": np.log(rng.integers(1, 9, (2, 10, KVH))).astype(np.float32),
        "k": rng.standard_normal((2, 16, KVH, HD)).astype(np.float32),
        "v": rng.standard_normal((2, 16, KVH, HD)).astype(np.float32),
    }
    cache["clogw"][:, 3] = -1e30
    out, ring = tkv.attention_decode_compressed({k: _t(v) for k, v in p.items()}, td, _t(x),
                                                {k: _t(v) for k, v in cache.items()}, index)
    jout, jring = jkv.attention_decode_compressed(p, jd, x, cache, jnp.asarray(index))
    _close(out, jout, what="out")
    _close(ring["k"], jring["k"], what="ring k")
    _close(ring["v"], jring["v"], what="ring v")


def _given_centroids(monkeypatch, cents):
    """Both packages' clusterers return ``cents`` (the reference's as JAX
    arrays, the port's as tensors)."""
    jres = lambda *a, **k: type("R", (), {"centroids": jnp.asarray(cents)})()  # noqa: E731
    tres = lambda *a, **k: type("R", (), {"centroids": _t(cents)})()  # noqa: E731
    monkeypatch.setattr(jkv.lloyd_mod, "lloyd", jres)
    monkeypatch.setattr(jkv.ckm_mod, "fit", jres)
    monkeypatch.setattr(tkv.lloyd_mod, "lloyd", tres)
    monkeypatch.setattr(tkv.ckm_mod, "fit", tres)


@pytest.mark.parametrize("method", ["lloyd", "ckm"])
def test_compress_head_summarises_as_the_reference(monkeypatch, method):
    """For the same centroids (one far from every key, so its cluster is
    empty): the same member means of keys and values and the same
    log-weights, -1e30 for the empty cluster."""
    rng = np.random.default_rng(2)
    keys = rng.standard_normal((300, HD)).astype(np.float32)
    vals = rng.standard_normal((300, HD)).astype(np.float32)
    cents = np.concatenate([keys[:7], np.full((1, HD), 1e3, np.float32)])
    _given_centroids(monkeypatch, cents)
    ck, cv, logw = tkv.compress_head(0, _t(keys), _t(vals), 8, method)
    jck, jcv, jlogw = jkv.compress_head(jax.random.PRNGKey(0), keys, vals, 8, method)
    _close(ck, jck, what="ck")
    _close(cv, jcv, what="cv")
    assert float(logw[7]) == float(np.float32(-1e30)) == float(jlogw[7])
    _close(logw[:7], np.asarray(jlogw)[:7], what="logw")


def test_compress_kv_lays_heads_out_as_the_reference(monkeypatch):
    """A clusterer that takes each head's first K keys as its centroids (the
    same on both sides): ck, cv, clogw over (B, K, KV) equal the
    reference's, so heads map batch-major in both."""
    def first_keys(module, wrap):
        def lloyd(key, keys_1h, cfg, **kwargs):
            return type("R", (), {"centroids": wrap(keys_1h[: cfg.k])})()
        monkeypatch.setattr(module, "lloyd", lloyd)

    first_keys(jkv.lloyd_mod, lambda a: a)
    first_keys(tkv.lloyd_mod, lambda a: a)
    rng = np.random.default_rng(3)
    k = rng.standard_normal((3, 40, KVH, HD)).astype(np.float32)
    v = rng.standard_normal((3, 40, KVH, HD)).astype(np.float32)
    got = tkv.compress_kv(0, _t(k), _t(v), 5)
    want = jkv.compress_kv(jax.random.PRNGKey(0), k, v, 5)
    for name in ("ck", "cv", "clogw"):
        assert tuple(got[name].shape) == want[name].shape, name
        _close(got[name], want[name], what=name)


def test_compressed_cache_ring_slots_and_ckm_config(monkeypatch):
    """The ring equals the reference's exactly (positions (S-ring, S) at
    pos % ring, slot S % ring vacant); CKM runs with the reference's
    literals: m = 5 K hd, init "sample", 80 / 60 / 40 / 200 steps, 2
    restarts, sigma^2 from a 4096-key sample boosted x6."""
    seen = []

    def fit(seed, keys, cfg, device=None):
        seen.append(cfg)
        return type("R", (), {"centroids": keys[: cfg.k]})()

    monkeypatch.setattr(tkv.ckm_mod, "fit", fit)
    rng = np.random.default_rng(4)
    k = rng.standard_normal((1, 50, KVH, HD)).astype(np.float32)
    v = rng.standard_normal((1, 50, KVH, HD)).astype(np.float32)
    cache = tkv.build_compressed_cache(0, _t(k), _t(v), 6, 12, method="ckm")
    jcache = jkv.build_compressed_cache(jax.random.PRNGKey(0), k, v, 6, 12)
    for name in ("k", "v"):
        assert torch.equal(cache[name], _t(np.asarray(jcache[name]))), name
    assert not cache["k"][:, 50 % 12].any()
    for name in ("ck", "cv", "clogw"):
        assert tuple(cache[name].shape) == jcache[name].shape, name
    assert len(seen) == KVH
    cfg = seen[0]
    assert (cfg.k, cfg.m, cfg.init, cfg.atom_steps, cfg.joint_steps, cfg.nnls_iters,
            cfg.final_steps, cfg.atom_restarts) == (6, 5 * 6 * HD, "sample", 80, 60, 40, 200, 2)
    assert cfg.sigma2 > 0 and all(c == cfg for c in seen)
    with pytest.raises(ValueError, match="S > ring"):
        tkv.build_compressed_cache(0, _t(k), _t(v), 6, 50)


# ---------------------------------------------------------------------------
# tests/test_kv_clustering.py's four cases, on the port
# ---------------------------------------------------------------------------


def _setup():
    cfg = tbase.get_smoke_config("llama3.2-1b")
    params = ttfm.init_lm(0, cfg, device="cpu")
    return cfg, params["groups"][0]["0"], ttfm.attn_dims(cfg, "attn")


def _full_attention(p0, dims, q_tok, k, v, index):
    pad = (0, 0, 0, 0, 0, 1)
    out, _, _ = TL.attention_decode(p0["mixer"], dims, q_tok, F.pad(k, pad), F.pad(v, pad),
                                    index)
    return out


def _manual_cache(k_cent, v_cent, logw, ring_k, ring_v):
    return {"ck": k_cent, "cv": v_cent, "clogw": logw, "k": ring_k, "v": ring_v}


def _ring(k, v, split, ring):
    s = k.shape[1]
    ring_k = torch.zeros((1, ring, *k.shape[2:]))
    ring_v = torch.zeros_like(ring_k)
    slots = torch.arange(split, s) % ring
    ring_k[:, slots] = k[:, split:]
    ring_v[:, slots] = v[:, split:]
    return ring_k, ring_v


def _normal(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def test_exact_when_every_key_is_its_own_centroid():
    """Centroids = prefix keys (unit clusters, log w = 0) + exact ring: the
    compressed step equals full attention."""
    cfg, p0, dims = _setup()
    s, ring = 48, 16
    k = _normal(3, (1, s, cfg.n_kv_heads, cfg.head_dim_)) * 3
    v = _normal(4, (1, s, cfg.n_kv_heads, cfg.head_dim_))
    x = _normal(5, (1, 1, cfg.d_model))
    split = s - ring + 1
    cache = _manual_cache(k[:, :split], v[:, :split], torch.zeros((1, split, cfg.n_kv_heads)),
                          *_ring(k, v, split, ring))
    out_c, _ = tkv.attention_decode_compressed(p0["mixer"], dims, x, cache, s)
    torch.testing.assert_close(out_c, _full_attention(p0, dims, x, k, v, s), atol=2e-3,
                               rtol=1e-2)


def test_duplicate_keys_collapse_losslessly():
    """w identical keys -> one centroid with a log w bias: exact again."""
    cfg, p0, dims = _setup()
    uniq, dup, ring = 12, 4, 8
    k_u = _normal(4, (1, uniq, cfg.n_kv_heads, cfg.head_dim_)) * 3
    v_u = _normal(5, (1, uniq, cfg.n_kv_heads, cfg.head_dim_))
    k = torch.cat([k_u.repeat_interleave(dup, 1),
                   _normal(8, (1, ring - 1, cfg.n_kv_heads, cfg.head_dim_))], dim=1)
    v = torch.cat([v_u.repeat_interleave(dup, 1),
                   _normal(9, (1, ring - 1, cfg.n_kv_heads, cfg.head_dim_))], dim=1)
    s = k.shape[1]
    x = _normal(6, (1, 1, cfg.d_model))
    split = s - ring + 1
    assert split == uniq * dup
    cache = _manual_cache(k_u, v_u, torch.full((1, uniq, cfg.n_kv_heads), float(np.log(dup))),
                          *_ring(k, v, split, ring))
    out_c, _ = tkv.attention_decode_compressed(p0["mixer"], dims, x, cache, s)
    torch.testing.assert_close(out_c, _full_attention(p0, dims, x, k, v, s), atol=2e-3,
                               rtol=1e-2)


@pytest.mark.parametrize("method", ["lloyd", "ckm"])
def test_clustered_kv_high_fidelity(method):
    """Keys with cluster structure (the real-cache regime): relative error
    under 0.15."""
    cfg, p0, dims = _setup()
    s, n_clusters, ring = 512, 16, 32
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((n_clusters, cfg.n_kv_heads, cfg.head_dim_)) * 4
    assign = rng.integers(0, n_clusters, s)
    shape = (1, s, cfg.n_kv_heads, cfg.head_dim_)
    k = torch.from_numpy((centers[assign][None] + 0.1 * rng.standard_normal(shape))
                         .astype(np.float32))
    v = torch.from_numpy((centers[assign][None] * 0.5 + 0.05 * rng.standard_normal(shape))
                         .astype(np.float32))
    x = _normal(6, (1, 1, cfg.d_model))
    cache = tkv.build_compressed_cache(7, k, v, n_clusters, ring, method=method)
    out_c, _ = tkv.attention_decode_compressed(p0["mixer"], dims, x, cache, s)
    out_f = _full_attention(p0, dims, x, k, v, s)
    rel = float(torch.linalg.norm(out_c - out_f) / max(float(torch.linalg.norm(out_f)), 1e-9))
    assert rel < 0.15, f"{method}: rel err {rel}"


@pytest.mark.parametrize("method", ["lloyd", "ckm"])
def test_clustered_kv_at_head_dim_256_in_both_packages(method):
    """The example's clustered regime at gemma3-1B's head_dim of 256, at the
    reference test's size (16 planted centres, S = 512, ring 32): the
    reference and the port each meet the 0.15 bar and recover every centre.
    The card's smoke holds both methods to the bar at this size."""
    hd, n_cent, s, ring = 256, 16, 512, 32
    dims_kw = dict(d_model=64, n_heads=4, n_kv_heads=1, head_dim=hd)
    case = probe.planted_case(0, s, n_cent, hd, dims_kw["d_model"], dims_kw["n_heads"])
    ref_err, ref_found = probe.ref_error(method, 0, *case, dims_kw, n_cent, ring)
    port_err, port_found = probe.port_error(method, 0, *case, dims_kw, n_cent, ring, "cpu")
    assert ref_err < 0.15 and port_err < 0.15, (ref_err, port_err)
    assert ref_found == port_found == n_cent


def test_ring_receives_new_token():
    cfg, p0, dims = _setup()
    s = 32
    k = torch.zeros((1, s, cfg.n_kv_heads, cfg.head_dim_))
    cache = _manual_cache(k, k, torch.zeros((1, s, cfg.n_kv_heads)),
                          torch.zeros((1, 8, cfg.n_kv_heads, cfg.head_dim_)),
                          torch.zeros((1, 8, cfg.n_kv_heads, cfg.head_dim_)))
    x = torch.ones((1, 1, cfg.d_model))
    _, new = tkv.attention_decode_compressed(p0["mixer"], dims, x, cache, s)
    assert float(new["k"][0, s % 8].abs().sum()) > 0.0


def test_decode_step_takes_the_compressed_form():
    """``decode_step`` routes a layer whose cache is in the ``"ck"`` form
    through the compressed attention: a compressed cache that holds every
    key exactly (unit clusters) gives the full cache's logits."""
    cfg = tbase.get_smoke_config("gemma3-1b")
    params = ttfm.init_lm(1, cfg, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (1, 41)))
    _, cache, index = ttfm.prefill(params, cfg, {"tokens": tok[:, :40]}, 41, dtype=torch.float32)
    ring = 8
    full = ttfm.decode_step(params, cfg, tok[:, 40:], _clone(cache), index,
                            dtype=torch.float32)[0]
    layer = cache["groups"][0]["5"]  # the first global layer
    k, v = layer["k"][:, :40], layer["v"][:, :40]
    split = 40 - ring + 1
    cache["groups"][0]["5"] = _manual_cache(
        k[:, :split], v[:, :split], torch.zeros((1, split, cfg.n_kv_heads)),
        *_ring(k, v, split, ring))
    comp, new = ttfm.decode_step(params, cfg, tok[:, 40:], cache, index, dtype=torch.float32)
    assert "ck" in new["groups"][0]["5"]
    torch.testing.assert_close(comp, full, atol=1e-4, rtol=1e-4)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def test_lloyd_config_matches_the_reference_literals(monkeypatch):
    """Lloyd compresses a head with k-means++ seeding and at most 25
    iterations, as the reference does."""
    seen = []
    real = tlloyd.lloyd

    def spy(seed, x, cfg, device=None):
        seen.append(cfg)
        return real(seed, x, cfg, device=device)

    monkeypatch.setattr(tkv.lloyd_mod, "lloyd", spy)
    keys = _normal(8, (40, HD))
    tkv.compress_head(0, keys, keys, 4)
    assert seen == [tlloyd.LloydConfig(k=4, max_iters=25, init="kpp")]
    want = dataclasses.asdict(jlloyd.LloydConfig(k=4, max_iters=25, init="kpp"))
    assert {k: want[k] for k in dataclasses.asdict(seen[0])} == dataclasses.asdict(seen[0])
