"""The model stack (counterpart of ``repro.models.transformer``): one
decoder, with an optional encoder, that realises the ten architectures from
the (mixer, mlp) layer pattern in ``ModelConfig``: mixers ``attn``,
``local``, ``mamba``, ``mlstm`` and ``slstm``; MLPs ``dense``, ``moe`` and
``none``; whisper's encoder with cross-attention in every decoder layer;
the vision prefix (patch embeddings put in front of the tokens).

Layer grouping: ``n_layers // period`` groups of one period each, then the
remainder (``rest``), in that order: gemma3-1B's 26 layers are 4 periods of
6 plus 2 rest layers.  The reference stacks each group's parameters and
``lax.scan``s over them; here ``params["groups"]`` is a list with one dict a
group and the layers run in a Python loop.  Serving caches mirror the same
(groups, rest) structure.

Modes
-----
- ``forward``      : full sequence (training and the prefill backbone), with
                     ``remat`` over each group of ``period`` layers; returns
                     the MoE layers' summed aux loss
- ``lm_loss``      : forward + ``chunked_ce_loss`` (the training objective)
- ``prefill``      : forward + cache construction for decode (KV for the
                     attention layers, the final state for the recurrent
                     ones, the encoder's cross keys and values)
- ``decode_step``  : one token against the cache (ring buffers for sliding-
                     window layers, CKM-compressed KV for a cache in the
                     ``"ck"`` form, ``serve.kv_clustering``, carried states
                     for the recurrent mixers; the MoE's dense path)

The modality frontends are stubs, as in the reference: ``vlm`` takes
precomputed patch embeddings (``batch["patches"]``), ``audio`` precomputed
frames into the encoder (``batch["frames"]``).  One card: ``mesh=`` must be
``None`` (a mesh raises; the LM on a mesh is ROADMAP Queue 1 item 22 (b),
part 2).
"""

from __future__ import annotations

import functools
from typing import Any, Iterator

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch import device as dev_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm

Params = dict[str, Any]

_MIXERS = ("attn", "local", "mamba", "mlstm", "slstm")
_MLPS = ("dense", "moe", "none")

# ---------------------------------------------------------------------------
# Dims and checks
# ---------------------------------------------------------------------------


def attn_dims(cfg: ModelConfig, mixer: str) -> L.AttnDims:
    return L.AttnDims(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_,
        window=cfg.window if mixer == "local" else 0,
        rope_theta=cfg.rope_theta,
        q_block=cfg.q_block,
        score_dtype=cfg.score_dtype,
    )


def mamba_dims(cfg: ModelConfig) -> ssm.MambaDims:
    return ssm.MambaDims(cfg.d_model, cfg.ssm_state, cfg.ssm_conv, cfg.ssm_expand,
                         cfg.scan_chunk)


def mlstm_dims(cfg: ModelConfig) -> ssm.MLSTMDims:
    return ssm.MLSTMDims(cfg.d_model, cfg.mlstm_heads, cfg.ssm_expand, cfg.scan_chunk)


def slstm_dims(cfg: ModelConfig) -> ssm.SLSTMDims:
    return ssm.SLSTMDims(cfg.d_model, cfg.n_heads)


def moe_dims(cfg: ModelConfig) -> moe_mod.MoEDims:
    return moe_mod.MoEDims(cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.moe_top_k,
                           cfg.moe_capacity_factor)


def _kind(cfg: ModelConfig, layer_idx: int) -> tuple[str, str]:
    p = cfg.period
    return cfg.mixer_pattern[layer_idx % p], cfg.mlp_pattern[layer_idx % p]


def _check_kinds(mixer: str, mlp_kind: str) -> None:
    if mixer not in _MIXERS:
        raise ValueError(mixer)
    if mlp_kind not in _MLPS:
        raise ValueError(mlp_kind)


def _check_cfg(cfg: ModelConfig) -> None:
    for mixer, mlp_kind in zip(cfg.mixer_pattern, cfg.mlp_pattern):
        _check_kinds(mixer, mlp_kind)


def _check_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the LM runs on one card: mesh must be None (the LM on a mesh is ROADMAP "
            "Queue 1 item 22 (b), part 2)"
        )


def _device(device) -> torch.device:
    """``device`` resolved as an entry point resolves it, or the meta device
    (shapes and dtypes only)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return dev_mod.resolve(device)


def _walk(cfg: ModelConfig) -> Iterator[tuple[int, str, int | None, str]]:
    """Every layer in order: ``(layer index, "groups" or "rest", group,
    key)``; a layer's parameters (and cache) are ``tree["groups"][g][key]``
    or ``tree["rest"][key]``."""
    period = cfg.period
    n_groups = cfg.n_layers // period
    for g in range(n_groups):
        for i in range(period):
            yield g * period + i, "groups", g, str(i)
    for i in range(cfg.n_layers % period):
        yield n_groups * period + i, "rest", None, str(i)


def _at(tree: Params, where: str, g: int | None, key: str):
    return tree[where][g][key] if where == "groups" else tree[where][key]


def _new_tree(cfg: ModelConfig) -> Params:
    tree: Params = {"groups": [{} for _ in range(cfg.n_layers // cfg.period)]}
    if cfg.n_layers % cfg.period:
        tree["rest"] = {}
    return tree


def _put(tree: Params, where: str, g: int | None, key: str, value) -> None:
    (tree[where][g] if where == "groups" else tree[where])[key] = value


# ---------------------------------------------------------------------------
# Single layer: init / forward / decode-step
# ---------------------------------------------------------------------------


def init_layer(gen, cfg: ModelConfig, mixer: str, mlp_kind: str, cross: bool, device,
               dtype=torch.float32) -> Params:
    _check_kinds(mixer, mlp_kind)
    p: Params = {"norm1": L.init_rmsnorm(cfg.d_model, device, dtype)}
    if mixer in ("attn", "local"):
        p["mixer"] = L.init_attention(gen, attn_dims(cfg, mixer), device, dtype)
    elif mixer == "mamba":
        p["mixer"] = ssm.init_mamba(gen, mamba_dims(cfg), device, dtype)
    elif mixer == "mlstm":
        p["mixer"] = ssm.init_mlstm(gen, mlstm_dims(cfg), device, dtype)
    else:
        p["mixer"] = ssm.init_slstm(gen, slstm_dims(cfg), device, dtype)
    if cross:
        p["norm_cross"] = L.init_rmsnorm(cfg.d_model, device, dtype)
        p["cross"] = L.init_attention(gen, attn_dims(cfg, "attn"), device, dtype)
    if mlp_kind == "dense":
        p["norm2"] = L.init_rmsnorm(cfg.d_model, device, dtype)
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, device, dtype)
    elif mlp_kind == "moe":
        p["norm2"] = L.init_rmsnorm(cfg.d_model, device, dtype)
        p["mlp"] = moe_mod.init_moe(gen, moe_dims(cfg), device, dtype)
    return p


_APPLY = {"mamba": (ssm.mamba_apply, mamba_dims), "mlstm": (ssm.mlstm_apply, mlstm_dims),
          "slstm": (ssm.slstm_apply, slstm_dims)}
_STEP = {"mamba": ssm.mamba_step, "mlstm": ssm.mlstm_step, "slstm": ssm.slstm_step}


def _cross_and_mlp(p: Params, cfg: ModelConfig, mlp_kind: str, x: torch.Tensor, enc_kv,
                   dense_path: bool):
    """The layer after its mixer: cross-attention over ``enc_kv`` (when
    given), then the MLP.  Returns (x, aux)."""
    if enc_kv is not None:
        h = L.rmsnorm(p["norm_cross"], x, cfg.norm_eps)
        x = x + L.cross_attention_apply(p["cross"], attn_dims(cfg, "attn"), h, enc_kv)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mlp_kind == "dense":
        h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + L.mlp_apply(p["mlp"], h)
    elif mlp_kind == "moe":
        h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        out, aux = moe_mod.moe_apply(p["mlp"], moe_dims(cfg), h, dense_path=dense_path)
        x = x + out
    return x, aux


def layer_forward(
    p: Params,
    cfg: ModelConfig,
    mixer: str,
    mlp_kind: str,
    x: torch.Tensor,
    positions: torch.Tensor,
    mesh=None,
    causal: bool = True,
    enc_kv=None,
    collect_cache: bool = False,
):
    """Pre-norm residual layer.  Returns (x, aux_loss, cache_or_None): the
    cache is the attention's ``{"k", "v"}`` or a recurrent mixer's final
    state."""
    _check_mesh(mesh)
    _check_kinds(mixer, mlp_kind)
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    cache = None
    if mixer in ("attn", "local"):
        dims = attn_dims(cfg, mixer)
        if collect_cache:
            out, (k, v) = L.attention_apply(p["mixer"], dims, h, positions, causal,
                                            return_kv=True)
            cache = {"k": k, "v": v}
        else:
            out = L.attention_apply(p["mixer"], dims, h, positions, causal)
    else:
        apply, dims_of = _APPLY[mixer]
        out, state = apply(p["mixer"], dims_of(cfg), h)
        cache = state if collect_cache else None
    x, aux = _cross_and_mlp(p, cfg, mlp_kind, x + out, enc_kv, dense_path=False)
    return x, aux, cache


def layer_step(
    p: Params,
    cfg: ModelConfig,
    mixer: str,
    mlp_kind: str,
    x: torch.Tensor,
    cache: Params,
    index: int,
    mesh=None,
):
    """Single-token decode.  x: (B, 1, d).  Returns (x, new_cache); the
    cache's tensors (keys and values, recurrent states) are written in
    place.  The MoE takes its dense path."""
    _check_mesh(mesh)
    _check_kinds(mixer, mlp_kind)
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    enc_kv = (cache["cross_k"], cache["cross_v"]) if "cross_k" in cache else None
    if mixer in ("attn", "local"):
        dims = attn_dims(cfg, mixer)
        if "ck" in cache:  # CKM-compressed global attention (long_context)
            from repro_torch.serve.kv_clustering import attention_decode_compressed

            out, kv_cache = attention_decode_compressed(p["mixer"], dims, h, cache, index)
        else:
            out, ck, cv = L.attention_decode(p["mixer"], dims, h, cache["k"], cache["v"], index)
            kv_cache = {"k": ck, "v": cv}
        cache = {**cache, **kv_cache}
    else:
        out, state = _STEP[mixer](p["mixer"], _APPLY[mixer][1](cfg), h, cache["state"])
        for name, t in state.items():
            cache["state"][name].copy_(t)
    x, _ = _cross_and_mlp(p, cfg, mlp_kind, x + out, enc_kv, dense_path=True)
    return x, cache


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------


def init_lm(seed: int, cfg: ModelConfig, device=dev_mod.DEFAULT,
            dtype=torch.float32) -> Params:
    """Random parameters of the reference's distributions (dense matrices
    normal / sqrt(fan_in), the embedding normal x 0.02, RMSNorm scales 1,
    the mixers' constants), drawn in float32 on ``device`` itself: the
    embedding from ``derive_seed(seed, 0)``, layer ``l`` from
    ``derive_seed(seed, 1, l)``, the untied head from ``derive_seed(seed,
    2)``, encoder layer ``l`` from ``derive_seed(seed, 3, l)``.  Each leaf is
    stored in ``dtype`` as soon as it is drawn: ``dtype=torch.bfloat16``
    gives ``launch.serve.serving_params`` of the float32 model, bitwise,
    without holding it.  ``device="meta"`` gives the shapes and dtypes
    alone."""
    _check_cfg(cfg)
    dev = _device(device)
    cross = cfg.encoder_layers > 0

    def gen(*path):
        return None if dev.type == "meta" else dev_mod.generator(
            dev_mod.derive_seed(seed, *path), dev)

    params: Params = {
        "embed": L.init_embedding(gen(0), cfg.vocab_size, cfg.d_model, dev, dtype),
        "final_norm": L.init_rmsnorm(cfg.d_model, dev, dtype),
        **_new_tree(cfg),
    }
    for li, where, g, key in _walk(cfg):
        _put(params, where, g, key,
             init_layer(gen(1, li), cfg, *_kind(cfg, li), cross, dev, dtype))
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_lm_head(gen(2), cfg.d_model, cfg.vocab_size, dev, dtype)
    if cross:
        params["encoder"] = {
            "groups": [init_layer(gen(3, li), cfg, "attn", "dense", False, dev, dtype)
                       for li in range(cfg.encoder_layers)],
            "final_norm": L.init_rmsnorm(cfg.d_model, dev, dtype),
        }
    return params


# ---------------------------------------------------------------------------
# Forward (prefill backbone)
# ---------------------------------------------------------------------------


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor, dtype) -> torch.Tensor:
    x = L.embed(params["embed"], tokens, dtype)
    scale = L.f32_sqrt(cfg.d_model)
    return x * (L.to_bf16(scale) if dtype == torch.bfloat16 else scale)


def _embed_inputs(params, cfg: ModelConfig, batch: dict, dtype):
    """Token embedding, behind the vision prefix (``batch["patches"]``, (B,
    F, d) stub embeddings) for a ``vision`` frontend.  Returns (x,
    positions) over the whole sequence."""
    _check_cfg(cfg)
    x = _embed_tokens(params, cfg, batch["tokens"], dtype)
    if cfg.frontend == "vision":
        x = torch.cat([batch["patches"].to(dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    return x, positions


def _encoder_forward(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder on precomputed (stub) frame features (B, F, d):
    non-causal attention layers, then the encoder's final norm."""
    x = frames
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    for p in params["encoder"]["groups"]:
        x, _, _ = layer_forward(p, cfg, "attn", "dense", x, positions, causal=False)
    return L.rmsnorm(params["encoder"]["final_norm"], x, cfg.norm_eps)


def _encoder_out(params, cfg: ModelConfig, batch: dict, dtype):
    """The encoder's output for an encoder-decoder model, else None."""
    if not cfg.encoder_layers:
        return None
    return _encoder_forward(params, cfg, batch["frames"].to(dtype))


def _enc_kv(p: Params, cfg: ModelConfig, enc_out):
    """A decoder layer's cross keys and values of ``enc_out`` (or None)."""
    return None if enc_out is None else L.encoder_kv(p["cross"], attn_dims(cfg, "attn"), enc_out)


# Rematerialisation: "full" recomputes each group's forward in its backward
# (only the group's input is saved); "dots" saves the products without batch
# dimensions (the projections' ``mm``, as the reference's
# ``dots_with_no_batch_dims_saveable``) and recomputes the rest.
REMAT_MODES = ("none", "full", "dots")
_DOTS = (torch.ops.aten.mm.default,)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _rematerialised(fn, remat: str, *args):
    """``fn(*args)``, its activations rematerialised in the backward as
    ``remat`` says (only while autograd records)."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    kwargs = {}
    if remat == "dots":
        kwargs["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                                 _save_dots)
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kwargs)


def forward(
    params: Params,
    cfg: ModelConfig,
    batch: dict,
    mesh=None,
    dtype=torch.bfloat16,
    remat: str = "none",
):
    """Full-sequence forward.  Returns (final hidden (B, S_total, d), aux):
    S_total counts the vision prefix; aux is the sum of the MoE layers'
    load-balance losses.

    ``remat`` (``"none"``, ``"full"``, ``"dots"``) applies to each group of
    ``period`` layers, as the reference's scan body; the ``rest`` layers and
    the encoder run without it, as the reference's do."""
    _check_mesh(mesh)
    x, positions = _embed_inputs(params, cfg, batch, dtype)
    enc_out = _encoder_out(params, cfg, batch, dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def group(gparams, x, aux):
        for i in range(cfg.period):
            p = gparams[str(i)]
            x, a, _ = layer_forward(p, cfg, cfg.mixer_pattern[i], cfg.mlp_pattern[i], x,
                                    positions, enc_kv=_enc_kv(p, cfg, enc_out))
            aux = aux + a
        return x, aux

    for gparams in params["groups"]:
        x, aux = _rematerialised(functools.partial(group, gparams), remat, x, aux)
    for li, where, g, key in _walk(cfg):
        if where == "rest":
            p = params["rest"][key]
            x, a, _ = layer_forward(p, cfg, *_kind(cfg, li), x, positions,
                                    enc_kv=_enc_kv(p, cfg, enc_out))
            aux = aux + a
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, aux


def logits_fn(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x)
    return L.lm_head(params["lm_head"], x)


def _ce_chunk(params: Params, cfg: ModelConfig, xc: torch.Tensor, lc: torch.Tensor):
    """One chunk's (sum of token losses, count of counted tokens)."""
    logits = logits_fn(params, cfg, xc).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(lc, min=0).long()[..., None])[..., 0]
    mask = (lc >= 0).to(torch.float32)
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def chunked_ce_loss(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    labels: torch.Tensor,
    chunk: int = 256,
) -> torch.Tensor:
    """Cross-entropy over sequence chunks: the (B, S, V) logits never
    materialise, in the forward or the backward (each chunk's float32
    logits are recomputed in its backward; only its input is saved).

    labels: (B, S) integers, negative = ignored (padding).  The mean over
    the counted tokens (``max(count, 1)``).
    """
    b, s, _ = x.shape
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-100)
    fn = functools.partial(_ce_chunk, params, cfg)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, x.shape[1], chunk):
        t, c = _rematerialised(fn, "full", x[:, start:start + chunk],
                               labels[:, start:start + chunk])
        total = total + t
        count = count + c
    return total / torch.clamp(count, min=1.0)


def lm_loss(
    params: Params,
    cfg: ModelConfig,
    batch: dict,
    mesh=None,
    dtype=torch.bfloat16,
    remat: str = "none",
    aux_weight: float = 0.01,
) -> torch.Tensor:
    x, aux = forward(params, cfg, batch, mesh, dtype, remat)
    labels = batch["labels"]
    if cfg.frontend == "vision":
        # The patch positions carry no label.
        f = batch["patches"].shape[1]
        labels = F.pad(labels, (f, 0), value=-100)
    loss = chunked_ce_loss(params, cfg, x, labels)
    return loss + aux_weight * aux


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode step
# ---------------------------------------------------------------------------

CKM_KV_CENTROIDS = 4096  # compressed-KV size for long_context="ckm"
CKM_KV_RECENT = 1024  # raw ring of most recent tokens alongside centroids


def _layer_cache_spec(cfg: ModelConfig, mixer: str, batch: int, cache_len: int,
                      mode: str, dtype, device):
    kvh, hd = cfg.n_kv_heads, cfg.head_dim_

    def zeros(n, *tail, dt=dtype):
        return torch.zeros((batch, n, kvh, *tail), dtype=dt, device=device)

    if mixer == "local":
        w = min(cfg.window, cache_len)
        return {"k": zeros(w, hd), "v": zeros(w, hd)}
    if mixer == "attn":
        if mode == "ckm":
            return {
                "ck": zeros(CKM_KV_CENTROIDS, hd),
                "cv": zeros(CKM_KV_CENTROIDS, hd),
                "clogw": zeros(CKM_KV_CENTROIDS, dt=torch.float32),
                "k": zeros(CKM_KV_RECENT, hd),
                "v": zeros(CKM_KV_RECENT, hd),
            }
        return {"k": zeros(cache_len, hd), "v": zeros(cache_len, hd)}
    if mixer == "mamba":
        return {"state": ssm.mamba_init_state(mamba_dims(cfg), batch, dtype, device)}
    if mixer == "mlstm":
        return {"state": ssm.mlstm_init_state(mlstm_dims(cfg), batch, device)}
    if mixer == "slstm":
        return {"state": ssm.slstm_init_state(slstm_dims(cfg), batch, dtype, device)}
    raise ValueError(mixer)


def init_cache(
    cfg: ModelConfig, batch: int, cache_len: int, mode: str = "full",
    dtype=torch.bfloat16, device=dev_mod.DEFAULT,
) -> Params:
    """Zero cache mirroring the (groups, rest) parameter structure; every
    layer its own tensors (an encoder-decoder's layers also hold their cross
    keys and values, ``cross_k`` / ``cross_v``).  ``device="meta"`` gives
    shapes and dtypes."""
    _check_cfg(cfg)
    dev = _device(device)
    cache = _new_tree(cfg)
    for li, where, g, key in _walk(cfg):
        c = _layer_cache_spec(cfg, _kind(cfg, li)[0], batch, cache_len, mode, dtype, dev)
        if cfg.encoder_layers:
            for name in ("cross_k", "cross_v"):
                c[name] = torch.zeros((batch, cfg.frontend_len, cfg.n_kv_heads, cfg.head_dim_),
                                      dtype=dtype, device=dev)
        _put(cache, where, g, key, c)
    return cache


def _to_cache(cfg: ModelConfig, mixer: str, raw: Params, cache_len: int) -> Params:
    """A layer's prefill keys and values (or final state) in decode-cache
    form."""
    if mixer not in ("attn", "local"):
        return {"state": raw}
    k, v = raw["k"], raw["v"]
    s = k.shape[1]
    if mixer == "attn":
        pad = (0, 0, 0, 0, 0, cache_len - s)
        return {"k": F.pad(k, pad), "v": F.pad(v, pad)}
    w = min(cfg.window, cache_len)
    if s >= w:
        # The last w entries, placed at their ring slots (pos % w).
        pos = torch.arange(s - w, s, device=k.device) % w
        order = torch.argsort(pos)
        return {"k": k[:, s - w:][:, order], "v": v[:, s - w:][:, order]}
    pad = (0, 0, 0, 0, 0, w - s)
    return {"k": F.pad(k, pad), "v": F.pad(v, pad)}


def prefill(
    params: Params,
    cfg: ModelConfig,
    batch: dict,
    cache_len: int,
    mesh=None,
    dtype=torch.bfloat16,
):
    """Process the prompt (behind its vision prefix; the encoder on its
    frames); returns (last-position logits, cache, index), ``index`` the
    length of the whole sequence."""
    _check_mesh(mesh)
    x, positions = _embed_inputs(params, cfg, batch, dtype)
    s_total = x.shape[1]
    if cache_len < s_total:
        raise ValueError(f"cache_len {cache_len} < prompt length {s_total}")
    enc_out = _encoder_out(params, cfg, batch, dtype)
    cache = _new_tree(cfg)
    for li, where, g, key in _walk(cfg):
        mixer, mlp_kind = _kind(cfg, li)
        p = _at(params, where, g, key)
        enc_kv = _enc_kv(p, cfg, enc_out)
        x, _, raw = layer_forward(p, cfg, mixer, mlp_kind, x, positions, enc_kv=enc_kv,
                                  collect_cache=True)
        c = _to_cache(cfg, mixer, raw, cache_len)
        if enc_kv is not None:
            c["cross_k"], c["cross_v"] = enc_kv
        _put(cache, where, g, key, c)
    x = L.rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    return logits_fn(params, cfg, x), cache, s_total


def decode_step(
    params: Params,
    cfg: ModelConfig,
    token: torch.Tensor,
    cache: Params,
    index: int,
    mesh=None,
    dtype=torch.bfloat16,
):
    """One decode step.  token: (B, 1) integers; index: the token's position.

    Returns (logits (B, 1, V), new cache).  The cache's tensors are written
    in place, so the returned cache holds the same tensors.
    """
    _check_mesh(mesh)
    x = _embed_tokens(params, cfg, token, dtype)
    new_cache = _new_tree(cfg)
    for li, where, g, key in _walk(cfg):
        x, c = layer_step(_at(params, where, g, key), cfg, *_kind(cfg, li), x,
                          _at(cache, where, g, key), index)
        _put(new_cache, where, g, key, c)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, x), new_cache
