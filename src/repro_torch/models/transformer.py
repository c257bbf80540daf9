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
frames into the encoder (``batch["frames"]``).

On a mesh (``mesh=`` a ``torch.distributed`` ``DeviceMesh`` or a
``parallel.collectives.Spmd``; one process a rank, SPMD): ``params`` are
the rank's pieces as ``parallel.sharding.param_specs`` places them, the
batch is the rank's rows (``batch_specs``) and a cache the rank's pieces
(``cache_specs``).  A layer's FSDP ("data") dimensions are all-gathered
before use and their gradients reduce-scattered; its "model" dimensions
stay local: attention heads and KV heads (where "model" divides both), the
dense FFN hidden, the MoE's experts and Mamba's channels are
column-parallel on the way in, ``wo`` / ``w_down`` / ``out_proj``
row-parallel with one all-reduce over "model" (the kinds the reference's
``activation_sharder`` pins).  Query heads whose KV heads are fewer than
the "model" ranks are split too, each rank's heads reading one KV head,
in the train forward and in the prefill (whose cache, every KV head with
the sequence over "model", is then made by one all-to-all).  Where
"model" does not divide them the layer gathers its weights and computes
replicated.

Sequence parallelism (the reference's ``seq_shard``, d_model >= 4096):
where "model" divides the sequence and is shorter than it, the residual
stream between layers is this rank's block of the sequence (``_seq_shard``);
the norms run on the block, each part gathers the sequence on the way in
and reduce-scatters it on the way out (``collectives.region_input`` /
``region_output``), and the final norm reads it gathered.  The train
forward, ``lm_loss`` and the prefill; never the one-token decode.

The embedding and ``lm_head`` are vocab-parallel where "model" divides the
vocabulary (Megatron's embedding and cross-entropy; in serving the logits
of this rank's block all-gathered); elsewhere they are gathered whole.
The loss's sums are all-reduced over the batch axes.  The decode step
reads a KV cache whose sequence is split over "model"
(``layers.attention_decode`` with ``sp``; a compressed cache likewise): it
needs ``cache_len``, the cache's full length.  A mesh whose axes all have
size 1 computes the one-card bits.
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as sh

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


# ---------------------------------------------------------------------------
# The mesh: parameter use and tensor parallelism
# ---------------------------------------------------------------------------


def _layer_specs(cfg: ModelConfig, mixer: str, mlp_kind: str, cross: bool, sp):
    return None if sp is None else sh.layer_specs(cfg, mixer, mlp_kind, cross,
                                                  tuple(sp.sizes.items()))


def _use(p: Params, specs, sp, tp: bool) -> Params:
    """A layer part's parameters as its products read them (see
    ``collectives.use_param``); the part itself on one card."""
    if sp is None:
        return p
    return {k: C.use_param(v, specs[k], sp, tp) for k, v in p.items()}


def _attn_tp(cfg: ModelConfig, sp) -> bool:
    """Attention is tensor-parallel where "model" divides its heads and its
    KV heads (so each rank's query heads read its own KV heads)."""
    m = 1 if sp is None else sp.model
    return m > 1 and cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0


def _attn_grouped(cfg: ModelConfig, sp) -> bool:
    """Where "model" divides the query heads and is a multiple of the KV
    heads (fewer KV heads than ranks), the attention is tensor-parallel
    over query heads, each rank's heads sharing one KV head
    (``_grouped_attention``)."""
    m = 1 if sp is None else sp.model
    return (m > 1 and not _attn_tp(cfg, sp) and cfg.n_heads % m == 0
            and m % cfg.n_kv_heads == 0)


def _grouped_attention(p: Params, specs, dims: L.AttnDims, h, positions, causal, sp,
                       collect: bool, seq: bool):
    """(out, (k, v) of the one KV head or None): attention over this rank's
    query heads (its columns of ``wq``, rows of ``wo``) and the one KV head
    they read, ``rank * kv_heads // model``: its columns of ``wk`` and
    ``wv`` are cut from the gathered projection, whose gradient is summed
    over "model" (each rank's is its head's part)."""
    m, hd = sp.model, dims.head_dim
    j = sp.rank("model") * dims.n_kv_heads // m
    w = {}
    for k, v in p.items():
        if k in ("wk", "wv"):
            if "model" not in sh.sharded_axes(specs[k]):
                v = C.copy_to(v, sp, ("model",))
            full = C.use_param(v, specs[k], sp, tensor_parallel=False, model_grad="sum")
            w[k] = full[:, j * hd:(j + 1) * hd]
        else:
            w[k] = C.use_param(v, specs[k], sp, tensor_parallel=True)
    dims = dataclasses.replace(dims, n_heads=dims.n_heads // m, n_kv_heads=1)
    res = L.attention_apply(w, dims, C.region_input(h, sp, True, seq), positions, causal,
                            return_kv=collect)
    out, kv = res if collect else (res, None)
    return C.region_output(out, sp, True, seq), kv


def _local_dims(dims: L.AttnDims, sp) -> L.AttnDims:
    return dataclasses.replace(dims, n_heads=dims.n_heads // sp.model,
                               n_kv_heads=dims.n_kv_heads // sp.model)


def _top_specs(cfg: ModelConfig, sp) -> dict:
    sizes = sp.sizes
    v, d = cfg.vocab_size, cfg.d_model
    return {"embed": {"table": sh.leaf_spec("embed/table", (v, d), cfg.family, sizes)},
            "lm_head": {"w": sh.leaf_spec("lm_head/w", (d, v), cfg.family, sizes)},
            "final_norm": {"scale": sh.P()}}


def _vocab_tp(cfg: ModelConfig, sp) -> bool:
    """The embedding and logits are vocab-parallel where "model" divides
    the vocabulary (``param_specs`` then splits the table's rows and
    ``lm_head``'s columns over it)."""
    return sp is not None and sp.model > 1 and cfg.vocab_size % sp.model == 0


def _with_top(params: Params, cfg: ModelConfig, sp, vocab_tp: bool = False) -> Params:
    """``params`` with the embedding, ``lm_head`` and final norm gathered
    whole (every rank computes the same logits; their gradients come back
    as each rank's block), or with ``vocab_tp`` the embedding and
    ``lm_head`` as this rank's vocabulary block."""
    if sp is None:
        return params
    specs = _top_specs(cfg, sp)
    out = dict(params)
    for name, spec in specs.items():
        if name in params:
            out[name] = _use(params[name], spec, sp, tp=vocab_tp)
    return out


def _vocab_rows(table: torch.Tensor, tokens: torch.Tensor, sp) -> torch.Tensor:
    """The rows of ``tokens`` that this rank's block of a vocab-parallel
    table holds, zeros for the rest: their sum over "model" is the row
    (Megatron's embedding)."""
    rows = table.shape[0]
    local = tokens.long() - sp.rank("model") * rows
    inside = (local >= 0) & (local < rows)
    return F.embedding(torch.where(inside, local, 0), table) * inside[..., None].to(table.dtype)


def _vocab_embed(table: torch.Tensor, tokens: torch.Tensor, dtype, sp) -> torch.Tensor:
    """The rows of ``tokens`` from a vocab-parallel table (this rank's block
    of rows), summed over "model"."""
    return C.reduce_from(_vocab_rows(table, tokens, sp), sp, ("model",)).to(dtype)


SEQ_SHARD_MIN_D_MODEL = 4096  # the reference's threshold (``transformer._sharder``)


def _seq_shard(cfg: ModelConfig, sp, s: int) -> bool:
    """Whether the residual stream of an ``s``-position sequence is this
    rank's block of it over "model" (the reference's ``seq_shard`` and
    ``activation_sharder``'s rule for kind ``"resid"``)."""
    m = 1 if sp is None else sp.model
    return cfg.d_model >= SEQ_SHARD_MIN_D_MODEL and m > 1 and s % m == 0 and s > m


def _self_attention(p: Params, specs, cfg: ModelConfig, mixer: str, h, positions, causal,
                    collect: bool, sp, seq: bool = False):
    """(out, (k, v) or None): tensor-parallel over heads where it can be
    (k and v then this rank's KV heads), else over query heads that share
    a KV head (``_attn_grouped``; k and v then that head's)."""
    dims = attn_dims(cfg, mixer)
    if _attn_grouped(cfg, sp):
        return _grouped_attention(p, specs, dims, h, positions, causal, sp, collect, seq)
    tp = _attn_tp(cfg, sp)
    w = _use(p, specs, sp, tp)
    if tp:
        dims = _local_dims(dims, sp)
    res = L.attention_apply(w, dims, C.region_input(h, sp, tp, seq), positions, causal,
                            return_kv=collect)
    out, kv = res if collect else (res, None)
    return C.region_output(out, sp, tp, seq), kv


def _mlp(p: Params, specs, cfg: ModelConfig, h, sp, seq: bool = False):
    """The dense SwiGLU MLP, its hidden over "model" where it divides."""
    tp = sp is not None and sp.model > 1 and cfg.d_ff % sp.model == 0
    w = _use(p, specs, sp, tp)
    return C.region_output(L.mlp_apply(w, C.region_input(h, sp, tp, seq)), sp, tp, seq)


def _cross(p: Params, specs, cfg: ModelConfig, h, enc_kv, sp, decode: bool, seq: bool = False):
    """Cross-attention.  In the forward, tensor-parallel over heads like the
    self-attention (``enc_kv`` then this rank's KV heads); in the decode,
    whole weights over the cache's keys, their positions split over "model"
    where ``cache_specs`` splits them."""
    dims = attn_dims(cfg, "attn")
    if sp is None:
        return L.cross_attention_apply(p, dims, h, enc_kv)
    if decode:
        w = _use(p, specs, sp, tp=False)
        if sh.seq_sharded(cfg.frontend_len, sp.model, cfg):
            return L.cross_attention_sharded(w, dims, h, enc_kv, sp)
        return L.cross_attention_apply(w, dims, h, enc_kv)
    tp = _attn_tp(cfg, sp)
    w = _use(p, specs, sp, tp)
    if tp:
        dims = _local_dims(dims, sp)
    out = L.cross_attention_apply(w, dims, C.region_input(h, sp, tp, seq), enc_kv)
    return C.region_output(out, sp, tp, seq)


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


def _norm(p: Params, name: str, specs, sp, seq: bool = False) -> Params:
    """A norm's scale; on a sequence block (``seq``) each rank's gradient is
    its block's part, summed over "model"."""
    if sp is None:
        return p[name]
    w = _use(p[name], specs[name], sp, tp=False)
    return {k: C.copy_to(v, sp, ("model",)) for k, v in w.items()} if seq else w


def _cross_and_mlp(p: Params, cfg: ModelConfig, mlp_kind: str, x: torch.Tensor, enc_kv,
                   dense_path: bool, sp=None, specs=None, seq: bool = False):
    """The layer after its mixer: cross-attention over ``enc_kv`` (when
    given), then the MLP.  Returns (x, aux).  ``dense_path`` marks the
    decode step, ``seq`` a sequence-parallel stream."""
    if enc_kv is not None:
        h = L.rmsnorm(_norm(p, "norm_cross", specs, sp, seq), x, cfg.norm_eps)
        x = x + _cross(p["cross"], specs and specs["cross"], cfg, h, enc_kv, sp, dense_path, seq)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mlp_kind == "dense":
        h = L.rmsnorm(_norm(p, "norm2", specs, sp, seq), x, cfg.norm_eps)
        x = x + _mlp(p["mlp"], specs and specs["mlp"], cfg, h, sp, seq)
    elif mlp_kind == "moe":
        h = L.rmsnorm(_norm(p, "norm2", specs, sp, seq), x, cfg.norm_eps)
        out, aux = moe_mod.moe_apply(p["mlp"], moe_dims(cfg), h, mesh=sp, dense_path=dense_path,
                                     seq_shard=seq)
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
    seq_shard: bool = False,
):
    """Pre-norm residual layer.  Returns (x, aux_loss, cache_or_None): the
    cache is the attention's ``{"k", "v"}`` or a recurrent mixer's final
    state.  On a mesh the attention's keys and values are this rank's KV
    heads where the attention is tensor-parallel (its one KV head where it
    is grouped), a Mamba state its channels.  ``seq_shard``: x (and the
    result) is this rank's block of the sequence over "model"; positions
    stay whole (see the module's docstring)."""
    sp, seq = C.as_spmd(mesh), seq_shard
    _check_kinds(mixer, mlp_kind)
    specs = _layer_specs(cfg, mixer, mlp_kind, "cross" in p, sp)
    h = L.rmsnorm(_norm(p, "norm1", specs, sp, seq), x, cfg.norm_eps)
    cache = None
    if mixer in ("attn", "local"):
        out, kv = _self_attention(p["mixer"], specs and specs["mixer"], cfg, mixer, h,
                                  positions, causal, collect_cache, sp, seq)
        if collect_cache:
            cache = {"k": kv[0], "v": kv[1]}
    else:
        apply, dims_of = _APPLY[mixer]
        if mixer == "mamba":
            out, state = ssm.mamba_apply(p["mixer"], dims_of(cfg), h, mesh=sp, seq_shard=seq)
        else:
            out, state = apply(_use(p["mixer"], specs and specs["mixer"], sp, tp=False),
                               dims_of(cfg), C.region_input(h, sp, False, seq))
            out = C.region_output(out, sp, False, seq)
        cache = state if collect_cache else None
    x, aux = _cross_and_mlp(p, cfg, mlp_kind, x + out, enc_kv, dense_path=False, sp=sp,
                            specs=specs, seq=seq)
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
    cache_len: int | None = None,
):
    """Single-token decode.  x: (B, 1, d).  Returns (x, new_cache); the
    cache's tensors (keys and values, recurrent states) are written in
    place.  The MoE takes its dense path.  On a mesh ``cache_len`` is the
    full length the cache was made for (its sequence may be split over
    "model"): the attention's weights are gathered whole and its softmax
    runs over the split sequence."""
    sp = C.as_spmd(mesh)
    _check_kinds(mixer, mlp_kind)
    specs = _layer_specs(cfg, mixer, mlp_kind, "cross" in p, sp)
    h = L.rmsnorm(_norm(p, "norm1", specs, sp), x, cfg.norm_eps)
    enc_kv = (cache["cross_k"], cache["cross_v"]) if "cross_k" in cache else None
    if mixer in ("attn", "local"):
        dims = attn_dims(cfg, mixer)
        w = _use(p["mixer"], specs and specs["mixer"], sp, tp=False)
        if "ck" in cache:  # CKM-compressed global attention (long_context)
            out, kv_cache = _compressed_decode(w, dims, h, cache, index, cfg, sp)
        else:
            s_full = None
            if sp is not None:
                if cache_len is None:
                    raise ValueError("a decode step on a mesh needs cache_len, the cache's "
                                     "full length")
                s_full = min(cfg.window, cache_len) if mixer == "local" else cache_len
            split = sp is not None and sh.seq_sharded(s_full, sp.model, cfg)
            out, ck, cv = L.attention_decode(w, dims, h, cache["k"], cache["v"], index,
                                             *((sp, s_full) if split else ()))
            kv_cache = {"k": ck, "v": cv}
        cache = {**cache, **kv_cache}
    else:
        dims = _APPLY[mixer][1](cfg)
        if mixer == "mamba":
            out, state = ssm.mamba_step(p["mixer"], dims, h, cache["state"], mesh=sp)
        else:
            out, state = _STEP[mixer](_use(p["mixer"], specs and specs["mixer"], sp, tp=False),
                                      dims, h, cache["state"])
        for name, t in state.items():
            cache["state"][name].copy_(t)
    x, _ = _cross_and_mlp(p, cfg, mlp_kind, x + out, enc_kv, dense_path=True, sp=sp,
                          specs=specs)
    return x, cache


def _compressed_decode(w: Params, dims: L.AttnDims, h, cache: Params, index: int,
                       cfg: ModelConfig, sp):
    """The CKM-compressed decode attention (``serve.kv_clustering``).  On a
    mesh each rank attends over its block of the centroids and of the ring
    (where ``cache_specs`` splits them over "model"), the softmax's max and
    sums all-reduced over "model"; the rank that holds the new token's ring
    slot writes it."""
    from repro_torch.serve.kv_clustering import attention_decode_compressed

    if sp is None or sp.model == 1:
        return attention_decode_compressed(w, dims, h, cache, index)
    return attention_decode_compressed(
        w, dims, h, cache, index, sp=sp,
        centroids_split=sh.seq_sharded(CKM_KV_CENTROIDS, sp.model, cfg),
        ring_split=sh.seq_sharded(CKM_KV_RECENT, sp.model, cfg))


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------


def init_lm(seed: int, cfg: ModelConfig, device=dev_mod.DEFAULT,
            dtype=torch.float32, place=None) -> Params:
    """Random parameters of the reference's distributions (dense matrices
    normal / sqrt(fan_in), the embedding normal x 0.02, RMSNorm scales 1,
    the mixers' constants), drawn in float32 on ``device`` itself: the
    embedding from ``derive_seed(seed, 0)``, layer ``l`` from
    ``derive_seed(seed, 1, l)``, the untied head from ``derive_seed(seed,
    2)``, encoder layer ``l`` from ``derive_seed(seed, 3, l)``.  Each leaf is
    stored in ``dtype`` as soon as it is drawn: ``dtype=torch.bfloat16``
    gives ``launch.serve.serving_params`` of the float32 model, bitwise,
    without holding it.  ``device="meta"`` gives the shapes and dtypes
    alone.  ``place(path, leaf)``, when given, replaces each leaf as soon as
    its part of the model is drawn (``launch.train.init_sharded_state``
    keeps a rank's block), so the whole model is never resident."""
    _check_cfg(cfg)
    dev = _device(device)
    cross = cfg.encoder_layers > 0

    def gen(*path):
        return None if dev.type == "meta" else dev_mod.generator(
            dev_mod.derive_seed(seed, *path), dev)

    def put(prefix: str, tree):
        if place is None:
            return tree
        return sh.map_with_path(lambda path, t: place(f"{prefix}/{path}", t), tree)

    params: Params = {
        "embed": put("embed", L.init_embedding(gen(0), cfg.vocab_size, cfg.d_model, dev, dtype)),
        "final_norm": put("final_norm", L.init_rmsnorm(cfg.d_model, dev, dtype)),
        **_new_tree(cfg),
    }
    for li, where, g, key in _walk(cfg):
        prefix = f"groups/{g}/{key}" if where == "groups" else f"rest/{key}"
        _put(params, where, g, key,
             put(prefix, init_layer(gen(1, li), cfg, *_kind(cfg, li), cross, dev, dtype)))
    if not cfg.tie_embeddings:
        params["lm_head"] = put("lm_head", L.init_lm_head(gen(2), cfg.d_model, cfg.vocab_size,
                                                          dev, dtype))
    if cross:
        params["encoder"] = {
            "groups": [put(f"encoder/groups/{li}",
                           init_layer(gen(3, li), cfg, "attn", "dense", False, dev, dtype))
                       for li in range(cfg.encoder_layers)],
            "final_norm": put("encoder/final_norm", L.init_rmsnorm(cfg.d_model, dev, dtype)),
        }
    return params


# ---------------------------------------------------------------------------
# Forward (prefill backbone)
# ---------------------------------------------------------------------------


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor, dtype,
                  vocab_sp=None) -> torch.Tensor:
    if vocab_sp is None:
        x = L.embed(params["embed"], tokens, dtype)
    else:
        x = _vocab_embed(params["embed"]["table"], tokens, dtype, vocab_sp)
    scale = L.f32_sqrt(cfg.d_model)
    return x * (L.to_bf16(scale) if dtype == torch.bfloat16 else scale)


def _seq_len(cfg: ModelConfig, batch: dict) -> int:
    """The positions of the whole sequence (the vision prefix's included)."""
    s = batch["tokens"].shape[1]
    return s + batch["patches"].shape[1] if cfg.frontend == "vision" else s


def _embed_inputs(params, cfg: ModelConfig, batch: dict, dtype, vocab_sp=None, seq_sp=None):
    """Token embedding, behind the vision prefix (``batch["patches"]``, (B,
    F, d) stub embeddings) for a ``vision`` frontend.  Returns (x,
    positions over the whole sequence).  ``vocab_sp``: the embedding is
    vocab-parallel over its "model" axis.  ``seq_sp``: x is this rank's
    block of the sequence over its "model" axis (a vocab-parallel sum is
    then reduce-scattered)."""
    _check_cfg(cfg)
    tokens = batch["tokens"]
    s = _seq_len(cfg, batch)
    positions = torch.arange(s, device=tokens.device).expand(tokens.shape[0], s)
    prefix = batch["patches"].to(dtype) if cfg.frontend == "vision" else None
    if vocab_sp is not None and seq_sp is not None:
        return _vocab_embed_seq(params["embed"]["table"], cfg, tokens, prefix, dtype,
                                vocab_sp), positions
    x = _embed_tokens(params, cfg, tokens, dtype, vocab_sp)
    if prefix is not None:
        x = torch.cat([prefix, x], dim=1)
    return C.split_seq(x, seq_sp) if seq_sp is not None else x, positions


def _vocab_embed_seq(table, cfg: ModelConfig, tokens, prefix, dtype, sp) -> torch.Tensor:
    """This rank's block of the sequence of a vocab-parallel embedding: the
    ranks' rows (behind the prefix, which "model"-rank 0 alone adds)
    reduce-scattered over "model", then cast and scaled as
    ``_embed_tokens``: the same bits."""
    wide = torch.promote_types(table.dtype, dtype)
    x = _vocab_rows(table, tokens, sp).to(wide)
    n_prefix = 0
    if prefix is not None:
        n_prefix = prefix.shape[1]
        part = prefix.to(wide)
        x = torch.cat([part if sp.rank("model") == 0 else torch.zeros_like(part), x], dim=1)
    x = C.reduce_scatter_seq(x, sp).to(dtype)
    scale = L.f32_sqrt(cfg.d_model)
    scaled = x * (L.to_bf16(scale) if dtype == torch.bfloat16 else scale)
    if not n_prefix:
        return scaled
    n = x.shape[1]
    pos = sp.rank("model") * n + torch.arange(n, device=x.device)
    return torch.where((pos >= n_prefix)[None, :, None], scaled, x)


def _encoder_forward(params, cfg: ModelConfig, frames: torch.Tensor, sp=None) -> torch.Tensor:
    """Whisper's encoder on precomputed (stub) frame features (B, F, d):
    non-causal attention layers, then the encoder's final norm."""
    x = frames
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    for p in params["encoder"]["groups"]:
        x, _, _ = layer_forward(p, cfg, "attn", "dense", x, positions, mesh=sp, causal=False)
    norm = params["encoder"]["final_norm"]
    if sp is not None:
        norm = _use(norm, {"scale": sh.P()}, sp, tp=False)
    return L.rmsnorm(norm, x, cfg.norm_eps)


def _encoder_out(params, cfg: ModelConfig, batch: dict, dtype, sp=None):
    """The encoder's output for an encoder-decoder model, else None."""
    if not cfg.encoder_layers:
        return None
    return _encoder_forward(params, cfg, batch["frames"].to(dtype), sp)


def _enc_kv(p: Params, cfg: ModelConfig, enc_out, sp=None):
    """A decoder layer's cross keys and values of ``enc_out`` (or None); on
    a mesh this rank's KV heads where the attention is tensor-parallel."""
    if enc_out is None:
        return None
    dims = attn_dims(cfg, "attn")
    if sp is None:
        return L.encoder_kv(p["cross"], dims, enc_out)
    specs = _layer_specs(cfg, _kind(cfg, 0)[0], _kind(cfg, 0)[1], True, sp)["cross"]
    kv = {k: p["cross"][k] for k in ("wk", "wv")}
    tp = _attn_tp(cfg, sp)
    w = _use(kv, specs, sp, tp)
    if not tp:
        return L.encoder_kv(w, dims, enc_out)
    return L.encoder_kv(w, _local_dims(dims, sp), C.copy_to(enc_out, sp, ("model",)))


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
    load-balance losses (on a mesh, this rank's data shard's).

    ``remat`` (``"none"``, ``"full"``, ``"dots"``) applies to each group of
    ``period`` layers, as the reference's scan body; the ``rest`` layers and
    the encoder run without it, as the reference's do."""
    sp = C.as_spmd(mesh)
    return _forward(_with_top(params, cfg, sp), cfg, batch, sp, dtype, remat)


def _forward(params: Params, cfg: ModelConfig, batch: dict, sp, dtype, remat: str,
             vocab_tp: bool = False):
    """``forward`` of parameters whose top leaves ``_with_top`` has made
    (with ``vocab_tp`` as ``_with_top``).  Where the stream is
    sequence-parallel (``_seq_shard``) the layers, and the group inputs
    that ``remat`` saves, hold this rank's block of the sequence; it is
    gathered before the final norm."""
    seq = _seq_shard(cfg, sp, _seq_len(cfg, batch))
    x, positions = _embed_inputs(params, cfg, batch, dtype, sp if vocab_tp else None,
                                 sp if seq else None)
    enc_out = _encoder_out(params, cfg, batch, dtype, sp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def group(gparams, x, aux):
        for i in range(cfg.period):
            p = gparams[str(i)]
            x, a, _ = layer_forward(p, cfg, cfg.mixer_pattern[i], cfg.mlp_pattern[i], x,
                                    positions, mesh=sp, enc_kv=_enc_kv(p, cfg, enc_out, sp),
                                    seq_shard=seq)
            aux = aux + a
        return x, aux

    for gparams in params["groups"]:
        x, aux = _rematerialised(functools.partial(group, gparams), remat, x, aux)
    for li, where, g, key in _walk(cfg):
        if where == "rest":
            p = params["rest"][key]
            x, a, _ = layer_forward(p, cfg, *_kind(cfg, li), x, positions, mesh=sp,
                                    enc_kv=_enc_kv(p, cfg, enc_out, sp), seq_shard=seq)
            aux = aux + a
    if seq:
        # Every rank computes the final norm and the loss on the whole
        # sequence (the vocab-parallel loss all-reduces its gradient).
        x = C.gather_seq(x, sp, grad="slice")
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, aux


def logits_fn(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x)
    return L.lm_head(params["lm_head"], x)


def _serve_logits(params: Params, cfg: ModelConfig, x: torch.Tensor, sp,
                  vocab_tp: bool) -> torch.Tensor:
    """The serving logits; vocab-parallel, this rank's block's, all-gathered
    over "model"."""
    logits = logits_fn(params, cfg, x)
    return C.all_gather(logits, sp, "model", logits.ndim - 1) if vocab_tp else logits


def _ce_chunk(params: Params, cfg: ModelConfig, xc: torch.Tensor, lc: torch.Tensor,
              vocab_sp=None):
    """One chunk's (sum of token losses, count of counted tokens).
    ``vocab_sp``: ``params`` hold this rank's vocabulary block, and the
    log-partition and the gold logit are reduced over "model" (Megatron's
    vocab-parallel cross-entropy)."""
    mask = (lc >= 0).to(torch.float32)
    if vocab_sp is None:
        logits = logits_fn(params, cfg, xc).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, torch.clamp(lc, min=0).long()[..., None])[..., 0]
        return torch.sum((logz - gold) * mask), torch.sum(mask)
    sp = vocab_sp
    logits = logits_fn(params, cfg, C.copy_to(xc, sp, ("model",))).to(torch.float32)
    peak = C.all_reduce(logits.detach().amax(dim=-1), sp, ("model",), "max")
    sumexp = C.reduce_from(torch.exp(logits - peak[..., None]).sum(dim=-1), sp, ("model",))
    logz = torch.log(sumexp) + peak
    local = lc.long() - sp.rank("model") * logits.shape[-1]
    inside = (local >= 0) & (local < logits.shape[-1])
    picked = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    gold = C.reduce_from(torch.where(inside, picked, 0.0), sp, ("model",))
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def chunked_ce_loss(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    labels: torch.Tensor,
    chunk: int = 256,
    mesh=None,
) -> torch.Tensor:
    """Cross-entropy over sequence chunks: the (B, S, V) logits never
    materialise, in the forward or the backward (each chunk's float32
    logits are recomputed in its backward; only its input is saved).

    labels: (B, S) integers, negative = ignored (padding).  The mean over
    the counted tokens (``max(count, 1)``).  On a mesh (x and labels this
    rank's rows, ``params`` its pieces) the sum and the count are
    all-reduced over the batch axes, and the logits are vocab-parallel
    where "model" divides the vocabulary.
    """
    sp = C.as_spmd(mesh)
    vocab_tp = _vocab_tp(cfg, sp)
    return _ce(_with_top(params, cfg, sp, vocab_tp), cfg, x, labels, chunk, sp, vocab_tp)


def _ce(params: Params, cfg: ModelConfig, x, labels, chunk: int, sp, vocab_tp: bool = False):
    b, s, _ = x.shape
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-100)
    fn = functools.partial(_ce_chunk, params, cfg, vocab_sp=sp if vocab_tp else None)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, x.shape[1], chunk):
        t, c = _rematerialised(fn, "full", x[:, start:start + chunk],
                               labels[:, start:start + chunk])
        total = total + t
        count = count + c
    if sp is not None:
        # Each rank's gradient is its rows' part of the global mean's.
        total = C.reduce_from(total, sp, sp.grad_axes)
        count = C.all_reduce(count, sp, sp.grad_axes)
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
    return loss_and_hidden(params, cfg, batch, mesh, dtype, remat, aux_weight)[0]


def loss_and_hidden(params: Params, cfg: ModelConfig, batch: dict, mesh=None,
                    dtype=torch.bfloat16, remat: str = "none", aux_weight: float = 0.01):
    """(``lm_loss``, the final hidden states (B, S_total, d)).

    On a mesh the aux loss is this rank's data shard's (the reference's
    expert-parallel body returns each shard's own), and its gradient is
    the mean over the data shards'."""
    sp = C.as_spmd(mesh)
    vocab_tp = _vocab_tp(cfg, sp)
    top = _with_top(params, cfg, sp, vocab_tp)
    x, aux = _forward(top, cfg, batch, sp, dtype, remat, vocab_tp)
    labels = batch["labels"]
    if cfg.frontend == "vision":
        # The patch positions carry no label.
        f = batch["patches"].shape[1]
        labels = F.pad(labels, (f, 0), value=-100)
    loss = _ce(top, cfg, x, labels, 256, sp, vocab_tp)
    if sp is not None:
        aux = C.scale_grad(aux, 1.0 / sp.dp)
    return loss + aux_weight * aux, x


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
    length of the whole sequence.  On a mesh the logits are this rank's
    rows and the cache its pieces as ``cache_specs`` places them (keys and
    values of every head, the sequence split over "model")."""
    sp = C.as_spmd(mesh)
    vocab_tp = _vocab_tp(cfg, sp)
    params = _with_top(params, cfg, sp, vocab_tp)
    s_total = _seq_len(cfg, batch)
    if cache_len < s_total:
        raise ValueError(f"cache_len {cache_len} < prompt length {s_total}")
    seq = _seq_shard(cfg, sp, s_total)
    x, positions = _embed_inputs(params, cfg, batch, dtype, sp if vocab_tp else None,
                                 sp if seq else None)
    enc_out = _encoder_out(params, cfg, batch, dtype, sp)
    cache = _new_tree(cfg)
    for li, where, g, key in _walk(cfg):
        mixer, mlp_kind = _kind(cfg, li)
        p = _at(params, where, g, key)
        enc_kv = _enc_kv(p, cfg, enc_out, sp)
        x, _, raw = layer_forward(p, cfg, mixer, mlp_kind, x, positions, mesh=sp,
                                  enc_kv=enc_kv, collect_cache=True, seq_shard=seq)
        attn = mixer in ("attn", "local")
        if attn and _attn_tp(cfg, sp):
            raw = {k: C.all_gather(t, sp, "model", 2) for k, t in raw.items()}
        c = _to_cache(cfg, mixer, raw, cache_len)
        if enc_kv is not None:
            if _attn_tp(cfg, sp):
                enc_kv = tuple(C.all_gather(t, sp, "model", 2) for t in enc_kv)
            c["cross_k"], c["cross_v"] = enc_kv
        if sp is not None:
            placed = _grouped_cache(c, cfg, sp) if attn and _attn_grouped(cfg, sp) else {}
            c = {k: placed[k] if k in placed else
                 (C.own_slice(t, sp, "model", 1).clone()
                  if k != "state" and sh.seq_sharded(t.shape[1], sp.model, cfg) else t)
                 for k, t in c.items()}
        _put(cache, where, g, key, c)
    last = x[:, -1:, :]
    if seq:
        last = C.all_gather(last, sp, "model", 1)[:, -1:, :]  # the last rank's block holds it
    x = L.rmsnorm(params["final_norm"], last, cfg.norm_eps)
    return _serve_logits(params, cfg, x, sp, vocab_tp), cache, s_total


def _grouped_cache(c: Params, cfg: ModelConfig, sp) -> Params:
    """A grouped attention's ``"k"`` and ``"v"`` (in ``c``: its one KV
    head's, in cache form, (B, L, 1, hd)) as ``cache_specs`` places them:
    every KV head.  With the sequence over "model", by
    one all-to-all of keys and values together: block t of the cache goes
    to rank t, each of the ``model // kv_heads`` ranks that share a head
    sending its part of the block.  Else the heads all-gathered."""
    m, kvh = sp.model, cfg.n_kv_heads
    g = m // kvh
    k, v = c["k"], c["v"]
    kv = torch.cat([k, v], dim=-1)[:, :, 0]  # (B, L, 2 hd)
    b, length, width = kv.shape
    if not sh.seq_sharded(length, m, cfg):
        whole = C.all_gather(kv[:, :, None], sp, "model", 2)[:, :, ::g]
        return _halves(whole.split(k.shape[-1], dim=-1))
    n = length // m
    parts = [len(p) for p in torch.arange(n).tensor_split(g)]
    q = sp.rank("model") % g
    off = sum(parts[:q])
    send = kv.reshape(b, m, n, width)[:, :, off:off + parts[q]]  # (B, m, part, 2 hd)
    send = send.permute(1, 2, 0, 3).reshape(m * parts[q], b, width)
    got = C.all_to_all(send, sp, "model", [parts[q]] * m, [parts[t % g] for t in range(m)])
    # From rank t = j g + q': head j's rows of part q' of this rank's block.
    got = got.reshape(kvh, n, b, width).permute(2, 1, 0, 3).contiguous()
    return _halves(got.split(k.shape[-1], dim=-1))


def _halves(parts) -> Params:
    return {name: t.contiguous() for name, t in zip(("k", "v"), parts)}


def decode_step(
    params: Params,
    cfg: ModelConfig,
    token: torch.Tensor,
    cache: Params,
    index: int,
    mesh=None,
    dtype=torch.bfloat16,
    cache_len: int | None = None,
):
    """One decode step.  token: (B, 1) integers; index: the token's position.

    Returns (logits (B, 1, V), new cache).  The cache's tensors are written
    in place, so the returned cache holds the same tensors.  On a mesh the
    token is this rank's rows, the cache its pieces, and ``cache_len`` the
    length the cache was made for.
    """
    sp = C.as_spmd(mesh)
    vocab_tp = _vocab_tp(cfg, sp)
    params = _with_top(params, cfg, sp, vocab_tp)
    x = _embed_tokens(params, cfg, token, dtype, sp if vocab_tp else None)
    new_cache = _new_tree(cfg)
    for li, where, g, key in _walk(cfg):
        x, c = layer_step(_at(params, where, g, key), cfg, *_kind(cfg, li), x,
                          _at(cache, where, g, key), index, mesh=sp, cache_len=cache_len)
        _put(new_cache, where, g, key, c)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _serve_logits(params, cfg, x, sp, vocab_tp), new_cache
