"""Transformer building blocks (counterpart of ``repro.models.layers``):
RMSNorm, RoPE, GQA attention (global and sliding-window; prefill and
decode), whisper's cross-attention over encoder keys and values, the SwiGLU
MLP, embeddings.

Conventions, as in the reference:
- Plain functions on dicts of tensors: ``init_*`` returns a parameter dict,
  ``*_apply`` consumes it.
- Activations take the caller's dtype (bf16 when serving); parameters are
  cast to it at each product; norm and softmax statistics are float32.
- Attention is q-block-chunked with lazily built masks, so a long prefill
  never builds an (S, S) mask or score matrix; the block size is a config.
  The products are ``torch.einsum`` / ``@``: no library attention and no
  flash kernel, as the reference's models call none.
- No ``shard`` hooks: one card, no mesh (the reference's are GSPMD
  constraints).
- ``init_*`` take ``dtype``: each leaf is drawn in float32 and stored in
  ``dtype`` as soon as it is drawn, so a bf16 model never holds its float32
  copy (the bits of casting the float32 model).

Training runs these functions under autograd; the bf16 softmax carries the
reference's custom backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

Params = dict[str, Any]
_F32 = torch.float32


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator | None, shape, device) -> torch.Tensor:
    """Standard normal float32 draws from ``gen``; on the meta device (shapes
    only) no generator is used."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=_F32, device=device)
    return torch.randn(shape, generator=gen, dtype=_F32, device=device)


def _dense_init(gen, shape, device, in_axis: int = 0, dtype=_F32) -> torch.Tensor:
    return _normal(gen, shape, device).div_(float(shape[in_axis]) ** 0.5).to(dtype)


# Scalar constants are computed on the host in float32 and passed to the
# products as Python floats (exact float32 values, which a float32 or bf16
# operation applies in float32): no host-to-device copy, which would
# synchronise the host with the card at every call.


def f32_sqrt(n: int) -> float:
    """``jnp.sqrt(n)``: the float32 square root, as a Python float."""
    return float(np.sqrt(np.float32(n)))


def f32_inv_sqrt(n: int) -> float:
    """``1.0 / jnp.sqrt(n)`` in float32, as a Python float."""
    return float(np.float32(1.0) / np.sqrt(np.float32(n)))


def to_bf16(value: float) -> float:
    """``value`` rounded to bf16 (to nearest, ties to even), as a Python float."""
    return float(torch.tensor(value, dtype=_F32).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, device, dtype=_F32) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 statistics, applied in the activation dtype."""
    var = torch.mean(torch.square(x.to(_F32)), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


class _SoftmaxBF16(torch.autograd.Function):
    """Softmax over the last axis: float32 inside, bf16 out, and only the
    bf16 probabilities saved for the backward (a plain softmax would save
    its float32 output, doubling the attention's largest saved tensor).
    The backward is the reference's ``_softmax_bf16_bwd``:
    ``p (g - sum(p g))`` in float32, returned in bf16."""

    @staticmethod
    def forward(ctx, scores):
        p = torch.softmax(scores.to(_F32), dim=-1).to(torch.bfloat16)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        pf, gf = p.to(_F32), g.to(_F32)
        dot = torch.sum(pf * gf, dim=-1, keepdim=True)
        return (pf * (gf - dot)).to(torch.bfloat16)


def _softmax_bf16(scores: torch.Tensor) -> torch.Tensor:
    """The reference's ``_softmax_bf16``: forward and custom backward."""
    return _SoftmaxBF16.apply(scores)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=_F32, device=x.device) / half
    freqs = torch.pow(float(np.float32(theta)), exps)
    angles = positions[..., :, None, None].to(_F32) * freqs  # (.., S, 1, half)
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    window: int = 0  # 0 -> global causal; >0 -> sliding window
    rope_theta: float = 1e4
    q_block: int = 512  # query chunk for lazy-mask attention
    score_dtype: str = "f32"  # storage dtype of QK^T blocks (see ModelConfig)


def init_attention(gen, dims: AttnDims, device, dtype=_F32) -> Params:
    d, h, kvh, hd = dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim
    return {
        "wq": _dense_init(gen, (d, h * hd), device, dtype=dtype),
        "wk": _dense_init(gen, (d, kvh * hd), device, dtype=dtype),
        "wv": _dense_init(gen, (d, kvh * hd), device, dtype=dtype),
        "wo": _dense_init(gen, (h * hd, d), device, dtype=dtype),
    }


def _qkv(params, dims: AttnDims, x, positions):
    b, s, _ = x.shape
    h, kvh, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, h, hd)
    k = (x @ params["wk"].to(x.dtype)).reshape(b, s, kvh, hd)
    v = (x @ params["wv"].to(x.dtype)).reshape(b, s, kvh, hd)
    q = rope(q, positions, dims.rope_theta)
    k = rope(k, positions, dims.rope_theta)
    return q, k, v


def _attend_block(q_blk, k, v, q_pos, k_pos, dims: AttnDims, causal: bool):
    """q_blk: (B, bq, H, hd); k/v: (B, S, KV, hd).  The mask is built from
    positions and enters as an additive bias: -1e30 in float32 scores, -3e38
    in bf16 ones."""
    h, kvh = dims.n_heads, dims.n_kv_heads
    rep = h // kvh
    b, bq, _, hd = q_blk.shape
    s = k.shape[1]
    qh = q_blk.reshape(b, bq, kvh, rep, hd)
    mask = torch.ones((bq, s), dtype=torch.bool, device=q_blk.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if dims.window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < dims.window
    if dims.score_dtype == "bf16":
        scores = torch.einsum("bqkrh,bskh->bkrqs", qh * to_bf16(f32_inv_sqrt(hd)), k)
        bias = torch.where(mask, 0.0, -3e38).to(torch.bfloat16)
        scores = scores.to(torch.bfloat16) + bias[None, None, None]
        probs = _softmax_bf16(scores).to(v.dtype)
    else:
        scores = torch.einsum("bqkrh,bskh->bkrqs", qh, k).to(_F32)
        scores = scores * f32_inv_sqrt(hd)
        bias = torch.where(mask, 0.0, -1e30)  # (bq, s) float32
        scores = scores + bias[None, None, None]
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", probs, v)
    return out.reshape(b, bq, h * hd)


def attention_apply(
    params: Params,
    dims: AttnDims,
    x: torch.Tensor,
    positions: torch.Tensor,
    causal: bool = True,
    return_kv: bool = False,
):
    """Training/prefill attention, q-chunked (no (S, S) materialisation).

    The last block is padded when ``q_block`` does not divide S; its real
    rows keep their own positions and the padded rows take the last one.
    (The reference slices the unpadded positions with a clamped
    ``dynamic_slice``, which gives the real rows of a padded last block the
    positions of an earlier window: ROADMAP Queue 3.)
    """
    b, s, _ = x.shape
    q, k, v = _qkv(params, dims, x, positions)
    blk = min(dims.q_block, s)
    pad = (-s) % blk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    nblk = q.shape[1] // blk
    kpos = positions[0] if positions.ndim > 1 else positions
    qpos_all = torch.cat([kpos, kpos[-1:].expand(pad)]) if pad else kpos
    outs = [
        _attend_block(q[:, i * blk:(i + 1) * blk], k, v, qpos_all[i * blk:(i + 1) * blk],
                      kpos, dims, causal)
        for i in range(nblk)
    ]
    out = torch.cat(outs, dim=1)[:, :s] @ params["wo"].to(x.dtype)
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(
    params: Params,
    dims: AttnDims,
    x: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    index: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode step against a KV cache.

    x: (B, 1, d); cache_k/v: (B, S_cache, KV, hd); index: the token's
    position.  Returns (out (B, 1, d), cache_k, cache_v).  For sliding-window
    layers the cache is a ring buffer of size ``window``.  The new key and
    value are written into the cache tensors in place (the reference's serve
    step donates its cache).
    """
    index = int(index)
    b = x.shape[0]
    h, kvh, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    s_cache = cache_k.shape[1]
    pos = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(params, dims, x, pos)
    slot = index % s_cache if dims.window > 0 else index
    cache_k[:, slot] = k_new[:, 0]
    cache_v[:, slot] = v_new[:, 0]

    rep = h // kvh
    qh = q.reshape(b, 1, kvh, rep, hd)
    scores = torch.einsum("bqkrh,bskh->bkrqs", qh, cache_k).to(_F32)
    scores = scores * f32_inv_sqrt(hd)
    cache_pos = torch.arange(s_cache, device=x.device)
    if dims.window > 0:
        # Ring buffer: once it has wrapped every slot holds one of the last
        # ``window`` positions (ring size == window).
        mask = cache_pos <= slot if index < s_cache else None
    else:
        mask = cache_pos <= index
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", probs, cache_v).reshape(b, 1, h * hd)
    return out @ params["wo"].to(x.dtype), cache_k, cache_v


def cross_attention_apply(params: Params, dims: AttnDims, x: torch.Tensor,
                          enc_kv: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder keys and values
    (whisper): every query sees every encoder position, no rope on q."""
    b, s, _ = x.shape
    h, kvh, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, h, hd)
    k, v = enc_kv
    qh = q.reshape(b, s, kvh, h // kvh, hd)
    scores = torch.einsum("bqkrh,bskh->bkrqs", qh, k).to(_F32) * f32_inv_sqrt(hd)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", probs, v).reshape(b, s, h * hd)
    return out @ params["wo"].to(x.dtype)


def encoder_kv(params: Params, dims: AttnDims, enc_out: torch.Tensor):
    """A cross-attention layer's keys and values of the encoder output:
    (B, F, KV, hd) each."""
    b, s, _ = enc_out.shape
    kvh, hd = dims.n_kv_heads, dims.head_dim
    k = (enc_out @ params["wk"].to(enc_out.dtype)).reshape(b, s, kvh, hd)
    v = (enc_out @ params["wv"].to(enc_out.dtype)).reshape(b, s, kvh, hd)
    return k, v


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(gen, d: int, ff: int, device, dtype=_F32) -> Params:
    return {
        "w_gate": _dense_init(gen, (d, ff), device, dtype=dtype),
        "w_up": _dense_init(gen, (d, ff), device, dtype=dtype),
        "w_down": _dense_init(gen, (ff, d), device, dtype=dtype),
    }


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    gate = F.silu(x @ params["w_gate"].to(dt))
    up = x @ params["w_up"].to(dt)
    return (gate * up) @ params["w_down"].to(dt)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def init_embedding(gen, vocab: int, d: int, device, dtype=_F32) -> Params:
    return {"table": _normal(gen, (vocab, d), device).mul_(0.02).to(dtype)}


def embed(params: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # Gather, then cast: the rows the reference's cast-then-gather gives,
    # without casting the whole table.
    return F.embedding(tokens, params["table"]).to(dtype)


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["table"].to(x.dtype).T


def init_lm_head(gen, d: int, vocab: int, device, dtype=_F32) -> Params:
    return {"w": _dense_init(gen, (d, vocab), device, dtype=dtype)}


def lm_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].to(x.dtype)
