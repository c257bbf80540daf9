"""Recurrent sequence mixers (counterpart of ``repro.models.ssm``): Mamba
(selective SSM, jamba's), mLSTM and sLSTM (xLSTM's).

- Mamba's diagonal recurrence runs over fixed-size chunks, one after
  another, with a log-depth (Hillis-Steele) scan of the ``(a, b)`` pairs
  under the reference's ``combine`` within a chunk: the (B, chunk, d_inner,
  d_state) float32 tensors exist for one chunk at a time, and no step
  divides by a cumulative product of ``a`` (``exp(dt A)`` underflows over a
  chunk).  PyTorch has no ``associative_scan``; the scan's association
  order differs from the reference's, within float32 rounding.
- mLSTM is the chunkwise gated-linear-attention form: O(chunk^2) attention
  within a chunk and a carried matrix state between chunks; every gate
  exponent is a difference that is at most 0.
- sLSTM has no parallel form: ``W x`` is one product over the sequence, and
  the ``h R`` recurrence a loop over time steps (host-bound on a card: one
  set of small launches a step).

Each mixer has ``init``, ``apply`` (full sequence -> outputs and the final
state) and ``step`` (one token).  States are float32 except Mamba's
convolution window and sLSTM's ``h``, which take the activations' dtype.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init, _normal, f32_sqrt, to_bf16

Params = dict[str, Any]
_F32 = torch.float32


# ---------------------------------------------------------------------------
# Mamba (selective SSM), as in Jamba's Mamba layers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MambaDims:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(self.d_model // 16, 1)


def init_mamba(gen, dims: MambaDims, device, dtype=_F32) -> Params:
    di, ds, dr = dims.d_inner, dims.d_state, dims.dt_rank

    def const(t):
        return t.to(device=device, dtype=dtype)

    return {
        "in_proj": _dense_init(gen, (dims.d_model, 2 * di), device, dtype=dtype),
        "conv_w": _normal(gen, (dims.d_conv, di), device).mul_(0.1).to(dtype),
        "conv_b": const(torch.zeros((di,))),
        "x_proj": _dense_init(gen, (di, dr + 2 * ds), device, dtype=dtype),
        "dt_proj": _dense_init(gen, (dr, di), device, dtype=dtype),
        "dt_bias": const(torch.full((di,), -2.0)),  # softplus(-2) ~ 0.13
        "a_log": const(torch.log(torch.arange(1, ds + 1, dtype=_F32)).repeat(di, 1)),
        "d_skip": const(torch.ones((di,))),
        "out_proj": _dense_init(gen, (di, dims.d_model), device, dtype=dtype),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal convolution over time.  x: (B, S, di); w: (dconv, di).

    ``state``: (B, dconv - 1, di), the trailing inputs of the previous
    segment.  Returns (y, new_state); the new state is a tensor of its own
    (not a view holding the whole padded sequence)."""
    dconv = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], dconv - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype) for i in range(dconv))
    return y + b.to(x.dtype), xp[:, -(dconv - 1):, :].clone()


def _scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of the pairs (a, b) under the reference's
    ``combine((al, bl), (ar, br)) = (al ar, ar bl + br)``, in log2(c) levels:
    at offset o each element combines with the one o before it (the first o
    with the identity (1, 0))."""
    o = 1
    while o < a.shape[1]:
        pad = (0, 0) * (a.dim() - 2) + (o, 0)  # o leading entries on axis 1
        b = a * F.pad(b[:, :-o], pad) + b
        a = a * F.pad(a[:, :-o], pad, value=1.0)
        o *= 2
    return a, b


def _ssm_scan_chunked(dt, b_in, c_in, xc, a, h0, chunk: int):
    """Selective-SSM recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,
    y_t = h_t . C_t, one chunk at a time.

    dt: (B, S, di) float32; b_in, c_in: (B, S, ds); xc: (B, S, di); a: (di,
    ds).  S is a multiple of ``chunk``.  Returns (y (B, S, di) float32,
    h_final (B, di, ds) float32)."""
    h = h0
    ys = []
    for start in range(0, dt.shape[1], chunk):
        sl = slice(start, start + chunk)
        dt_c = dt[:, sl, :, None]
        a_bar = torch.exp(dt_c * a)  # (B, c, di, ds): this chunk only
        bx = dt_c * b_in[:, sl, None, :].to(_F32) * xc[:, sl, :, None].to(_F32)
        a_cum, b_cum = _scan(a_bar, bx)
        h_all = a_cum * h[:, None] + b_cum
        ys.append(torch.sum(h_all * c_in[:, sl, None, :].to(_F32), dim=-1))
        h = h_all[:, -1].clone()
    return torch.cat(ys, dim=1), h


def mamba_specs(dims: MambaDims, mesh) -> dict:
    """The specs of a Mamba mixer's parameters on ``mesh`` (the rules of
    ``parallel.sharding`` at these dims' full shapes)."""
    from repro_torch.parallel import sharding as sh

    return _mamba_specs(dims, tuple(sh.axis_sizes(mesh).items()))


@functools.lru_cache(maxsize=None)
def _mamba_specs(dims: MambaDims, sizes_key: tuple) -> dict:
    from repro_torch.parallel import sharding as sh

    meta = init_mamba(None, dims, torch.device("meta"))
    return {k: sh.leaf_spec(f"mixer/{k}", tuple(v.shape), "hybrid", dict(sizes_key))
            for k, v in meta.items()}


def mamba_apply(params: Params, dims: MambaDims, x: torch.Tensor,
                state: Params | None = None, mesh=None,
                seq_shard: bool = False) -> tuple[torch.Tensor, Params]:
    """Full-sequence Mamba mixer.  x: (B, S, d_model) -> (out, final state).

    On a mesh (``params`` the rank's pieces, ``state`` its channels): the
    channels (d_inner) go over "model" where it divides them.  Each rank
    runs the convolution and the scan on its channels; ``x_proj``'s product
    (dt, B and C read every channel) and ``out_proj``'s each take one
    all-reduce over "model".  ``in_proj`` is stored as contiguous columns
    over "model" (the reference's placement), which splits x from z rather
    than channels, so it is gathered and each rank takes its channels' x
    and z columns.  With ``seq_shard`` x and out are this rank's block of
    the sequence over "model" (``collectives.region_input``)."""
    from repro_torch.parallel import collectives as C

    sp = C.as_spmd(mesh)
    if sp is None:
        return _mamba(params, dims, x, state, dims.d_inner)
    specs = mamba_specs(dims, sp)
    m, di = sp.model, dims.d_inner
    if m == 1 or di % m:
        used = {k: C.use_param(v, specs[k], sp, tensor_parallel=False) for k, v in params.items()}
        out, st = _mamba(used, dims, C.region_input(x, sp, False, seq_shard), state, di)
        return C.region_output(out, sp, False, seq_shard), st
    used = {k: C.use_param(v, specs[k], sp, tensor_parallel=True) for k, v in params.items()
            if k != "in_proj"}
    full = C.use_param(params["in_proj"], specs["in_proj"], sp, tensor_parallel=False,
                       model_grad="sum")
    dl, r = di // m, sp.rank("model")
    used["in_proj"] = torch.cat([full[:, r * dl:(r + 1) * dl],
                                 full[:, di + r * dl:di + (r + 1) * dl]], dim=1)
    out, st = _mamba(used, dims, C.region_input(x, sp, True, seq_shard), state, dl,
                     dbc_hook=lambda t: C.reduce_both(t, sp, ("model",)))
    return C.region_output(out, sp, True, seq_shard), st


def _mamba(params: Params, dims: MambaDims, x: torch.Tensor, state, di: int,
           dbc_hook=None) -> tuple[torch.Tensor, Params]:
    """Mamba on ``di`` channels (all of them, or a rank's): ``params["in_proj"]``
    holds their x columns, then their z columns."""
    b, s, _ = x.shape
    dt_ = x.dtype
    ds, dr = dims.d_state, dims.dt_rank
    xz = x @ params["in_proj"].to(dt_)
    xs_, z = torch.split(xz, di, dim=-1)
    conv_state = None if state is None else state["conv"]
    xc, conv_state = _causal_conv(xs_, params["conv_w"], params["conv_b"], conv_state)
    xc = F.silu(xc)

    dbc = xc @ params["x_proj"].to(dt_)
    if dbc_hook is not None:
        dbc = dbc_hook(dbc)
    dt_raw, b_ssm, c_ssm = torch.split(dbc, [dr, ds, ds], dim=-1)
    dt = F.softplus(dt_raw @ params["dt_proj"].to(dt_) + params["dt_bias"].to(dt_)).to(_F32)
    a = -torch.exp(params["a_log"])  # (di, ds)
    h0 = (torch.zeros((b, di, ds), dtype=_F32, device=x.device) if state is None
          else state["ssm"].to(_F32))
    chunk = min(dims.chunk, s)
    pad = (-s) % chunk
    xc_p = xc
    if pad:
        # dt = 0 on the padding: a_bar = 1, bx = 0, the state passes unchanged.
        dt, b_ssm, c_ssm, xc_p = (F.pad(t, (0, 0, 0, pad)) for t in (dt, b_ssm, c_ssm, xc))
    y, h_final = _ssm_scan_chunked(dt, b_ssm, c_ssm, xc_p, a, h0, chunk)
    y = y[:, :s].to(dt_) + params["d_skip"].to(dt_) * xc
    y = y * F.silu(z)
    return y @ params["out_proj"].to(dt_), {"conv": conv_state, "ssm": h_final}


def mamba_init_state(dims: MambaDims, batch: int, dtype, device) -> Params:
    return {
        "conv": torch.zeros((batch, dims.d_conv - 1, dims.d_inner), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, dims.d_inner, dims.d_state), dtype=_F32, device=device),
    }


def mamba_step(params: Params, dims: MambaDims, x: torch.Tensor,
               state: Params, mesh=None) -> tuple[torch.Tensor, Params]:
    """Single-token decode.  x: (B, 1, d_model)."""
    return mamba_apply(params, dims, x, state, mesh=mesh)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell), chunkwise gated linear attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLSTMDims:
    d_model: int
    n_heads: int = 4
    expand: int = 2
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


def init_mlstm(gen, dims: MLSTMDims, device, dtype=_F32) -> Params:
    d, di, h = dims.d_model, dims.d_inner, dims.n_heads

    def dense(shape):
        return _dense_init(gen, shape, device, dtype=dtype)

    return {
        "up_proj": dense((d, di)),
        "wq": dense((di, di)),
        "wk": dense((di, di)),
        "wv": dense((di, di)),
        "w_gates": dense((d, 2 * h)),  # (input, forget) per head
        "w_ogate": dense((d, di)),
        "down_proj": dense((di, d)),
    }


def _mlstm_chunk(q, k, v, log_f, log_i, state):
    """One chunk of the stabilised gated-linear-attention recurrence.

    q, k, v: (B, c, H, hd); log_f, log_i: (B, c, H) float32 (both <= 0).
    state: {"C": (B, H, hd, hd), "n": (B, H, hd)} float32.
    """
    c = q.shape[1]
    qf, kf, vf = q.to(_F32), k.to(_F32), v.to(_F32)
    cum_f = torch.cumsum(log_f, dim=1)  # (B, c, H), inclusive
    # Within the chunk: gate(i, j) = exp(cum_f[i] - cum_f[j] + log_i[j]) for
    # j <= i, an exponent <= 0.  Above the diagonal the exponent is masked to
    # -inf before the exp, not after: there it can pass 88 (cum_f falls by up
    # to 8 a position), and exp's overflow to inf times where's zero gradient
    # is a NaN gradient (the reference's where-after-exp gives NaN gradients
    # at chunks of 256; ROADMAP Queue 3).  exp(-inf) = 0: the same forward.
    expo = cum_f[:, :, None, :] - cum_f[:, None, :, :] + log_i[:, None, :, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    gate = torch.exp(expo.masked_fill(~mask[None, :, :, None], float("-inf")))  # (B, c, c, H)
    scores = torch.einsum("bihd,bjhd->bijh", qf, kf) * gate
    h_intra = torch.einsum("bijh,bjhd->bihd", scores, vf)
    n_intra = torch.einsum("bijh,bjhd->bihd", gate, kf)
    # Across chunks: a decayed read of the carried state.
    decay_q = torch.exp(cum_f)  # (B, c, H)
    h_inter = torch.einsum("bihd,bhde->bihe", qf, state["C"]) * decay_q[..., None]
    n_inter = state["n"][:, None] * decay_q[..., None]
    # The normalised read-out: h / max(|n . q|, 1).
    n_tot = n_intra + n_inter
    denom = torch.clamp(torch.abs(torch.sum(n_tot * qf, dim=-1, keepdim=True)), min=1.0)
    out = (h_intra + h_inter) / denom
    # The state at the end of the chunk (exponents again <= 0).
    wgt = torch.exp(cum_f[:, -1:, :] - cum_f + log_i)  # (B, c, H)
    last = torch.exp(cum_f[:, -1])  # (B, H)
    c_new = state["C"] * last[..., None, None] + torch.einsum("bjh,bjhd,bjhe->bhde", wgt, kf, vf)
    n_new = state["n"] * last[..., None] + torch.einsum("bjh,bjhd->bhd", wgt, kf)
    return out, {"C": c_new, "n": n_new}


def mlstm_apply(params: Params, dims: MLSTMDims, x: torch.Tensor,
                state: Params | None = None) -> tuple[torch.Tensor, Params]:
    b, s, _ = x.shape
    dt_ = x.dtype
    h, hd, di = dims.n_heads, dims.head_dim, dims.d_inner
    u = F.silu(x @ params["up_proj"].to(dt_))
    q = (u @ params["wq"].to(dt_)).reshape(b, s, h, hd)
    sqrt_hd = f32_sqrt(hd)
    k = (u @ params["wk"].to(dt_)).reshape(b, s, h, hd) / (
        to_bf16(sqrt_hd) if dt_ == torch.bfloat16 else sqrt_hd)
    v = (u @ params["wv"].to(dt_)).reshape(b, s, h, hd)
    gates = (x @ params["w_gates"].to(dt_)).to(_F32)
    log_i = F.logsigmoid(gates[..., :h])  # the clamped input gate (<= 0)
    log_f = torch.clamp(F.logsigmoid(gates[..., h:]), min=-8.0)

    if state is None:
        state = mlstm_init_state(dims, b, x.device)
    c = min(dims.chunk, s)
    pad = (-s) % c
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-30.0)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    outs = []
    for start in range(0, q.shape[1], c):
        sl = slice(start, start + c)
        out, state = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], log_f[:, sl], log_i[:, sl],
                                  state)
        outs.append(out)
    out = torch.cat(outs, dim=1)[:, :s].reshape(b, s, di).to(dt_)
    ogate = torch.sigmoid(x @ params["w_ogate"].to(dt_))
    return (out * ogate) @ params["down_proj"].to(dt_), state


def mlstm_init_state(dims: MLSTMDims, batch: int, device) -> Params:
    h, hd = dims.n_heads, dims.head_dim
    return {
        "C": torch.zeros((batch, h, hd, hd), dtype=_F32, device=device),
        "n": torch.zeros((batch, h, hd), dtype=_F32, device=device),
    }


def mlstm_step(params: Params, dims: MLSTMDims, x: torch.Tensor, state: Params):
    """Single-token decode: the chunkwise path with a chunk of 1."""
    return mlstm_apply(params, dims, x, state)


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar cell): sequential by construction
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLSTMDims:
    d_model: int
    heads: int = 4  # block-diagonal recurrence, as in the xLSTM paper

    @property
    def head_dim(self) -> int:
        return self.d_model // self.heads


def init_slstm(gen, dims: SLSTMDims, device, dtype=_F32) -> Params:
    d, h, dh = dims.d_model, dims.heads, dims.head_dim
    return {
        "w": _dense_init(gen, (d, 4 * d), device, dtype=dtype),  # i, f, z, o from x
        # Block-diagonal recurrent matrix: heads do not mix through R.
        "r": _dense_init(gen, (h, dh, 4 * dh), device, in_axis=1).mul_(0.1).to(dtype),
        "b": torch.zeros((4 * d,), dtype=dtype, device=device),
    }


def _slstm_cell(params: Params, wx_t: torch.Tensor, st: Params) -> Params:
    """One time step.  wx_t: (B, 4d), the precomputed W x_t; st: (B, d) each."""
    bsz, d = st["h"].shape
    r = params["r"]
    h_heads = st["h"].reshape(bsz, r.shape[0], r.shape[1])
    rec = torch.einsum("bhd,hde->bhe", h_heads.to(wx_t.dtype), r.to(wx_t.dtype))
    # The per-head [i|f|z|o] blocks in the (B, 4d) layout of W x.
    rec = rec.reshape(bsz, r.shape[0], 4, -1).transpose(1, 2).reshape(bsz, 4 * d)
    gates = (wx_t + rec).to(_F32) + params["b"].to(_F32)
    i_log, f_log, z_raw, o_raw = torch.chunk(gates, 4, dim=-1)
    f_log = F.logsigmoid(f_log)
    m_new = torch.maximum(f_log + st["m"], i_log)
    i_g = torch.exp(i_log - m_new)
    f_g = torch.exp(f_log + st["m"] - m_new)
    c_new = f_g * st["c"] + i_g * torch.tanh(z_raw)
    n_new = torch.clamp(f_g * st["n"] + i_g, min=1e-6)
    h_new = torch.sigmoid(o_raw) * c_new / n_new
    return {"h": h_new.to(st["h"].dtype), "c": c_new, "n": n_new, "m": m_new}


def slstm_apply(params: Params, dims: SLSTMDims, x: torch.Tensor,
                state: Params | None = None) -> tuple[torch.Tensor, Params]:
    b, s, _ = x.shape
    wx = x @ params["w"].to(x.dtype)  # (B, S, 4d): one product
    if state is None:
        state = slstm_init_state(dims, b, x.dtype, x.device)
    hs = []
    for t in range(s):
        state = _slstm_cell(params, wx[:, t], state)
        hs.append(state["h"])
    return torch.stack(hs, dim=1).to(x.dtype), state


def slstm_init_state(dims: SLSTMDims, batch: int, dtype, device) -> Params:
    d = dims.d_model
    return {
        "h": torch.zeros((batch, d), dtype=dtype, device=device),
        "c": torch.zeros((batch, d), dtype=_F32, device=device),
        "n": torch.ones((batch, d), dtype=_F32, device=device),
        "m": torch.zeros((batch, d), dtype=_F32, device=device),
    }


def slstm_step(params: Params, dims: SLSTMDims, x: torch.Tensor, state: Params):
    """x: (B, 1, d)."""
    wx = x[:, 0] @ params["w"].to(x.dtype)
    state = _slstm_cell(params, wx, state)
    return state["h"][:, None, :].to(x.dtype), state
