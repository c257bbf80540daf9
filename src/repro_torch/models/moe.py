"""Mixture-of-Experts FFN on one card (counterpart of ``repro.models.moe``).

Top-k routing over a float32 softmax, then one of two compute paths:

- ``dispatch`` (``_moe_local``), for the forward pass and the prefill: the
  routed (token, expert) pairs are stably sorted by expert, each expert
  takes up to ``capacity`` of them in that order into a fixed
  (E, capacity, d) buffer, and the rest are dropped.  Integer slot -> token
  and slot -> gate maps are built first (a one-past-end dump slot takes
  every invalid write), the tokens are gathered straight into the buffers,
  the experts run as batched SwiGLU products, and a scatter-add
  (``index_add_``) combines each slot's gated output into its token.  The
  (T, E) one-hot dispatch tensor never exists.
- ``dense`` (``_moe_dense_local``), for the decode step: every expert runs on
  the few tokens and the router's gates mask the results.

Ties: ``lax.top_k`` and the reference's stable ``argsort`` put the lower
index first; here a stable descending sort gives the top k, and
``torch.sort(stable=True)`` the expert order, so the same tokens are kept
and dropped.  On CUDA the combine's ``index_add_`` may sum a token's expert
outputs in an order that changes from run to run (its last bits move; the
same note as Lloyd's centroid update).

``mesh=`` must be ``None``: expert parallelism over a mesh (the reference's
``shard_map`` with one ``psum``) is ROADMAP Queue 1 item 22 (b), part 2.
``router_init_from_ckm`` turns CKM centroids of token activations into
router weights (the paper tie-in).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init

Params = dict[str, Any]
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


def init_moe(gen, dims: MoEDims, device, dtype=_F32) -> Params:
    e, d, f = dims.n_experts, dims.d_model, dims.d_ff
    return {
        "router": _dense_init(gen, (d, e), device, dtype=dtype),
        "w_gate": _dense_init(gen, (e, d, f), device, in_axis=1, dtype=dtype),
        "w_up": _dense_init(gen, (e, d, f), device, in_axis=1, dtype=dtype),
        "w_down": _dense_init(gen, (e, f, d), device, in_axis=1, dtype=dtype),
    }


def route(params: Params, dims: MoEDims, x_flat: torch.Tensor):
    """Top-k routing.  x_flat: (T, d) -> (gates (T, k) float32, ids (T, k)
    int64, the load-balance aux loss)."""
    logits = x_flat.to(_F32) @ params["router"].to(_F32)
    probs = torch.softmax(logits, dim=-1)
    # Descending and stable: among equal probabilities the lower expert
    # first, as lax.top_k.
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :dims.top_k], ids[:, :dims.top_k]
    gates = gates / torch.clamp(torch.sum(gates, dim=-1, keepdim=True), min=1e-9)
    # Load-balance aux loss (Switch): E * sum_e f_e * p_e.
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(ids[:, 0], dims.n_experts).to(_F32), dim=0)
    aux = dims.n_experts * torch.sum(me * ce)
    return gates, ids, aux


def _capacity(t_local: int, dims: MoEDims) -> int:
    cap = int(t_local * dims.top_k * dims.capacity_factor / dims.n_experts) + 1
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8


def _expert_ffn(w_gate, w_up, w_down, h):
    """h: (E, C, d) -> (E, C, d); SwiGLU per expert (batched products)."""
    dt = h.dtype
    g = F.silu(torch.bmm(h, w_gate.to(dt)))
    u = torch.bmm(h, w_up.to(dt))
    return torch.bmm(g * u, w_down.to(dt))


def _moe_local(x_flat, gates, ids, w_gate, w_up, w_down, e_start: int,
               n_experts_total: int, capacity: int) -> torch.Tensor:
    """Sort-and-scatter MoE over the expert slice [e_start, e_start + E).

    x_flat: (T, d); gates / ids: (T, k); w_*: (E, ...).  Returns the slice's
    output (T, d): zeros for tokens whose experts lie outside it, and for a
    (token, expert) pair past the expert's capacity.
    """
    t, d = x_flat.shape
    k = ids.shape[1]
    e_local = w_gate.shape[0]
    dev = x_flat.device
    sorted_ids, order = torch.sort(ids.reshape(-1), stable=True)
    counts = torch.bincount(sorted_ids, minlength=n_experts_total)
    starts = torch.cumsum(counts, 0) - counts  # exclusive prefix
    pos_in_expert = torch.arange(t * k, device=dev) - starts[sorted_ids]

    valid = ((sorted_ids >= e_start) & (sorted_ids < e_start + e_local)
             & (pos_in_expert < capacity))
    dump = e_local * capacity  # one-past-end slot for every invalid write
    slot = torch.where(valid, (sorted_ids - e_start) * capacity + pos_in_expert, dump)

    # Integer slot -> token and slot -> gate maps; unfilled slots read token
    # 0 with gate 0.  Valid slots are unique, so only the dump slot (cut
    # below) takes several writes.
    slot_token = torch.zeros((dump + 1,), dtype=torch.int64, device=dev)
    slot_token[slot] = torch.where(valid, order // k, 0)
    slot_gate = torch.zeros((dump + 1,), dtype=_F32, device=dev)
    slot_gate[slot] = torch.where(valid, gates.reshape(-1)[order], 0.0)
    slot_token, slot_gate = slot_token[:-1], slot_gate[:-1]

    buffers = x_flat[slot_token]  # (E * C, d) gather
    h = _expert_ffn(w_gate, w_up, w_down, buffers.reshape(e_local, capacity, d))
    h = h.reshape(-1, d) * slot_gate[:, None].to(x_flat.dtype)
    # Combine: scatter-add each slot's gated output into its token.
    return torch.zeros((t, d), dtype=x_flat.dtype, device=dev).index_add_(0, slot_token, h)


def _moe_dense_local(x_flat, gates, ids, w_gate, w_up, w_down, e_start: int) -> torch.Tensor:
    """Decode path: every expert of the slice on every token, router-masked."""
    e_local = w_gate.shape[0]
    t, d = x_flat.shape
    h = x_flat[None].expand(e_local, t, d)
    y = _expert_ffn(w_gate, w_up, w_down, h)  # (E, T, d)
    experts = torch.arange(e_local, device=x_flat.device)[:, None, None] + e_start
    w = torch.sum(torch.where(ids[None] == experts, gates[None], 0.0), dim=-1)  # (E, T)
    return torch.einsum("etd,et->td", y, w.to(x_flat.dtype))


def moe_apply(params: Params, dims: MoEDims, x: torch.Tensor, mesh=None,
              dense_path: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN.  x: (B, S, d) -> (out (B, S, d), aux loss scalar)."""
    if mesh is not None:
        raise NotImplementedError(
            "the MoE runs on one card: mesh must be None (expert parallelism is ROADMAP "
            "Queue 1 item 22 (b), part 2)"
        )
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    gates, ids, aux = route(params, dims, x_flat)
    ws = (params["w_gate"], params["w_up"], params["w_down"])
    if dense_path:
        out = _moe_dense_local(x_flat, gates, ids, *ws, 0)
    else:
        out = _moe_local(x_flat, gates, ids, *ws, 0, dims.n_experts,
                         _capacity(x_flat.shape[0], dims))
    return out.reshape(b, s, d), aux


def router_init_from_ckm(centroids: torch.Tensor, d_model: int) -> torch.Tensor:
    """Router weights (d, E) from CKM centroids (E, d) of a stream of token
    activations: the logit of expert e is the inner product with its
    normalised centroid (k-means assignment as a routing prior)."""
    c = centroids / torch.clamp(torch.linalg.norm(centroids, dim=1, keepdim=True), min=1e-6)
    return c.T.to(_F32)
