"""CKM-compressed KV cache for long-context decode (counterpart of
``repro.serve.kv_clustering``).

The paper reads a dataset as a mixture of K weighted Diracs recovered from a
sketch.  A transformer's KV cache is a point cloud per head, so each
global-attention head's S keys are compressed into K centroids with weights
(cluster sizes), and decode-time attention runs over [centroids + a ring of
recent tokens]:

    softmax_j( q.k_j )  over S keys   ~   softmax_c( q.ck_c + log w_c ) over K
                                          centroids (+ the exact recent ring)

The ``log w_c`` bias makes a centroid of w collapsed keys contribute like w
near-identical keys.  Compression runs with CKM (``core.ckm.fit``: the
sketch through kernel 1, the CLOMPR decode) or with Lloyd-Max
(``core.lloyd.lloyd``, kernel 2); both assign the keys with
``core.ckm.predict`` (kernel 2) and summarise each cluster by the mean of
its members' keys and values.

Randomness: a compression takes an integer ``seed``; head ``i`` (of the
``B * KV`` heads, batch-major) clusters with ``derive_seed(seed, 0, i)``
and CKM's sigma^2 sample draws from ``derive_seed(seed, 1)`` (the
reference splits one PRNG key).  A loop over the heads replaces the
reference's ``vmap``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import device as dev_mod
from repro_torch.core import ckm as ckm_mod
from repro_torch.core import frequencies as fq
from repro_torch.core import lloyd as lloyd_mod
from repro_torch.models import layers as L

Params = dict[str, Any]

# CKM's sigma^2 sample: the first keys of the flattened heads.
SIGMA2_SAMPLE = 4096
# The frequency scale's boost for Dirac-like key clouds.
SIGMA2_BOOST = 6.0


def compress_head(seed: int, keys_1h: torch.Tensor, values_1h: torch.Tensor,
                  n_centroids: int, method: str = "lloyd",
                  ckm_cfg: ckm_mod.CKMConfig | None = None):
    """Compress one head's cache.  keys/values: (S, hd) -> (K, hd) x 2 +
    log-weights (K,), float32, on the keys' device."""
    dev = keys_1h.device
    keys = keys_1h.to(torch.float32).contiguous()
    if method == "ckm":
        cents = ckm_mod.fit(seed, keys, ckm_cfg, device=dev).centroids
    else:
        cents = lloyd_mod.lloyd(
            seed, keys, lloyd_mod.LloydConfig(k=n_centroids, max_iters=25, init="kpp"),
            device=dev,
        ).centroids
    assign = ckm_mod.predict(keys, cents, device=dev)
    one_hot = F.one_hot(assign, n_centroids).to(torch.float32)  # (S, K)
    counts = torch.sum(one_hot, dim=0)  # (K,)
    # Centroid value = mean of member values; key = mean of member keys
    # (recomputed from the hard assignment for both methods).
    denom = torch.clamp(counts[:, None], min=1.0)
    ck = (one_hot.T @ keys) / denom
    cv = (one_hot.T @ values_1h.to(torch.float32)) / denom
    logw = torch.where(counts > 0, torch.log(torch.clamp(counts, min=1.0)), -1e30)
    return ck, cv, logw


def compress_kv(seed: int, k: torch.Tensor, v: torch.Tensor, n_centroids: int,
                method: str = "lloyd"):
    """k, v: (B, S, KV, hd) -> dict(ck (B, K, KV, hd), cv, clogw (B, K, KV)).

    Offline (per-compression-epoch) path, not part of the decode step.  For
    ``method="ckm"`` one frequency scale is estimated from a key sample and
    shared across heads (boosted x6 for the Dirac regime).
    """
    b, s, kvh, hd = k.shape
    dev = k.device
    kk = k.permute(0, 2, 1, 3).reshape(b * kvh, s, hd)
    vv = v.permute(0, 2, 1, 3).reshape(b * kvh, s, hd)
    ckm_cfg = None
    if method == "ckm":
        sample = kk.reshape(-1, hd)[:SIGMA2_SAMPLE].to(torch.float32)
        gen = dev_mod.generator(dev_mod.derive_seed(seed, 1), dev)
        s2 = float(fq.estimate_sigma2(gen, sample, device=dev)) * SIGMA2_BOOST
        ckm_cfg = ckm_mod.CKMConfig(
            k=n_centroids, m=5 * n_centroids * hd, sigma2=s2,
            init="sample", atom_steps=80, joint_steps=60, nnls_iters=40,
            final_steps=200, atom_restarts=2,
        )
    heads = [
        compress_head(dev_mod.derive_seed(seed, 0, i), kk[i], vv[i], n_centroids, method,
                      ckm_cfg)
        for i in range(b * kvh)
    ]
    ck, cv, logw = (torch.stack(t) for t in zip(*heads))
    ck = ck.reshape(b, kvh, n_centroids, hd).permute(0, 2, 1, 3).to(k.dtype).contiguous()
    cv = cv.reshape(b, kvh, n_centroids, hd).permute(0, 2, 1, 3).to(v.dtype).contiguous()
    clogw = logw.reshape(b, kvh, n_centroids).permute(0, 2, 1).contiguous()
    return {"ck": ck, "cv": cv, "clogw": clogw}


def build_compressed_cache(seed: int, k: torch.Tensor, v: torch.Tensor, n_centroids: int,
                           ring: int, method: str = "lloyd") -> Params:
    """Full compressed-cache constructor for a prefix of S tokens.

    Position layout (S = k.shape[1], decode continues at index S):
    - centroids cover positions [0, S-ring] (inclusive),
    - the exact ring holds positions (S-ring, S): ring-1 entries at their
      ``pos % ring`` slots, leaving slot ``S % ring`` vacant for the incoming
      token (so the first decode step overwrites nothing live).
    Tokens that age out of the ring between recompressions are approximated
    only by the centroid mass.
    """
    b, s, kvh, hd = k.shape
    if not s > ring >= 1:
        raise ValueError(f"need S > ring >= 1, got S={s}, ring={ring}")
    split = s - ring + 1  # centroids cover [0, split)
    comp = compress_kv(seed, k[:, :split], v[:, :split], n_centroids, method)
    ring_k = torch.zeros((b, ring, kvh, hd), dtype=k.dtype, device=k.device)
    ring_v = torch.zeros((b, ring, kvh, hd), dtype=v.dtype, device=v.device)
    slots = torch.arange(split, s, device=k.device) % ring
    ring_k[:, slots] = k[:, split:]
    ring_v[:, slots] = v[:, split:]
    return {**comp, "k": ring_k, "v": ring_v}


def attention_decode_compressed(
    params: Params,
    dims: L.AttnDims,
    x: torch.Tensor,
    cache: Params,
    index: int,
    sp=None,
    centroids_split: bool = True,
    ring_split: bool = True,
):
    """Decode attention over [centroids + recent ring].  x: (B, 1, d).

    cache: {"ck", "cv", "clogw", "k", "v"}: the raw ring ("k", "v") holds the
    most recent tokens exactly; older history lives in the weighted
    centroids.  Returns (out (B, 1, d), the ring's entries); the new token is
    written into the ring in place.

    With ``sp`` (a ``parallel.collectives.Spmd``) the centroids (with
    ``centroids_split``) and the ring (with ``ring_split``) are this rank's
    blocks of them over "model"; a part that is not split is counted by
    "model"-rank 0 alone.  The rank that holds the new token's ring slot
    writes it, and the softmax's max and sums are all-reduced over "model"
    (``layers._sharded_softmax_pv``)."""
    if not (centroids_split or ring_split):
        sp = None  # every rank holds the whole cache
    index = int(index)
    b = x.shape[0]
    h, kvh, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    r = 0 if sp is None else sp.rank("model")
    ring_local = cache["k"].shape[1]
    split = sp is not None and ring_split
    ring = ring_local * sp.model if split else ring_local
    pos = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
    q, k_new, v_new = L._qkv(params, dims, x, pos)
    slot = index % ring
    owner, off = divmod(slot, ring_local) if split else (r, slot)
    ck_ring, cv_ring = cache["k"], cache["v"]
    if owner == r:
        ck_ring[:, off] = k_new[:, 0]
        cv_ring[:, off] = v_new[:, 0]

    rep = h // kvh
    qh = q.reshape(b, 1, kvh, rep, hd)
    sqrt_hd = L.f32_sqrt(hd)
    parts = []  # (scores, values) this rank counts
    if sp is None or centroids_split or r == 0:
        # Scores over centroids, with the log-cluster-size bias.
        s_cent = torch.einsum("bqkrh,bskh->bkrqs", qh, cache["ck"]).to(torch.float32)
        s_cent = s_cent / sqrt_hd + cache["clogw"].permute(0, 2, 1)[:, :, None, None, :]
        parts.append((s_cent, cache["cv"]))
    if sp is None or ring_split or r == 0:
        # Scores over the exact recent ring.
        s_ring = torch.einsum("bqkrh,bskh->bkrqs", qh, ck_ring).to(torch.float32)
        s_ring = s_ring / sqrt_hd
        if index < ring:
            ring_pos = (r * ring_local if split else 0) + torch.arange(ring_local, device=x.device)
            s_ring = torch.where(ring_pos <= slot, s_ring, -1e30)
        parts.append((s_ring, cv_ring))

    scores = torch.cat([p[0] for p in parts], dim=-1)
    vals = torch.cat([p[1] for p in parts], dim=1)
    if sp is None:
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bkrqs,bskh->bqkrh", probs, vals)
    else:
        out = L._sharded_softmax_pv(scores, vals, sp).to(x.dtype)
    out = out.reshape(b, 1, h * hd) @ params["wo"].to(x.dtype)
    return out, {"k": ck_ring, "v": cv_ring}
