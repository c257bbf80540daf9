"""Long-context serving with a CKM-compressed KV cache (counterpart of
``examples/serve_kv_ckm.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_kv_ckm [--device cuda]

Runs a small model's first layer on a long prompt, compresses its
global-attention KV cache into weighted centroids (the paper's
mixture-of-Diracs, on keys) with Lloyd-Max and with CKM, and decodes one
token with [centroids + exact recent ring].  Reports the attention-output
fidelity against the uncompressed cache and the memory ratio, first on the
random model's own keys, then on keys with planted cluster structure.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from repro_torch import device as dev_mod
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.serve.kv_clustering import (
    attention_decode_compressed,
    build_compressed_cache,
)

S_PROMPT = 1024
N_CENTROIDS = 64
RING = 64


def _padded(t: torch.Tensor) -> torch.Tensor:
    """One free cache slot after the prompt, for the decoded token."""
    return F.pad(t, (0, 0, 0, 0, 0, 1))


def _rel(out_c: torch.Tensor, out_full: torch.Tensor) -> float:
    return float(torch.linalg.norm(out_c - out_full) / torch.linalg.norm(out_full))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default=dev_mod.DEFAULT,
                    help="where to run (default the CUDA card; 'cpu' for the plain kernels)")
    args = ap.parse_args(argv)
    dev = dev_mod.resolve(args.device)
    s_prompt, n_cent, ring = S_PROMPT, N_CENTROIDS, RING

    def gen(*path):
        return dev_mod.generator(dev_mod.derive_seed(*path), dev)

    cfg = get_smoke_config("llama3.2-1b")
    params = tfm.init_lm(0, cfg, device=dev)
    dims = tfm.attn_dims(cfg, "attn")

    # A long prompt through layer 0's attention to get a real KV cloud.
    tokens = torch.randint(0, cfg.vocab_size, (1, s_prompt), generator=gen(1), device=dev)
    x = L.embed(params["embed"], tokens, torch.float32) * L.f32_sqrt(cfg.d_model)
    pos = torch.arange(s_prompt, device=dev)[None]
    p0 = params["groups"][0]["0"]
    h = L.rmsnorm(p0["norm1"], x)
    _, (k, v) = L.attention_apply(p0["mixer"], dims, h, pos, return_kv=True)

    # Compress with both clusterers from the paper's toolbox.
    q_tok = h[:, -1:, :]
    out_full, _, _ = L.attention_decode(p0["mixer"], dims, q_tok, _padded(k), _padded(v),
                                        s_prompt)
    for method in ("lloyd", "ckm"):
        cache = build_compressed_cache(2, k, v, n_cent, ring, method=method)
        out_c, _ = attention_decode_compressed(p0["mixer"], dims, q_tok, cache, s_prompt)
        ratio = s_prompt / (n_cent + ring)
        print(
            f"random-init KV  {method:6s}: rel err {_rel(out_c, out_full):.4f} "
            f"({ratio:.1f}x smaller cache; random-init keys have no cluster "
            f"structure — worst case)"
        )

    # Real pretrained KV clouds cluster heavily; emulate that regime.
    centers = torch.randn((n_cent, cfg.n_kv_heads, cfg.head_dim_), generator=gen(3, 0),
                          device=dev) * 4
    assign = torch.randint(0, n_cent, (s_prompt,), generator=gen(3, 1), device=dev)
    kcl = centers[assign][None] + 0.1 * torch.randn(k.shape, generator=gen(3, 2), device=dev)
    vcl = centers[assign][None] * 0.5
    out_full_c, _, _ = L.attention_decode(p0["mixer"], dims, q_tok, _padded(kcl),
                                          _padded(vcl), s_prompt)
    for method in ("lloyd", "ckm"):
        cache = build_compressed_cache(4, kcl, vcl, n_cent, ring, method=method)
        out_c, _ = attention_decode_compressed(p0["mixer"], dims, q_tok, cache, s_prompt)
        print(f"clustered KV    {method:6s}: rel err {_rel(out_c, out_full_c):.4f} "
              "(pretrained-cache regime)")
    print(
        "\nnote: for LOCAL offline compression Lloyd is the right clusterer; "
        "CKM earns its keep when the cache is sharded across hosts — each "
        "host sketches its shard (O(m) traffic) and CLOMPR decodes centrally "
        "(see core.distributed_sketch)."
    )


if __name__ == "__main__":
    main()
