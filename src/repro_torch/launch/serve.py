"""Serving step construction on one card (counterpart of
``repro.launch.serve``): the prefill and decode (serve) steps of the LM, its
cache mode, and the shapes and dtypes of its parameters and cache.

``make_prefill`` and ``make_serve_step`` stand where the reference's
``jit_prefill`` and ``jit_serve_step`` stand.  Each returns the step and
the shapes of its inputs; the step runs eagerly under
``torch.inference_mode``, and the serve step writes the cache in place (the
reference donates it).  Serving parameters are bf16: ``serving_params``
casts a float32 model.  The reference's placement over a mesh
(``NamedSharding``, ``param_specs``, ``cache_specs``) waits for the LM half
of ``parallel/sharding`` (ROADMAP Queue 1 item 22 (b), part 2): ``mesh`` must be
``None``.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.specs import decode_token_specs, prefill_batch_specs, sds
from repro_torch.models import transformer as tfm

__all__ = ["cache_mode", "cache_shapes", "params_shapes", "serving_params",
           "make_prefill", "make_serve_step"]


def cache_mode(cfg: ModelConfig, shape: ShapeConfig) -> str:
    return "ckm" if (shape.kind == "long_decode" and cfg.long_context == "ckm") else "full"


def _shapes(tree):
    """A tree of tensors -> the same tree of ``sds`` records."""
    return tree_map(lambda t: sds(tuple(t.shape), t.dtype), tree)


def cache_shapes(cfg: ModelConfig, shape: ShapeConfig, dtype=torch.bfloat16):
    """The decode cache's shapes and dtypes (built on the meta device)."""
    return _shapes(tfm.init_cache(cfg, shape.global_batch, shape.seq_len,
                                  cache_mode(cfg, shape), dtype, device="meta"))


def serving_params(params, dtype=torch.bfloat16):
    """Float32 leaves cast to ``dtype`` (the serving model); others kept."""
    return tree_map(lambda t: t.to(dtype) if t.dtype == torch.float32 else t, params)


def params_shapes(cfg: ModelConfig, dtype=torch.bfloat16):
    """The serving parameters' shapes and dtypes (built on the meta device)."""
    return _shapes(serving_params(tfm.init_lm(0, cfg, device="meta"), dtype))


def _one_card(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "serving runs on one card: mesh must be None (the sharded serve steps are "
            "ROADMAP Queue 1 item 22 (b), part 2)"
        )


def make_serve_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None, dtype=torch.bfloat16):
    """The decode step ``serve_step(params, token, cache, index) -> (logits,
    cache)`` and the shapes of its inputs ``(params, token, cache, index)``."""
    _one_card(mesh)

    @torch.inference_mode()
    def serve_step(params, token, cache, index):
        return tfm.decode_step(params, cfg, token, cache, index, dtype=dtype)

    index_shape = sds((), torch.int32)
    return serve_step, (params_shapes(cfg), decode_token_specs(cfg, shape),
                        cache_shapes(cfg, shape, dtype), index_shape)


def make_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh=None, dtype=torch.bfloat16):
    """The prefill ``prefill(params, batch) -> (last logits, cache, index)``
    and the shapes of its inputs ``(params, batch)``.  The cache holds
    ``shape.seq_len`` positions: a prompt shorter than that leaves room for
    the decode steps after it."""
    _one_card(mesh)

    @torch.inference_mode()
    def prefill(params, batch):
        return tfm.prefill(params, cfg, batch, cache_len=shape.seq_len, dtype=dtype)

    return prefill, (params_shapes(cfg), prefill_batch_specs(cfg, shape))
