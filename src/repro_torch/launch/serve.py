"""Serving step construction (counterpart of ``repro.launch.serve``): the
prefill and decode (serve) steps of the LM, its cache mode, and the shapes
and dtypes of its parameters and cache, on one card or over a mesh.

``make_prefill`` and ``make_serve_step`` stand where the reference's
``jit_prefill`` and ``jit_serve_step`` stand.  Each returns the step and
the shapes of its inputs; the step runs eagerly under
``torch.inference_mode``, and the serve step writes the cache in place (the
reference donates it).  Serving parameters are bf16: ``serving_params``
casts a float32 model.

Over a mesh (a ``torch.distributed`` ``DeviceMesh``, one process a rank)
the steps take each rank's pieces, placed as ``serve_specs`` gives them:
parameters with FSDP over "data" (the reference's 2D weight sharding at
serve), the cache by ``cache_specs`` (its sequence over "model"), tokens
and prompts over the batch axes where they divide.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import tree_map

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.specs import decode_token_specs, prefill_batch_specs, sds
from repro_torch.models import transformer as tfm
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as sh

__all__ = ["cache_mode", "cache_shapes", "params_shapes", "serving_params",
           "serve_specs", "make_prefill", "make_serve_step"]


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


def serve_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, dtype=torch.bfloat16) -> dict:
    """Where the serve steps' inputs live on ``mesh``: ``{"params", "cache",
    "batch", "token"}`` specs."""
    return {"params": sh.param_specs(params_shapes(cfg, dtype), cfg, mesh, fsdp_axis="data"),
            "cache": sh.cache_specs(cache_shapes(cfg, shape, dtype), cfg, shape, mesh),
            "batch": sh.batch_specs(cfg, dataclasses.replace(shape, kind="prefill"), mesh),
            "token": sh.token_spec(shape, mesh)}


def make_serve_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None, dtype=torch.bfloat16):
    """The decode step ``serve_step(params, token, cache, index) -> (logits,
    cache)`` and the shapes of its inputs ``(params, token, cache, index)``
    (whole; on a mesh each rank passes its pieces and gets its rows)."""
    sp = C.as_spmd(mesh)

    @torch.inference_mode()
    def serve_step(params, token, cache, index):
        return tfm.decode_step(params, cfg, token, cache, index, mesh=sp, dtype=dtype,
                               cache_len=shape.seq_len)

    index_shape = sds((), torch.int32)
    return serve_step, (params_shapes(cfg), decode_token_specs(cfg, shape),
                        cache_shapes(cfg, shape, dtype), index_shape)


def make_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh=None, dtype=torch.bfloat16):
    """The prefill ``prefill(params, batch) -> (last logits, cache, index)``
    and the shapes of its inputs ``(params, batch)``.  The cache holds
    ``shape.seq_len`` positions: a prompt shorter than that leaves room for
    the decode steps after it."""
    sp = C.as_spmd(mesh)

    @torch.inference_mode()
    def prefill(params, batch):
        return tfm.prefill(params, cfg, batch, cache_len=shape.seq_len, mesh=sp, dtype=dtype)

    return prefill, (params_shapes(cfg), prefill_batch_specs(cfg, shape))
