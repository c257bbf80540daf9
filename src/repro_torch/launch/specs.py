"""The launchable description of a sketch workload and the LM's input
specs (counterpart of ``repro.launch.specs``).

:class:`SketchJobSpec` names how a sketch pass is deployed — engine backend,
merge topology, ingest mode, quantization, operator family, decoder, the
fleet's tenant count and tenant shards, decay, window and drift bound — so
callers (``repro_torch.examples``) build their ``CKMConfig``, ``FleetEngine``
and ``FleetService`` from one place.  Backend names are the port's
(``core.engine.BACKENDS``: ``"kernel"``, ``"sharded"``; the reference's
``"xla"`` and ``"pallas"`` both map to ``"kernel"``), and a fleet job runs
on ``core.fleet.FLEET_BACKENDS``.

The LM half (``sds``, a shape-and-dtype record; ``train_batch_specs``,
``prefill_batch_specs``, ``decode_token_specs``; ``make_batch``, a random
batch matching the specs, drawn from an explicit ``torch.Generator``)
describes the model cells' inputs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import device as dev_mod
from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["SketchJobSpec", "sds", "train_batch_specs", "prefill_batch_specs",
           "decode_token_specs", "make_batch"]


@dataclasses.dataclass(frozen=True)
class SketchJobSpec:
    """How a sketch pass is deployed, independent of what it sketches.

    ``validate()`` fails fast against the live registries (engine backends,
    ``core.topology``, ``core.freq_ops``, ``core.decoders``), so a launch
    config cannot name a topology that does not exist; ``ckm_overrides()``
    is the kwargs dict to splat into ``dataclasses.replace(CKMConfig(...),
    **...)``.
    """

    backend: str = "kernel"
    reduce_topology: str = "allreduce"
    ingest: str = "sync"
    ingest_prefetch: int = 2
    sketch_quantization: str = "none"
    # Frequency-operator family (core.freq_ops registry): "dense" |
    # "structured" | any registered name.
    freq_op: str = "dense"
    # Sketch decoder (core.decoders registry): "clompr" | "sketch_shift" |
    # "amp" | any registered name.
    decoder: str = "clompr"
    # -- fleet deployment (multi-tenant sketch serving, core.fleet) ---------
    # Number of independent tenant sketch states held stacked in one
    # FleetEngine state; 1 = the classic single-sketch job.
    n_tenants: int = 1
    # How many shards the tenant axis splits into (each shard holds a
    # contiguous block of n_tenants / tenant_shards rows on its device);
    # n_tenants must be divisible by this extent.
    tenant_shards: int = 1
    # Mesh-axis name the tenant shards map onto (parallel.sharding.tenant_mesh).
    tenant_shard_axis: str = "tenant"
    # LRU capacity of the decode-on-demand cache (decoded models, keyed on
    # (tenant, state-version)); 0 disables caching.
    decode_cache_entries: int = 256
    # -- temporal sketching (core.engine decay / core.window) ---------------
    # Exponential decay base gamma in (0, 1] for the timestamped state
    # transform; None = lifetime sketch.
    decay: float | None = None
    # W > 0 turns on the bucketed ring-of-sketches window (core.window):
    # reads merge the last W buckets; 0 = no window.
    window_buckets: int = 0
    # Width of one window bucket on the t axis (must be positive when
    # window_buckets > 0).
    window_bucket_ticks: float = 1.0
    # CF-distance drift bound for unattended fleet maintenance
    # (FleetService): on breach the tenant's cached decode is invalidated
    # and re-decoded (counter fleet.redecode.drift); None = no maintenance.
    drift_threshold: float | None = None

    def validate(self) -> "SketchJobSpec":
        from repro_torch.core.decoders import get_decoder
        from repro_torch.core.engine import BACKENDS
        from repro_torch.core.fleet import FLEET_BACKENDS
        from repro_torch.core.freq_ops import get_freq_op
        from repro_torch.core.topology import get_topology

        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        get_topology(self.reduce_topology)
        get_freq_op(self.freq_op)
        get_decoder(self.decoder)
        if self.ingest not in ("sync", "async"):
            raise ValueError(f"ingest must be 'sync' or 'async', got {self.ingest!r}")
        if self.ingest_prefetch < 1:
            raise ValueError(f"ingest_prefetch must be >= 1, got {self.ingest_prefetch}")
        if self.n_tenants < 1:
            raise ValueError(f"n_tenants must be >= 1, got {self.n_tenants}")
        if self.tenant_shards < 1:
            raise ValueError(f"tenant_shards must be >= 1, got {self.tenant_shards}")
        if self.n_tenants % self.tenant_shards:
            raise ValueError(
                f"n_tenants={self.n_tenants} is not divisible by the tenant shard extent "
                f"tenant_shards={self.tenant_shards}; every '{self.tenant_shard_axis}' shard "
                "must hold an equal block of tenant rows"
            )
        if not self.tenant_shard_axis:
            raise ValueError("tenant_shard_axis must be a non-empty axis name")
        if self.decode_cache_entries < 0:
            raise ValueError(
                f"decode_cache_entries must be >= 0, got {self.decode_cache_entries}"
            )
        if self.n_tenants > 1 and self.backend not in FLEET_BACKENDS:
            raise ValueError(
                f"fleet jobs (n_tenants={self.n_tenants}) run on the "
                f"{'|'.join(FLEET_BACKENDS)} backend, got {self.backend!r}"
            )
        if self.decay is not None and not 0.0 < self.decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {self.decay!r}")
        if self.window_buckets < 0:
            raise ValueError(f"window_buckets must be >= 0, got {self.window_buckets}")
        if self.window_buckets > 0 and not self.window_bucket_ticks > 0:
            raise ValueError(
                f"window_bucket_ticks must be positive, got {self.window_bucket_ticks}"
            )
        if self.drift_threshold is not None and not self.drift_threshold > 0:
            raise ValueError(
                f"drift_threshold must be positive, got {self.drift_threshold!r}"
            )
        return self

    def ckm_overrides(self) -> dict:
        self.validate()
        return {
            "sketch_backend": self.backend,
            "reduce_topology": self.reduce_topology,
            "ingest": self.ingest,
            "ingest_prefetch": self.ingest_prefetch,
            "sketch_quantization": self.sketch_quantization,
            "freq_op": self.freq_op,
            "decoder": self.decoder,
            "decay": self.decay,
        }

    def fleet_kwargs(self) -> dict:
        """Kwargs to splat into ``FleetEngine(specs, **...)`` for this job.

        ``tenant_shards > 1`` turns on the tenant mesh (``sharding="mesh"``)
        over ``tenant_shard_axis``; the engine builds its mesh from the first
        ``tenant_shards`` cards unless the caller adds ``mesh=``."""
        self.validate()
        kwargs: dict = {"backend": self.backend, "decay": self.decay}
        if self.tenant_shards > 1:
            kwargs.update(
                sharding="mesh",
                tenant_shards=self.tenant_shards,
                tenant_shard_axis=self.tenant_shard_axis,
            )
        return kwargs

    def service_kwargs(self) -> dict:
        """Kwargs to splat into ``FleetService(engine, config, **...)``: the
        decode-cache size, drift maintenance bound, and window shape."""
        self.validate()
        return {
            "decode_cache_entries": self.decode_cache_entries,
            "drift_threshold": self.drift_threshold,
            "window_buckets": self.window_buckets,
            "window_bucket_ticks": self.window_bucket_ticks,
        }

    def describe(self) -> str:
        base = (
            f"backend={self.backend} topology={self.reduce_topology} "
            f"ingest={self.ingest}(depth={self.ingest_prefetch}) "
            f"quantize={self.sketch_quantization} freq_op={self.freq_op} "
            f"decoder={self.decoder}"
        )
        if self.n_tenants > 1:
            base += (
                f" fleet={self.n_tenants}x{self.tenant_shards}shards"
                f"(axis={self.tenant_shard_axis},cache={self.decode_cache_entries})"
            )
        if self.decay is not None:
            base += f" decay={self.decay}"
        if self.window_buckets > 0:
            base += f" window={self.window_buckets}x{self.window_bucket_ticks}"
        if self.drift_threshold is not None:
            base += f" drift_threshold={self.drift_threshold}"
        return base


class sds(NamedTuple):
    """A tensor's shape and dtype (the reference's ``jax.ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    s_text = s - cfg.frontend_len if cfg.frontend == "vision" else s
    batch = {
        "tokens": sds((b, s_text), torch.int32),
        "labels": sds((b, s_text), torch.int32),
    }
    if cfg.frontend == "vision":
        batch["patches"] = sds((b, cfg.frontend_len, cfg.d_model), torch.float32)
    elif cfg.frontend == "audio":
        batch["frames"] = sds((b, cfg.frontend_len, cfg.d_model), torch.float32)
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    batch = train_batch_specs(cfg, shape)
    batch.pop("labels")
    return batch


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig) -> sds:
    return sds((shape.global_batch, 1), torch.int32)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, gen: torch.Generator | None = None,
               device=dev_mod.DEFAULT) -> dict:
    """A random batch matching the specs: tokens uniform over the vocabulary,
    labels the tokens shifted left by one, frontend inputs standard normal.
    Drawn from ``gen`` (default: seed 0 on ``device``), on the generator's
    device."""
    dev = dev_mod.resolve(device if gen is None else gen.device)
    gen = gen if gen is not None else dev_mod.generator(0, dev)
    specs = train_batch_specs(cfg, shape)
    tokens = torch.randint(0, cfg.vocab_size, specs["tokens"].shape, generator=gen,
                           dtype=torch.int32, device=dev)
    out = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    for name in ("patches", "frames"):
        if name in specs:
            out[name] = torch.randn(specs[name].shape, generator=gen, dtype=torch.float32,
                                    device=dev)
    return out
