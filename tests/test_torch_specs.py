"""The port's launch layer: ``SketchJobSpec`` accepts and refuses the same
field sets as the reference's (backend names mapped: the reference's
``"xla"`` and ``"pallas"`` are the port's ``"kernel"``), with the same
exception types and the same overrides, kwargs and description; its
``fleet_kwargs`` / ``service_kwargs`` drive the port's engine (a tenant mesh
when ``tenant_shards > 1``) and service; ``core.clompr`` re-exports the
decoder's objects; the LM half's input specs agree with the reference's for
every architecture and shape, and ``make_batch`` draws a batch that matches
them from an explicit generator."""

import dataclasses
import importlib

import pytest
import torch

from repro.configs import base as jbase
from repro.core import clompr as jclompr
from repro.launch import specs as jspecs
from repro.launch.specs import SketchJobSpec as JaxJobSpec
from repro_torch import launch
from repro_torch.configs import base as tbase
from repro_torch.core import CKMConfig, FleetEngine, ckm, fleet_specs
from repro_torch.core import clompr as tclompr
from repro_torch.core import fleet as fl
from repro_torch.launch import specs as tspecs
from repro_torch.launch.specs import SketchJobSpec
from repro_torch.parallel import tenant_mesh
from repro_torch.serve import FleetService

pytestmark = pytest.mark.torch_port

# The reference's backend name -> the port's.
BACKEND = {"xla": "kernel", "pallas": "kernel", "sharded": "sharded", "bogus": "bogus"}

# name -> the reference's fields (backend in its own names).
CASES = {
    "default": dict(backend="xla"),
    "pallas": dict(backend="pallas"),
    "sharded single": dict(backend="sharded", reduce_topology="ring"),
    "unknown backend": dict(backend="bogus"),
    "unknown topology": dict(backend="xla", reduce_topology="star"),
    "unknown freq op": dict(backend="xla", freq_op="circulant"),
    "unknown decoder": dict(backend="xla", decoder="omp"),
    "bad ingest": dict(backend="xla", ingest="eager"),
    "zero prefetch": dict(backend="xla", ingest="async", ingest_prefetch=0),
    "zero tenants": dict(backend="xla", n_tenants=0),
    "zero shards": dict(backend="xla", tenant_shards=0),
    "indivisible shards": dict(backend="xla", n_tenants=6, tenant_shards=4),
    "empty axis": dict(backend="xla", tenant_shard_axis=""),
    "negative cache": dict(backend="xla", decode_cache_entries=-1),
    "sharded fleet": dict(backend="sharded", n_tenants=4),
    "fleet": dict(backend="xla", n_tenants=8, tenant_shards=4, decay=0.9,
                  tenant_shard_axis="rows", decode_cache_entries=7),
    "bad decay": dict(backend="xla", decay=1.5),
    "zero decay": dict(backend="xla", decay=0.0),
    "negative window": dict(backend="xla", window_buckets=-1),
    "window without width": dict(backend="xla", window_buckets=3, window_bucket_ticks=0.0),
    "window": dict(backend="xla", window_buckets=3, window_bucket_ticks=2.0,
                   drift_threshold=0.5),
    "bad drift": dict(backend="xla", drift_threshold=0.0),
    "everything": dict(backend="xla", ingest="async", ingest_prefetch=3, freq_op="structured",
                       sketch_quantization="1bit", decoder="amp", n_tenants=16,
                       tenant_shards=2, decay=0.5, window_buckets=4, drift_threshold=2.0),
}


def _outcome(spec_type, fields):
    try:
        spec = spec_type(**fields).validate()
    except (ValueError, KeyError) as err:
        return type(err)
    return spec


@pytest.mark.parametrize("case", sorted(CASES))
def test_validate_agrees_with_the_reference(case):
    fields = CASES[case]
    want = _outcome(JaxJobSpec, fields)
    got = _outcome(SketchJobSpec, {**fields, "backend": BACKEND[fields["backend"]]})
    if isinstance(want, type):
        assert got is want, (case, got)
        return
    assert isinstance(got, SketchJobSpec), (case, got)
    port_name = BACKEND[fields["backend"]]
    assert got.ckm_overrides() == {**want.ckm_overrides(), "sketch_backend": port_name}
    assert got.service_kwargs() == want.service_kwargs()
    assert got.fleet_kwargs() == {**want.fleet_kwargs(), "backend": port_name}
    assert got.describe() == want.describe().replace(f"backend={fields['backend']}",
                                                     f"backend={port_name}")
    dataclasses.replace(CKMConfig(k=2), **got.ckm_overrides())


def test_defaults_and_messages():
    spec = SketchJobSpec()
    assert spec.backend == "kernel" and spec.validate() is spec
    assert [f.name for f in dataclasses.fields(SketchJobSpec)] == [
        f.name for f in dataclasses.fields(JaxJobSpec)]
    with pytest.raises(ValueError, match=r"backend must be one of \('kernel', 'sharded'\)"):
        SketchJobSpec(backend="xla").validate()
    with pytest.raises(ValueError, match=r"fleet jobs \(n_tenants=4\) run on the kernel"):
        SketchJobSpec(backend="sharded", n_tenants=4).validate()
    with pytest.raises(ValueError, match="n_tenants=6 is not divisible by the tenant shard "
                                         "extent tenant_shards=4; every 'tenant' shard"):
        SketchJobSpec(n_tenants=6, tenant_shards=4).validate()
    assert launch.SketchJobSpec is SketchJobSpec


def test_fleet_kwargs_build_a_mesh_fleet():
    """``tenant_shards > 1`` -> ``sharding="mesh"``: with the caller's mesh
    the engine is a tenant mesh; without one it takes the cards, and on a
    machine without them it refuses (no CPU fallback)."""
    assert SketchJobSpec(n_tenants=8).fleet_kwargs() == {"backend": "kernel", "decay": None}
    assert "sharding" not in SketchJobSpec(n_tenants=8, tenant_shards=1).fleet_kwargs()
    job = SketchJobSpec(n_tenants=8, tenant_shards=4, decay=0.8, tenant_shard_axis="rows")
    kw = job.fleet_kwargs()
    assert kw == {"backend": "kernel", "decay": 0.8, "sharding": "mesh", "tenant_shards": 4,
                  "tenant_shard_axis": "rows"}
    specs = fleet_specs(0, 8, "dense", 16, 3, 1.0)
    eng = FleetEngine(specs, mesh=tenant_mesh(4, "rows", devices=["cpu"] * 4), **kw)
    assert isinstance(eng, fl.TenantMeshFleet)
    assert (eng.tenant_shards, eng.shard_rows, eng.decay, eng.tenant_shard_axis) == (
        4, 2, 0.8, "rows")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="tenant_mesh needs 4 devices, only 0 available"):
            FleetEngine(specs, **kw)


def test_service_kwargs_drive_the_service():
    job = SketchJobSpec(n_tenants=4, decode_cache_entries=7, drift_threshold=0.5,
                        window_buckets=3, window_bucket_ticks=2.0)
    eng = FleetEngine(fleet_specs(0, 4, "dense", 16, 3, 1.0), device="cpu")
    svc = FleetService(eng, ckm.CKMConfig(k=2), **job.service_kwargs())
    assert svc.decode_cache_entries == 7 and svc.threshold(0) == 0.5
    assert svc.window.buckets == 3 and svc.window.bucket_ticks == 2.0


def test_core_clompr_reexports_the_decoder():
    dec_clompr = importlib.import_module("repro_torch.core.decoders.clompr")
    assert tclompr.__all__ == jclompr.__all__ == ["CLOMPRConfig", "InitStrategy", "clompr"]
    for name in tclompr.__all__:
        assert getattr(tclompr, name) is getattr(dec_clompr, name)
    assert tclompr.CLOMPRConfig(k=3).init == jclompr.CLOMPRConfig(k=3).init


# ---------------------------------------------------------------------------
# The LM half: input specs and make_batch
# ---------------------------------------------------------------------------


def _port_cfg(arch):
    """The reference's smoke config in the port's type (every family: the
    specs read only its frontend fields)."""
    return tbase.ModelConfig(**dataclasses.asdict(jbase.get_smoke_config(arch)))


def _as_pairs(specs):
    if isinstance(specs, dict):
        return {k: _as_pairs(v) for k, v in specs.items()}
    return tuple(specs.shape), str(specs.dtype).split(".")[-1]


@pytest.mark.parametrize("arch", jbase.ARCHS)
@pytest.mark.parametrize("shape", sorted(jbase.SHAPES))
def test_lm_batch_specs_match_the_reference(arch, shape):
    jcfg, tcfg = jbase.get_smoke_config(arch), _port_cfg(arch)
    jshape, tshape = jbase.SHAPES[shape], tbase.SHAPES[shape]
    for name in ("train_batch_specs", "prefill_batch_specs", "decode_token_specs"):
        got = getattr(tspecs, name)(tcfg, tshape)
        want = getattr(jspecs, name)(jcfg, jshape)
        assert _as_pairs(got) == _as_pairs(want), name
    assert tspecs.sds((2, 3), torch.int32) == ((2, 3), torch.int32)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-small", "internvl2-26b"])
def test_make_batch_matches_the_specs(arch):
    """The reference's shapes and dtypes, tokens in the vocabulary, labels
    the tokens shifted left, frontend inputs drawn; one generator seed gives
    the same batch."""
    cfg = _port_cfg(arch)
    shape = tbase.ShapeConfig("t", 48, 3, "train")
    batch = tspecs.make_batch(cfg, shape, torch.Generator().manual_seed(5))
    want = jspecs.make_batch(jbase.get_smoke_config(arch), jbase.ShapeConfig("t", 48, 3, "train"))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in batch.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    tok = batch["tokens"]
    assert 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab_size
    assert torch.equal(batch["labels"], torch.roll(tok, -1, dims=1))
    again = tspecs.make_batch(cfg, shape, torch.Generator().manual_seed(5))
    assert all(torch.equal(again[k], v) for k, v in batch.items())
    assert not torch.equal(tspecs.make_batch(cfg, shape, device="cpu")["tokens"], tok)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tspecs.make_batch(cfg, shape)
