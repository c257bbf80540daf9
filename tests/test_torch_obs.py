"""The port's telemetry against the reference's: the same scripts through
both registries and tracers give the same snapshots and JSONL events; the
engine's spans, counters and labels, the ``ingest.*`` instruments and the
decoders' convergence series carry the reference's names; the disabled path
records nothing and leaves every result's bits alone."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.core import ingest as jing
from repro.core import quantize as jqz
from repro.core.engine import SketchEngine as JaxEngine
from repro_torch import convert
from repro_torch.core import ckm as tckm
from repro_torch.core import ingest as ing
from repro_torch.core.engine import SketchEngine
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import runtime as trt

pytestmark = pytest.mark.torch_port

BOTH = pytest.mark.parametrize("obs", [jobs, tobs], ids=["reference", "port"])
FAST = dict(atom_steps=40, joint_steps=30, nnls_iters=40, final_steps=80,
            shift_steps=40, shift_polish_steps=100, amp_iters=30, amp_polish_steps=50)


@pytest.fixture(autouse=True)
def _clean_obs():
    """Every test starts and ends with both packages' telemetry off and empty."""
    for o in (jobs, tobs):
        o.disable()
        o.reset()
    yield
    for o in (jobs, tobs):
        o.disable()
        o.reset()


def _blobs3(n_pts=3000):
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((3, 2)) * 6.0
    idx = rng.integers(0, 3, n_pts)
    return (centers[idx] + 0.3 * rng.standard_normal((n_pts, 2))).astype(np.float32)


def _w(n=3, m=32, seed=0):
    return np.random.default_rng(seed).standard_normal((n, m)).astype(np.float32)


def _engine(w, quantizer=None):
    return SketchEngine(convert.operator_from_numpy(w, device="cpu"), device="cpu",
                        quantizer=quantizer)


def _x(n_pts, n=3, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n_pts, n))
                            .astype(np.float32))


def _norm_backend(snapshot: dict) -> dict:
    """Snapshot keys with the backend label taken out (the reference's
    "xla" is the port's "kernel")."""
    return {k.replace("backend=xla,", "").replace("backend=kernel,", ""): v
            for k, v in snapshot.items()}


# -- registry and tracer semantics: the same script through both --------------


def _metrics_script(obs):
    c1 = obs.counter("x.calls", backend="a")
    c2 = obs.counter("x.calls", backend="a")
    c3 = obs.counter("x.calls", backend="b")
    assert c1 is c2 and c1 is not c3
    c1.inc()
    c1.inc(2.5)
    c3.inc()
    g = obs.gauge("g")
    g.set(1.0)
    g.set(0.25)
    h = obs.histogram("lat")
    for v in (0.5, 2.0, 0.004, 0.0):
        h.observe(v)
    return obs.snapshot()


def test_metrics_script_matches_reference():
    snap = _metrics_script(tobs)
    assert snap == _metrics_script(jobs)
    assert snap["x.calls{backend=a}"] == 3.5 and snap["g"] == 0.25
    assert snap["lat"]["count"] == 4 and snap["lat"]["max"] == 2.0
    h = tobs.histogram("lat")
    assert h.buckets == jobs.histogram("lat").buckets


@BOTH
def test_registry_reset_bumps_generation(obs):
    gen0 = obs.metrics.REGISTRY.generation
    obs.counter("a").inc()
    obs.metrics.reset()
    assert obs.metrics.REGISTRY.generation == gen0 + 1
    assert obs.snapshot() == {}


@BOTH
def test_enabled_scope_restores(obs):
    rt = obs.runtime
    assert not rt.ENABLED
    with rt.enabled_scope():
        assert rt.ENABLED and obs.enabled()
        with rt.enabled_scope(False):
            assert not rt.ENABLED
        assert rt.ENABLED
    assert not rt.ENABLED


@BOTH
def test_tracer_is_silent_when_disabled(obs):
    with obs.span("nothing"):
        pass
    obs.series("s", [1.0])
    obs.point("p", 2.0)
    assert obs.TRACER.events == []


def _trace_script(obs, path):
    obs.enable()
    with obs.span("outer", tag="a"):
        with obs.span("inner"):
            pass
    obs.series("conv", [3.0, 2.0, 1.0], decoder="clompr")
    obs.point("pt", 7.0)
    obs.counter("c").inc(4)
    lines = [json.loads(ln) for ln in obs.export_jsonl(path).read_text().splitlines()]
    obs.disable()
    for e in lines:
        if e["kind"] == "span":
            assert e.pop("dur_s") >= 0.0 and e.pop("t0") > 0.0
    return lines


def test_jsonl_export_matches_reference(tmp_path):
    lines = _trace_script(tobs, tmp_path / "port.jsonl")
    assert lines == _trace_script(jobs, tmp_path / "ref.jsonl")
    spans = {e["name"]: e for e in lines if e["kind"] == "span"}
    assert spans["outer"]["depth"] == 0 and spans["inner"]["depth"] == 1
    assert spans["outer"]["attrs"] == {"tag": "a"}
    assert [e["kind"] for e in lines] == ["span", "span", "series", "point", "metric"]


def test_span_enters_a_profiler_range():
    tobs.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tobs.span("engine.update"):
            torch.ones(3).sum()
    assert any(e.key == "engine.update" for e in prof.key_averages())


# -- engine instrumentation ---------------------------------------------------------


@pytest.mark.parametrize("spec", ["none", "1bit"])
def test_engine_counters_and_spans_match_reference(spec):
    """update (50 rows), update (20 rows), merge, finalize through both
    engines: the same counters (labels bar the backend) and spans."""
    w = _w()
    x = np.asarray(_x(50))
    jq = None if spec == "none" else jqz.make_quantizer(jax.random.PRNGKey(3), 32, spec)
    tq = None if jq is None else convert.quantizer_from_numpy(jq.bits, np.asarray(jq.dither),
                                                               device="cpu")
    runs = {}
    for obs, eng, arr in ((jobs, JaxEngine(jnp.asarray(w), "xla", quantizer=jq), jnp.asarray),
                          (tobs, _engine(w, tq), torch.from_numpy)):
        obs.enable()
        s = eng.update(eng.init_state(), arr(x))
        s = eng.update(s, arr(x[:20]))
        eng.finalize(eng.merge(s, eng.init_state()))
        obs.disable()
        runs[obs] = (_norm_backend(obs.snapshot()), [e["name"] for e in obs.TRACER.spans()])
    assert runs[tobs] == runs[jobs]
    bits = "none" if spec == "none" else "1"
    snap = tobs.snapshot()
    assert snap[f"engine.update.rows{{backend=kernel,bits={bits}}}"] == 70
    assert snap[f"engine.merge.calls{{backend=kernel,bits={bits}}}"] == 3
    assert snap[f"engine.state.bytes{{backend=kernel,bits={bits}}}"] == 2 * 32 * 4 + 2 * 3 * 4 + 8


def test_engine_handles_survive_registry_reset():
    eng = _engine(_w())
    x = _x(8)
    tobs.enable()
    eng.update(eng.init_state(), x)
    tobs.reset()
    eng.update(eng.init_state(), x)
    tobs.disable()
    assert tobs.snapshot()["engine.update.calls{backend=kernel,bits=none}"] == 1


def test_disabled_engine_runs_no_telemetry_code(monkeypatch):
    """Disabled, update/merge/finalize never reach the instrument lookup nor
    the tracer, and give the enabled run's bits."""
    eng = _engine(_w())
    x = _x(64)

    def boom(*a, **k):
        raise AssertionError("telemetry touched while disabled")

    monkeypatch.setattr(eng, "_obs", boom)
    monkeypatch.setattr(tobs.TRACER, "span", boom)
    z0 = eng.finalize(eng.merge(eng.update(eng.init_state(), x), eng.init_state()))
    assert tobs.snapshot() == {} and tobs.TRACER.events == []
    monkeypatch.undo()
    tobs.enable()
    z1 = eng.finalize(eng.merge(eng.update(eng.init_state(), x), eng.init_state()))
    tobs.disable()
    assert all(torch.equal(a, b) for a, b in zip(z0, z1))


# -- ingest instrumentation ---------------------------------------------------------


def test_ingest_metrics_match_reference():
    w = _w()
    batches = [np.asarray(_x(32, seed=i)) for i in range(5)]
    keys = {}
    for obs, eng in ((jobs, JaxEngine(jnp.asarray(w), "xla")), (tobs, _engine(w))):
        mod = jing if obs is jobs else ing
        obs.enable()
        _, stats = mod.ingest_stream(eng, batches, prefetch=2)
        obs.disable()
        snap = obs.snapshot()
        keys[obs] = sorted(k for k in snap if k.startswith("ingest."))
        assert snap["ingest.batches"] == stats.batches == 5
        assert snap["ingest.points"] == stats.points == 160
        assert snap["ingest.compute_s"] == pytest.approx(stats.compute_s)
        assert 0.0 <= snap["ingest.overlap_efficiency"] <= 1.0
        assert snap["ingest.resident_batches"] == 4  # prefetch + 2
        assert len(obs.TRACER.spans("ingest.stream")) == 1
        assert len(obs.TRACER.spans("engine.update")) == 5
    assert keys[tobs] == keys[jobs]


def test_ingest_silent_and_identical_when_disabled():
    eng = _engine(_w())
    batches = [np.asarray(_x(16, seed=i)) for i in range(3)]
    s0, _ = ing.ingest_stream(eng, batches)
    assert tobs.snapshot() == {} and tobs.TRACER.events == []
    tobs.enable()
    s1, _ = ing.ingest_stream(eng, batches)
    tobs.disable()
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))


# -- decoder convergence series ---------------------------------------------------


def _sketch_for_decode(blobs, m=60):
    w = (np.random.default_rng(1).standard_normal((2, m)) * np.sqrt(0.2)).astype(np.float32)
    op = convert.operator_from_numpy(w, device="cpu")
    z, lo, hi = SketchEngine(op, device="cpu").sketch(torch.from_numpy(blobs))
    return z, op, lo, hi


@pytest.mark.parametrize("decoder", ["clompr", "sketch_shift", "amp"])
def test_decode_sketch_emits_the_reference_series_when_enabled(decoder):
    """Enabled telemetry turns tracing on by itself: one series per name the
    reference emits, of the reference's length, and the untraced bits."""
    z, op, lo, hi = _sketch_for_decode(_blobs3())
    cfg = tckm.CKMConfig(k=3, m=60, decoder=decoder, **FAST)
    out0 = tckm.decode_sketch(2, z, op, lo, hi, cfg, device="cpu")
    tobs.enable()
    out1 = tckm.decode_sketch(2, z, op, lo, hi, cfg, device="cpu")
    tobs.disable()
    assert all(torch.equal(a, b) for a, b in zip(out0, out1))
    series = {e["name"]: e["values"] for e in tobs.TRACER.events if e["kind"] == "series"}
    length = {"clompr": 2 * cfg.k, "sketch_shift": cfg.k, "amp": cfg.amp_iters}[decoder]
    names = {"clompr": ["residual_norm"], "sketch_shift": ["residual_norm"],
             "amp": ["unexplained_energy", "posterior_variance"]}[decoder]
    assert sorted(series) == sorted(f"decoder.{decoder}.{n}" for n in names)
    assert all(len(v) == length and np.all(np.isfinite(v)) for v in series.values())


def test_decode_sketch_traces_the_best_replicate():
    z, op, lo, hi = _sketch_for_decode(_blobs3())
    cfg = tckm.CKMConfig(k=3, m=60, replicates=2, decoder="sketch_shift", **FAST)
    tobs.enable()
    _, _, cost = tckm.decode_sketch(2, z, op, lo, hi, cfg, device="cpu")
    tobs.disable()
    series = [e for e in tobs.TRACER.events if e["kind"] == "series"]
    assert len(series) == 1 and len(series[0]["values"]) == cfg.k
    # The emitted trace is the selected replicate's: rerun that replicate.
    from repro_torch import device as dev_mod
    from repro_torch.core.decoders import sketch_shift

    costs = []
    for r in range(2):
        gen = dev_mod.generator(dev_mod.derive_seed(2, r), torch.device("cpu"))
        costs.append(sketch_shift(gen, z, op, lo, hi,
                                  dataclasses.replace(cfg.sketch_shift_config(), trace=True)))
    best = min(costs, key=lambda o: float(o[2]))
    assert float(best[2]) == float(cost)
    assert series[0]["values"] == best[3]["residual_norm"].tolist()


def test_fit_streaming_jsonl_acceptance(tmp_path):
    """An enabled async fit_streaming: update/merge/finalize spans, one
    engine.update span a batch, the ingest.* instruments and the decoder's
    series, parsed back from the JSONL export; the centroids unperturbed."""
    blobs = _blobs3()
    cfg = tckm.CKMConfig(k=3, m=60, ingest="async", **FAST)
    batches = [blobs[i * 500:(i + 1) * 500] for i in range(6)]
    res0 = tckm.fit_streaming(1, iter(batches), cfg, device="cpu")
    tobs.enable()
    res = tckm.fit_streaming(1, iter(batches), cfg, device="cpu")
    path = tobs.export_jsonl(tmp_path / "run.jsonl")
    tobs.disable()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    spans = [e["name"] for e in lines if e["kind"] == "span"]
    assert spans.count("engine.update") == 6 and spans.count("ingest.stream") == 1
    assert {"engine.merge", "engine.finalize"} <= set(spans)
    series = {e["name"]: e["values"] for e in lines if e["kind"] == "series"}
    assert len(series["decoder.clompr.residual_norm"]) == 2 * cfg.k
    metrics = {e["name"]: e["value"] for e in lines if e["kind"] == "metric"}
    assert metrics["engine.update.rows{backend=kernel,bits=none}"] == 3000
    assert metrics["ingest.batches"] == 5 and metrics["ingest.points"] == 2500
    assert torch.equal(res.centroids, res0.centroids) and torch.equal(res.sketch, res0.sketch)


def test_runtime_flag_is_read_as_an_attribute():
    """Call sites read ``runtime.ENABLED`` at call time: no module holds a
    from-import copy of the flag."""
    import pathlib
    import re

    root = pathlib.Path(tmetrics.__file__).resolve().parents[1]
    from_import = re.compile(r"^\s*from\s+\S+\s+import[^\n]*\bENABLED\b", re.MULTILINE)
    offenders = [p.name for p in root.rglob("*.py") if from_import.search(p.read_text())]
    assert offenders == []
    assert len(list(root.rglob("*.py"))) > 20
    assert trt.ENABLED is False
