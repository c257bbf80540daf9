"""Guards on the port's boundaries: it never imports JAX or the reference
package, and ``chip_smoke.py`` needs nothing of either."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
_FORBIDDEN_IMPORT = re.compile(
    r"^\s*(import jax|from jax|import repro\b|from repro\b|from repro\.)", re.MULTILINE
)

_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro.")
)
print(len(names), bad)
"""


def test_port_and_chip_smoke_import_neither_jax_nor_the_reference():
    """A fresh interpreter imports every ``repro_torch`` module and
    ``chip_smoke``; neither ``jax`` nor any ``repro`` module gets loaded."""
    code = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.strip().split(" ", 1)
    assert int(n_modules) >= 20
    assert bad == "[]", bad


def test_no_source_line_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files
        for m in _FORBIDDEN_IMPORT.finditer(f.read_text())
    ]
    assert not offenders, offenders


def _strip_comments(code: str) -> str:
    return re.sub(r"//.*", "", re.sub(r"/\*.*?\*/", "", code, flags=re.DOTALL))


def _definition(code: str, name: str) -> str:
    """The text of the ``__device__`` function ``name``, header to closing
    brace."""
    head = re.search(r"__device__[^;{]*\b" + name + r"\s*\([^)]*\)\s*\{", code)
    assert head, f"no definition of {name}"
    depth, i = 1, head.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(code[i], 0)
        i += 1
    return code[head.start():i]


_FAST_TRIG = re.compile(r"\b__(?:sin|cos|sincos)f\b|\b(?:sin|cos)\.approx")


def test_kernel_sources_avoid_fast_math_trig():
    """The SFU's trig (``__sinf``, ``__cosf``, ``__sincosf``, PTX
    ``sin.approx``/``cos.approx``) is accurate only on [-pi, pi], and sketch
    phases reach tens of radians.  Among all the kernel sources and headers it
    appears once: ``__sincosf`` inside ``sincos_reduced``
    (``sincos_reduced.cuh``), applied to the phase that ``reduce_2pi`` (with
    the reduction's four constants) first brings to [-pi, pi].  Kernel 1
    calls the helper from its two partial-sum kernels, kernel 3 from its
    b-bit code, the structured kernels (4-5) from their float sums and b-bit
    codes, and kernel 6 from its narrow and its wide path; none of them (nor
    the header) calls the accurate ``sincosf``/``sinf``/``cosf`` beside it.
    No ``--use_fast_math``, which would turn every ``sincosf`` into the
    unreduced intrinsics."""
    csrc = PORT / "kernels" / "csrc"
    raw = {p.name: p.read_text() for p in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))}
    code = {name: _strip_comments(text) for name, text in raw.items()}
    hits = [(name, m.group(0)) for name, c in code.items() for m in _FAST_TRIG.finditer(c)]
    assert hits == [("sincos_reduced.cuh", "__sincosf")], hits
    header = code["sincos_reduced.cuh"]
    helper = _definition(header, "sincos_reduced")
    reduction = _definition(header, "reduce_2pi")
    assert re.search(r"__sincosf\s*\(\s*reduce_2pi\s*\(\s*p\s*\)", helper)
    for constant in ("kInv2Pi", "kRoundMagic", "kTwoPiHi", "kTwoPiLo"):
        assert constant in reduction, constant
    users = {name for name, text in raw.items() if '#include "sincos_reduced.cuh"' in text}
    assert users == {"fourier_sketch.cu", "quantized_fourier_sketch.cu", "structured_sketch.cu",
                     "sketch_shift.cu"}
    accurate = re.compile(r"\b(?:sincosf|sinf|cosf|sincospif)\s*\(")
    for name in (*users, "sincos_reduced.cuh"):
        assert not accurate.search(code[name]), name
    calls = {name: len(re.findall(r"\bsincos_reduced\s*\(", code[name])) for name in users}
    assert calls == {"fourier_sketch.cu": 2, "quantized_fourier_sketch.cu": 1,
                     "structured_sketch.cu": 1, "sketch_shift.cu": 2}, calls
    from repro_torch.kernels import _build

    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert {p.stem for p in (PORT / "kernels" / "csrc").glob("*.cu")} == set(_build.SOURCES)


def test_one_bit_rule_is_defined_once_in_the_header():
    """The 1-bit codes' trig-free rule lives in one helper,
    ``one_bit_signs`` in ``sincos_reduced.cuh``: it reduces the phase with
    ``reduce_2pi`` and compares against ``kHalfPi`` and ``kPi``.  Kernel 3
    (``quantized_fourier_sketch.cu``) and kernel 5 (``structured_sketch.cu``)
    call it and define neither the helper, nor the constants, nor a
    comparison of their own against them."""
    csrc = PORT / "kernels" / "csrc"
    code = {p.name: _strip_comments(p.read_text())
            for p in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))}
    helper = _definition(code["sincos_reduced.cuh"], "one_bit_signs")
    assert re.search(r"=\s*reduce_2pi\s*\(\s*p\s*\)", helper)
    assert "kHalfPi" in helper and "kPi" in helper
    definitions = [name for name, c in code.items()
                   if re.search(r"__device__[^;{]*\bone_bit_signs\s*\(", c)]
    assert definitions == ["sincos_reduced.cuh"], definitions
    for name in ("kHalfPi", "kPi"):
        declared = [f for f, c in code.items() if re.search(rf"constexpr float {name}\b", c)]
        assert declared == ["sincos_reduced.cuh"], (name, declared)
        used = [f for f, c in code.items() if re.search(rf"\b{name}\b", c)]
        assert used == ["sincos_reduced.cuh"], (name, used)
    for name in ("quantized_fourier_sketch.cu", "structured_sketch.cu"):
        assert len(re.findall(r"\bone_bit_signs\s*\(", code[name])) == 1, name


def test_amp_denoise_source_uses_the_accurate_math_functions():
    """The denoiser keeps the reference's numerics: expf, erfcf and sqrtf,
    none of the fast __ intrinsics, and no float atomics in the decoder
    kernels (their sums must repeat bitwise)."""
    code = re.sub(r"//.*", "", (PORT / "kernels" / "csrc" / "amp_denoise.cu").read_text())
    for fn in ("expf(", "erfcf(", "sqrtf("):
        assert fn in code, fn
    assert not re.search(r"__(expf|exp10f|logf|powf|fdividef)\b", code)
    for name in ("amp_denoise", "sketch_shift"):
        code = re.sub(r"//.*", "", (PORT / "kernels" / "csrc" / f"{name}.cu").read_text())
        assert "atomicAdd" not in code, name


def test_kernel_sources_round_half_to_even():
    """QCKM b-bit codes round half to even (``torch.round``/``jnp.round``):
    ``__float2int_rn``, never ``roundf``, which rounds half away from zero."""
    for name in ("quantized_fourier_sketch", "structured_sketch"):
        code = re.sub(r"//.*", "", (PORT / "kernels" / "csrc" / f"{name}.cu").read_text())
        assert "__float2int_rn" in code and not re.search(r"\bround[f]?\s*\(", code), name


def test_new_entry_points_default_to_the_card():
    """The slice's entry points that create data ask for the card by default:
    on a CPU-only host they raise instead of running on the CPU."""
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.core import SketchWindow, ckm, freq_ops, ingest_stream
    from repro_torch.core.engine import SketchEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    gen = torch.Generator().manual_seed(0)
    cfg = ckm.CKMConfig(k=2, m=40, freq_op="structured", sketch_quantization="1bit")
    w = torch.zeros((2, 40))
    for call in (
        lambda: freq_ops.make_operator("structured", gen, 40, 2, 1.0),
        lambda: ckm.make_quantizer(0, cfg, 40),
        lambda: ckm.fit(0, torch.zeros((64, 2)), cfg),
        lambda: convert.structured_operator_from_numpy(
            np.ones((2, 3, 32)), np.ones((2, 32)), np.ones((2, 32)), 2, 40),
        lambda: convert.quantizer_from_numpy(1, np.zeros(40)),
        lambda: convert.quantized_state_from_numpy(
            np.zeros(40), np.zeros(40), 0.0, np.zeros(2), np.zeros(2), 0.0),
        lambda: SketchEngine(w, quantizer=convert.quantizer_from_numpy(1, np.zeros(40), "cpu")),
        lambda: SketchEngine(w, decay=0.9),
        lambda: ingest_stream(SketchEngine(w), [np.zeros((4, 2), np.float32)]),
        lambda: SketchWindow(SketchEngine(w, decay=0.9), 4),
        lambda: ckm.fit_streaming(0, iter([np.zeros((64, 2), np.float32)]),
                                  ckm.CKMConfig(k=2, m=40, ingest="async", decay=0.9)),
    ):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()


def test_flash_attention_source_keeps_the_accurate_math_and_no_atomics():
    """Kernel 8 rounds as the plain version's float32 softmax: expf and
    logf, none of the fast __ intrinsics; each output is written by one
    thread (no atomics), so it repeats bitwise."""
    code = re.sub(r"//.*", "", (PORT / "kernels" / "csrc" / "flash_attention.cu").read_text())
    assert "expf(" in code and "logf(" in code
    assert not re.search(r"__(expf|exp10f|logf|powf|fdividef)\b", code)
    assert "atomic" not in code


def test_graphs_have_no_fallback_and_decoders_default_to_them():
    """A failed capture raises (no ``except`` in ``core.graphs``), and every
    decoder entry takes the graphed loops unless asked for ``eager``."""
    import inspect

    from repro_torch.core import ckm
    from repro_torch.core import decoders as tdec
    from repro_torch.core import nnls
    from repro_torch.core.decoders import common

    assert "except" not in (PORT / "core" / "graphs.py").read_text()
    fns = [ckm.decode_sketch, nnls.nnls, common.adam, tdec.clompr, tdec.sketch_shift,
           tdec.cl_amp, *(tdec.get_decoder(n) for n in tdec.available_decoders())]
    for fn in fns:
        param = inspect.signature(fn).parameters["eager"]
        assert param.default is False and param.kind is param.KEYWORD_ONLY, fn.__name__


def test_flash_attention_takes_the_card_for_cuda_tensors(monkeypatch):
    """``ops.flash_attention`` sends a CUDA tensor to the kernel wrapper, and
    the wrapper runs the plain version only when every tensor is on the CPU."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    called = []
    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(fa, "flash_attention_kernel",
                        lambda *a: called.append(a) or fa.flash_attention_plain(*a))
    q = torch.zeros((1, 8, 2, 16))
    ops.flash_attention(q, q, q)
    assert len(called) == 1
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_kernel(torch.zeros((2, 8, 16), device="meta"),
                                  torch.zeros((2, 8, 16)), torch.zeros((2, 8, 16)), 1, True, 0)


def test_ingest_has_no_path_back_to_the_sync_loop():
    """``core/ingest.py`` folds batches in one place, the consumer loop over
    ``prefetched``; its only exception handler relays the producer's error
    to the consumer; and it picks the card's placement from the engine's
    device alone, with no ``try`` around it.  So a failure of the pinned
    buffers, the side stream or the copy raises: nothing drops to a sync
    fold."""
    import ast

    tree = ast.parse((PORT / "core" / "ingest.py").read_text())
    handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    assert sorted(ast.unparse(h.type) for h in handlers) == [
        "BaseException", "StopIteration", "queue.Full", "queue.Full"]
    relay = next(h for h in handlers if ast.unparse(h.type) == "BaseException")
    assert "_put_until_stopped(q, e, stop)" in ast.unparse(relay)
    updates = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
               and ast.unparse(n.func).endswith(".update")]
    assert [ast.unparse(u) for u in updates] == ["engine.update(state, batch)"]
    loops = [n for n in ast.walk(tree) if isinstance(n, ast.For)
             and any(u in ast.walk(n) for u in updates)]
    assert len(loops) == 1 and ast.unparse(loops[0].iter).startswith("prefetched(")
    stream_fn = next(n for n in ast.walk(tree)
                     if isinstance(n, ast.FunctionDef) and n.name == "ingest_stream")
    assert not any(isinstance(n, ast.Try) for n in ast.walk(stream_fn))


def test_fleet_entry_points_default_to_the_card():
    """``fleet_specs`` holds no tensor (a spec is its seed); ``from_spec``,
    ``fleet_quantizers`` and ``FleetEngine`` ask for the card by default: on
    a CPU-only host they raise instead of running on the CPU."""
    import torch

    from repro_torch.core import FleetEngine, fleet_quantizers, fleet_specs
    from repro_torch.core import freq_ops

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    specs = fleet_specs(0, 2, "dense", 16, 3, 1.0)
    assert not any(isinstance(v, torch.Tensor) for spec in specs for v in spec)
    for call in (lambda: freq_ops.from_spec(specs[0]),
                 lambda: fleet_quantizers(0, 2, 16, "1bit"),
                 lambda: FleetEngine(specs)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()


def _function_source(path: Path, name: str) -> str:
    """The code of function ``name`` in ``path``, without its docstring."""
    import ast

    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)
    if ast.get_docstring(fn) is not None:
        fn.body = fn.body[1:]
    return ast.unparse(fn)


def test_fleet_kernel_entries_launch_once_with_no_fallback():
    """The tenant-axis entries of kernels 1 and 3 launch their library's
    fleet function once, and call neither a single-tenant wrapper nor a
    plain version, nor catch anything; ``kernels.ops`` sends a dense fleet
    on a CUDA tensor to them."""
    src = PORT / "kernels" / "fourier_sketch.py"
    for name, lib_fn in (("fourier_sketch_sums_fleet", "lib.fourier_sketch_sums_fleet("),
                         ("quantized_fourier_sketch_sums_fleet",
                          "lib.quantized_fourier_sketch_sums_fleet(")):
        code = _function_source(src, name)
        assert code.count(lib_fn) == 1, name
        assert "_plain" not in code and "try:" not in code and "for " not in code, name
        assert not re.search(r"\b(quantized_)?fourier_sketch_sums\(", code), name
    ops = PORT / "kernels" / "ops.py"
    for name, entry in (("fleet_fourier_sketch_sums", "_sketch.fourier_sketch_sums_fleet "),
                        ("quantized_fleet_fourier_sketch_sums",
                         "_sketch.quantized_fourier_sketch_sums_fleet ")):
        code = _function_source(ops, name)
        assert f"{entry}if _on_cuda(x) else" in code, name
        assert "try:" not in code, name


def test_ingest_passes_device_batches_and_waits_on_its_own_stream():
    """The pinned stager hands a float32 batch already on the engine's card
    straight through (no pinned slot, no copy, no event) and refuses one on
    another card; the wait after each fold is on the consumer's stream, not
    device-wide."""
    import torch

    from repro_torch.core import ingest as ing

    class OnCard(torch.Tensor):
        """A CPU tensor that reports itself on ``cuda:<index>``: the stager's
        branch for device batches, without a card."""

        index = 0

        @property
        def is_cuda(self):
            return True

        @property
        def device(self):
            return torch.device("cuda", self.index)

    stager = object.__new__(ing._PinnedStager)
    stager.device, stager.buffers, stager.events, stager.next = (
        torch.device("cuda", 0), [None] * 4, [None] * 4, 0)
    batch = torch.Tensor._make_subclass(OnCard, torch.zeros((5, 3)))
    out, event = stager(batch)
    assert out is batch and event is None
    assert stager.buffers == [None] * 4 and stager.events == [None] * 4 and stager.next == 0
    other = torch.Tensor._make_subclass(OnCard, torch.zeros((5, 3)))
    other.index = 1
    with pytest.raises(ValueError, match="cuda:1"):
        stager(other)
    code = _function_source(PORT / "core" / "ingest.py", "ingest_stream")
    assert "torch.cuda.current_stream(dev).synchronize()" in code
    assert "torch.cuda.synchronize" not in code


_LAUNCH_PROBE = r"""
import importlib, sys
sys.path.insert(0, {src!r})
for name in ("repro_torch.launch", "repro_torch.launch.specs", "repro_torch.examples",
             "repro_torch.examples.quickstart", "repro_torch.examples.full_pipeline",
             "repro_torch.examples.serve_fleet", "repro_torch.parallel",
             "repro_torch.core.clompr"):
    importlib.import_module(name)
from repro_torch.launch import SketchJobSpec
SketchJobSpec(n_tenants=4, tenant_shards=2).validate().fleet_kwargs()
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro.")
)
print(bad)
"""


def test_launch_and_examples_import_neither_jax_nor_the_reference():
    """``launch/``, ``examples/``, ``parallel/`` and ``core/clompr.py``, and a
    validated ``SketchJobSpec`` (which reads the registries), load neither
    ``jax`` nor any ``repro`` module, and no source line there imports
    them."""
    out = subprocess.run(
        [sys.executable, "-c", _LAUNCH_PROBE.format(src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    files = [*sorted((PORT / "launch").glob("*.py")), *sorted((PORT / "examples").glob("*.py")),
             *sorted((PORT / "parallel").glob("*.py")), PORT / "core" / "clompr.py"]
    assert len(files) >= 9
    offenders = [f.name for f in files if _FORBIDDEN_IMPORT.search(f.read_text())]
    assert not offenders, offenders


def test_mesh_launch_and_example_entry_points_default_to_the_card():
    """The tenant mesh takes the cards by default and refuses without them
    (no CPU fallback), and each example runs on the card unless asked for
    ``--device cpu``: on a CPU-only host they raise."""
    import torch

    from repro_torch.core import FleetEngine, fleet_specs
    from repro_torch.examples import full_pipeline, quickstart, serve_fleet
    from repro_torch.parallel import tenant_mesh

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    specs = fleet_specs(0, 4, "dense", 16, 3, 1.0)
    for call in (lambda: tenant_mesh(1), lambda: tenant_mesh(2),
                 lambda: FleetEngine(specs, sharding="mesh"),
                 lambda: FleetEngine(specs, sharding="mesh", tenant_shards=2)):
        with pytest.raises(ValueError, match="only 0 available"):
            call()
    for call in (lambda: quickstart.main(["--n", "100"]),
                 lambda: full_pipeline.main(["--n", "100", "--backend", "kernel"]),
                 lambda: full_pipeline.main(["--n", "100"]),
                 lambda: serve_fleet.main(["--tenants", "4", "--requests", "1"]),
                 lambda: serve_fleet.main(["--tenants", "4", "--shards", "2"]),
                 lambda: serve_fleet.placement(2, 0, "cuda")):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
