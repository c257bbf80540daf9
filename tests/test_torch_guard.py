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


def test_kernel_sources_avoid_fast_math_trig():
    """Phases reach tens of radians: the fast intrinsics lose accuracy there."""
    for src in (PORT / "kernels" / "csrc").glob("*.cu"):
        code = re.sub(r"//.*", "", src.read_text())
        assert "__sinf" not in code and "__cosf" not in code, src.name
    from repro_torch.kernels import _build

    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert {p.stem for p in (PORT / "kernels" / "csrc").glob("*.cu")} == set(_build.SOURCES)
