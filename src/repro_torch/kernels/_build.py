"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``build/kernels/<name>-<hash>.so`` at the root of the checkout
(``.gitignore`` lists ``build/``), where the hash covers the source, the
``csrc/*.cuh`` headers it includes (``#include "<header>.cuh"``, followed
through the headers' own includes) and the flags, so an edited source or
header is rebuilt and an unchanged one is loaded as is.
Nothing is compiled when this module is imported: the CPU tests import every
module, and the CPU has no nvcc.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

No ``--use_fast_math``: the sketch phases reach tens of radians, where the
fast ``__sinf``/``__cosf`` intrinsics lose accuracy.  ``__sincosf`` is called
on purpose in one helper, ``sincos_reduced`` (``sincos_reduced.cuh``), which
first reduces the phase to [-pi, pi]; kernels 1, 4 and 5 reach the fast
trig only through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = (
    "fourier_sketch", "assign_argmin", "quantized_fourier_sketch", "structured_sketch",
    "sketch_shift", "amp_denoise", "flash_attention",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build, by source.
PTXAS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
        "cannot be built"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([\w.]+\.cuh)"', re.MULTILINE)


def _headers(src: bytes) -> list[str]:
    """The ``csrc`` headers ``src`` includes, directly or through other
    headers, in the order first met."""
    seen: list[str] = []
    todo = _INCLUDE.findall(src)
    while todo:
        name = todo.pop(0).decode()
        if name not in seen:
            seen.append(name)
            todo.extend(_INCLUDE.findall((CSRC / name).read_bytes()))
    return seen


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src)
    for header in _headers(src):
        h.update(header.encode() + b"\0" + (CSRC / header).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start nvcc for ``name`` unless its library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, tmp, proc


def build(names=SOURCES) -> list[Path]:
    """Compile every named source that is not built yet — one nvcc process
    each, all started together — and return the library paths."""
    with _LOCK:
        jobs = {name: _start(name) for name in names}
        errors = []
        for name, job in jobs.items():
            if job is None:
                continue
            out, tmp, proc = job
            log, _ = proc.communicate()
            PTXAS[name] = log
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)  # atomic: a reader never sees a partial .so
        if errors:
            raise RuntimeError("\n".join(errors))
        return [_target(name) for name in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build((name,))[0]
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
