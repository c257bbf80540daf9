"""Whether a kernel source's instances compile to another version's machine
code, function by function, on a machine with the CUDA toolkit.

    PYTHONPATH=src python3 -m repro_torch.tools.sass_diff NAME=PATH [NAME=PATH ...]
        [--strip REGEX ...]

NAME is a source under ``kernels/csrc/`` (``fourier_sketch``, ...) and PATH
another version of it, for example one written out by ``git show
<commit>:src/repro_torch/kernels/csrc/<NAME>.cu``.  Both are built with the
package's nvcc flags (PATH against the package's headers), disassembled by
``cuobjdump -sass`` and demangled by ``cu++filt``.  Each function of PATH is
matched to the function of NAME whose demangled name is the same once every
``--strip`` pattern has been removed from it (for example ``", \\(bool\\)0(?=>)"``
drops a trailing template flag set to false), and the two instruction
lists are compared with their addresses and encodings left out.  It prints
one line per function that differs or has no counterpart, then a count a
source, with the ptxas report (registers, spills) of NAME's build.  Needs
nvcc; no card is used.
"""

from __future__ import annotations

import argparse
import re
import subprocess
from pathlib import Path

from repro_torch.kernels import _build

_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")


def _tool(name: str) -> str:
    return str(Path(_build._nvcc()).parent / name)


def _demangle(name: str) -> str:
    out = subprocess.run([_tool("cu++filt")], input=name, capture_output=True, text=True,
                         check=True).stdout.strip()
    return re.sub(r"^void ", "", out)


def sass(lib: Path) -> dict[str, list[str]]:
    """Demangled function name -> its instructions, of a built library."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs: dict[str, list[str]] = {}
    body: list[str] | None = None
    for line in text.splitlines():
        found = _FUNCTION.search(line)
        if found:
            body = funcs.setdefault(_demangle(found.group(1)), [])
            continue
        inst = _INSTRUCTION.match(line)
        if body is not None and inst:
            body.append(inst.group(1))
    return funcs


def compare(name: str, other: Path, strip: list[str]) -> tuple[int, int]:
    """(identical, differing) functions of ``other`` against source ``name``."""
    lib = _build.build((name,))[0]
    out = _build.BUILD_DIR.parent / "sass_diff" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out),
                    str(other)], check=True, capture_output=True)
    ours = {}
    for fn, body in sass(lib).items():
        key = fn
        for pattern in strip:
            key = re.sub(pattern, "", key)
        ours[key] = body
    same = differ = 0
    for fn, body in sass(out).items():
        mine = ours.get(fn)
        if mine is None:
            print(f"{name}: {fn}: no counterpart")
            differ += 1
        elif mine == body:
            same += 1
        else:
            n_diff = sum(a != b for a, b in zip(body, mine)) + abs(len(body) - len(mine))
            print(f"{name}: {fn}: {len(body)} against {len(mine)} instructions, "
                  f"{n_diff} differ")
            differ += 1
    return same, differ


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sources", nargs="+", metavar="NAME=PATH")
    parser.add_argument("--strip", action="append", default=[], metavar="REGEX",
                        help="removed from NAME's demangled function names before matching")
    args = parser.parse_args()
    for spec in args.sources:
        name, _, path = spec.partition("=")
        if name not in _build.SOURCES or not path:
            parser.error(f"NAME=PATH with NAME one of {_build.SOURCES}: {spec!r}")
        same, differ = compare(name, Path(path), args.strip)
        print(f"[sass_diff] {name}: {same} functions of {path} compile to the same "
              f"instructions, {differ} do not", flush=True)
        print(_build.PTXAS.get(name, ""), flush=True)


if __name__ == "__main__":
    main()
