"""Kernel 7's designs against each other in CUDA graphs, on one card.

    PYTHONPATH=src python3 -m repro_torch.tools.amp_variants   (one CUDA card)
        [--baseline PATH] [--turns N]

Builds ``amp_variants.cu`` (beside this file: one thread an entry or a lane
pair an entry, with or without programmatic dependent launch, with or
without reciprocals) with the package's nvcc flags into
``build/variants/``, beside the package's own kernel
(``kernels/csrc/amp_denoise.cu``, "csrc") and, with ``--baseline``, another
source of it with the same C interface (for example one written out by
``git show <commit>:src/repro_torch/kernels/csrc/amp_denoise.cu``).  For
each design:

1. its largest error against ``amp_denoise_plain`` in the moments' natural
   units (mean / max(1, sqrt q), var / max(1, q)), and whether it gives the
   package kernel's bits, on the decoder's shape (K = n = 10), the wide
   shape (256, 130) at q = 1e-4, 0.5 and 25, the deep tail, open boxes, the
   collapse (Z <= 1e-12) and NaN pseudo-data (NaN where the plain version
   gives NaN, the other entries to the bar);
2. 100 launches alone in a CUDA graph: µs a launch (CUDA events over the
   replay, gaps included);
3. the denoiser's slice of a GAMP iteration in a CUDA graph, 100 times:
   ``r = cents + q_r * g`` (the add that writes r just before the kernel,
   as ``core/decoders/amp.py`` has it), the kernel, the damped update of
   the estimates: µs a slice, and the kernel's device µs a launch inside it
   (``torch.profiler``);
4. the graphed GAMP iteration of CL-AMP (``ckm.decode_sketch``, decoder
   "amp", no polish) on the sketch of 10^6 points of the smoke run's
   mixture: a decode at 230 iterations less one at 30 (CUDA events around
   each, medians of 3), over 200, with the graphs captured first; and the
   30-iteration decode's host wall over 30.

Designs run in turns (in order, then in reverse), each time with every
cached graph dropped; each line gives the median over the turns.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import statistics
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.core import ckm, graphs
from repro_torch.data import synthetic
from repro_torch.kernels import _build
from repro_torch.kernels import amp_denoise as kd

SOURCE = Path(__file__).resolve().parent / "amp_variants.cu"
OUT = _build.BUILD_DIR.parent / "variants"
DESIGNS = ("single", "single_pdl", "single_pdl_rcp", "pair", "pair_pdl", "pair_pdl_rcp")
DENOISE_TOL = 1e-5
GRAPH_LAUNCHES = 100
GAMP_ITERS = (30, 230)


class _Lib:
    """What ``kernels.amp_denoise._lib()`` returns, for one design."""

    def __init__(self, lib: ctypes.CDLL, entry: str):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        self.amp_denoise = getattr(lib, entry)
        self.amp_denoise.argtypes = [ptr, ptr, ptr, ptr, i64, i32, ptr, ptr, ptr]
        self.amp_denoise.restype = i32
        self.amp_denoise_error_string = lib.amp_denoise_error_string
        self.amp_denoise_error_string.argtypes = [i32]
        self.amp_denoise_error_string.restype = ctypes.c_char_p


def _nvcc(src: Path, out: Path) -> ctypes.CDLL:
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                           str(out), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    regs = [ln.strip() for ln in proc.stdout.splitlines() if "registers" in ln]
    print(f"[build] {src.name}: {'; '.join(regs)}", flush=True)
    return ctypes.CDLL(str(out))


def build(baseline: Path | None) -> dict[str, _Lib]:
    libs = {"csrc": kd._lib()}
    variants = _nvcc(SOURCE, OUT / "amp_variants.so")
    for name in DESIGNS:
        libs[name] = _Lib(variants, f"amp_denoise_{name}")
    if baseline is not None:
        libs["baseline"] = _Lib(_nvcc(baseline, OUT / "amp_baseline.so"), "amp_denoise")
    return libs


def _with(lib, fn):
    saved = kd._lib
    kd._lib = lambda: lib
    try:
        return fn()
    finally:
        kd._lib = saved


def cases(dev):
    """(label, r, q, lo, hi) of the checks."""
    gen = torch.Generator(device=dev).manual_seed(0)
    inf, nan = float("inf"), float("nan")
    lo_k = torch.randn((10,), generator=gen, device=dev) - 2.0
    hi_k = lo_k + 4.0
    r_k = lo_k + (torch.rand((10, 10), generator=gen, device=dev) * 1.4 - 0.2) * 4.0
    r_w = torch.randn((256, 130), generator=gen, device=dev) * 4
    lo_w = -torch.abs(torch.randn((130,), generator=gen, device=dev)) - 0.1
    hi_w = torch.abs(torch.randn((130,), generator=gen, device=dev)) + 0.1
    ones = torch.ones(8, device=dev)
    out = [("decoder shape", r_k, 0.5, lo_k, hi_k)]
    out += [(f"wide q={q}", r_w, q, lo_w, hi_w) for q in (1e-4, 0.5, 25.0)]
    out += [
        ("deep tail", torch.tensor([[1e6] * 8, [-1e6] * 8, [50.0] * 8], device=dev), 1.0,
         -ones, ones),
        ("open boxes", torch.tensor([[0.3, -2.0, 5.0, -5.0]], device=dev), 2.0,
         torch.tensor([-inf, -1.0, -inf, -1.0], device=dev),
         torch.tensor([inf, inf, 1.0, 1.0], device=dev)),
        ("collapse", torch.tensor([[9.0, -9.0, 40.0, 8.4], [7.5, -7.6, 1e3, 0.0]], device=dev),
         1.0, torch.tensor([-1.0, -1.0, -1.0, -1.0], device=dev), torch.ones(4, device=dev)),
        ("nan r", torch.tensor([[nan, 0.2, -3.0, nan], [0.5, nan, nan, 2.0]], device=dev), 0.7,
         torch.tensor([-1.0, -inf, -1.0, -2.0], device=dev),
         torch.tensor([1.0, 1.0, inf, 2.0], device=dev)),
    ]
    return [(lab, r.contiguous(), q, lo.contiguous(), hi.contiguous())
            for lab, r, q, lo, hi in out]


def denoise_error(got, want, q: float) -> float:
    """Largest error in natural units; inf unless NaN falls where the plain
    version has NaN."""
    err = 0.0
    for g, w, unit in zip(got, want, (max(1.0, q ** 0.5), max(1.0, q))):
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            return float("inf")
        ok = ~torch.isnan(w)
        if bool(ok.any()):
            err = max(err, float(torch.amax(torch.abs(g[ok] - w[ok]))) / unit)
    return err


def check(libs, dev) -> None:
    for label, r, q, lo, hi in cases(dev):
        qt = torch.tensor(q, dtype=torch.float32, device=dev)
        want = kd.amp_denoise_plain(r, qt, lo, hi)
        ref = _with(libs["csrc"], lambda: kd.amp_denoise(r, qt, lo, hi))
        parts = []
        for name, lib in libs.items():
            got = _with(lib, lambda: kd.amp_denoise(r, qt, lo, hi))
            same = all(torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
                       and torch.equal(torch.isnan(a), torch.isnan(b)) for a, b in zip(got, ref))
            err = denoise_error(got, want, q)
            flag = "" if err <= DENOISE_TOL else " OVER THE BAR"
            parts.append(f"{name} {err:.2e}{' =csrc' if same else ''}{flag}")
        print(f"[check {label}] K={r.shape[0]} n={r.shape[1]}: " + ", ".join(parts), flush=True)


def _graph(fn, dev) -> torch.cuda.CUDAGraph:
    fn()  # libraries loaded, allocator warm
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin()
        for _ in range(GRAPH_LAUNCHES):
            fn()
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(stream)
    return graph


def _replay_us(graph) -> float:
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / GRAPH_LAUNCHES)
    return statistics.median(times)


def graphed(lib, dev) -> tuple[float, float, float]:
    """(µs a launch alone, µs a denoiser slice, the kernel's device µs a
    launch inside the slices) in CUDA graphs of GRAPH_LAUNCHES each."""
    gen = torch.Generator(device=dev).manual_seed(1)
    cents = torch.randn((10, 10), generator=gen, device=dev)
    g = torch.randn((10, 10), generator=gen, device=dev) * 0.1
    q = torch.tensor(0.3, device=dev)
    lo, hi = torch.full((10,), -3.0, device=dev), torch.full((10,), 3.0, device=dev)
    r = (cents + q * g).contiguous()

    def alone():
        kd.amp_denoise(r, q, lo, hi)

    def denoise_slice():
        r_mat = cents + q * g
        c_new, _ = kd.amp_denoise(r_mat, q, lo, hi)
        cents.mul_(0.5).add_(c_new, alpha=0.5)

    def run():
        alone_us = _replay_us(_graph(alone, dev))
        slice_graph = _graph(denoise_slice, dev)
        slice_us = _replay_us(slice_graph)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            slice_graph.replay()
            torch.cuda.synchronize(dev)
        hits = [e for e in prof.key_averages() if "amp_denoise_kernel" in e.key]
        count = sum(e.count for e in hits)
        kernel_us = (sum(e.self_device_time_total for e in hits) / count) if count else float("nan")
        return alone_us, slice_us, kernel_us

    return _with(lib, run)


def gamp_iteration_us(lib, dev, fit, cfg) -> tuple[float, float]:
    """(µs a graphed GAMP iteration from two depths, the 30-iteration
    decode's wall over 30)."""

    def decode(iters):
        """(device-timeline seconds between events around the decode, host
        wall seconds)."""
        c = dataclasses.replace(cfg, amp_iters=iters, amp_polish_steps=0)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        ckm.decode_sketch(1, fit.sketch, fit.freq_op, *fit.bounds, c, device=dev)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, time.perf_counter() - t0

    def run():
        graphs.clear()
        decode(GAMP_ITERS[0])  # captures
        runs = {it: [decode(it) for _ in range(3)] for it in GAMP_ITERS}
        short, long_ = GAMP_ITERS
        dev_s = {it: statistics.median(e for e, _ in r) for it, r in runs.items()}
        wall_short = statistics.median(w for _, w in runs[short])
        return ((dev_s[long_] - dev_s[short]) * 1e6 / (long_ - short),
                wall_short * 1e6 / short)

    return _with(lib, run)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", type=Path, default=None)
    parser.add_argument("--turns", type=int, default=6)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("amp_variants: no CUDA device")
    dev = torch.device("cuda")
    libs = build(args.baseline)
    check(libs, dev)

    x = synthetic.gaussian_mixture(0, 1_000_000, 10, 10, device=dev)
    cfg = ckm.CKMConfig(k=10, m=1000, decoder="amp")
    fit = ckm.fit(1, x, cfg, device=dev)
    rows: dict[str, list] = {name: [] for name in libs}
    for turn in range(args.turns):
        order = list(libs) if turn % 2 == 0 else list(reversed(libs))
        for name in order:
            rows[name].append((*graphed(libs[name], dev),
                               *gamp_iteration_us(libs[name], dev, fit, cfg)))
    graphs.clear()
    for name, runs in rows.items():
        med = [statistics.median(col) for col in zip(*runs)]
        print(f"[{name}] alone {med[0]:.3f} us a launch in a graph; denoiser slice {med[1]:.3f} "
              f"us (kernel {med[2]:.3f} us of device time); GAMP iteration {med[3]:.2f} us "
              f"(two depths), {med[4]:.2f} us (30-iteration wall / 30); runs "
              + "; ".join(", ".join(f"{v:.3f}" for v in run) for run in runs), flush=True)


if __name__ == "__main__":
    main()
