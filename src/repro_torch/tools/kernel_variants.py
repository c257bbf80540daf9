"""Where kernels 1 and 8 spend their time: each timed beside copies of its
source with one part of the work taken out, on one card.

    PYTHONPATH=src python3 -m repro_torch.tools.kernel_variants   (one CUDA card)

Each variant is the kernel's source under ``kernels/csrc/`` with one edit,
built by nvcc with the package's flags into ``build/variants/`` and called
through its C interface at the smoke run's main shapes: kernel 1
(``fourier_sketch``) at N = 10^7, n = 10, m = 1000 on the fit's frequencies,
kernel 8 (``flash_attention``) at llama3.2-1B width, bf16, B = 1, S = 4096,
causal.  The variants run in turns (in order, then in reverse) and each
line gives the median of 10 CUDA-event timings per turn.  The edits drop
work, so their outputs are wrong on purpose (the error against the plain
version is printed): they show what each part costs, not a faster kernel.
Kernel 8's "P in bf16 alone" variant also shows how far rounding P to bf16
without the lo half moves the output against the smoke's bf16 bar.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess

import torch

from repro_torch.core import ckm, frequencies
from repro_torch.data import synthetic
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fourier_sketch as fs
from repro_torch.kernels._launch import sm_count, stream_ptr

OUT = _build.BUILD_DIR.parent / "variants"

SKETCH_VARIANTS = {
    "as is": {},
    "no SFU trig (sin = r, cos = r * r)": {
        "  __sincosf(r, s, c);\n": "  *s = r;\n  *c = r * r;\n"},
    "no phase reduction (__sincosf(p))": {
        "  const float k = fmaf(p, kInv2Pi, kRoundMagic) - kRoundMagic;\n"
        "  float r = fmaf(-k, kTwoPiHi, p);\n  r = fmaf(-k, kTwoPiLo, r);\n":
        "  const float r = p;\n"},
    "one phase FMA instead of n": {
        "for (int k = 0; k < N; ++k) p = fmaf(xv[k], wr[f][k], p);":
        "p = fmaf(xv[0], wr[f][0], p);"},
}
FLASH_VARIANTS = {
    "as is": {},
    "P in bf16 alone (no lo half of P V)": {
        "          mma_bf16(oacc[2 * tp], lo, b[0], b[1]);\n": "",
        "          mma_bf16(oacc[2 * tp + 1], lo, b[2], b[3]);\n": ""},
}


def build(name: str, variants: dict) -> dict[str, ctypes.CDLL]:
    """Each variant of ``csrc/<name>.cu`` built (all nvcc processes started
    together) and loaded."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (label, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits.items():
            if old not in text:
                raise RuntimeError(f"{name} variant {label!r}: the source no longer has {old!r}")
            text = text.replace(old, new)
        path = OUT / f"{name}_{i}.cu"
        path.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(path.with_suffix(".so")), str(path)]
        jobs[label] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} variant {label!r}:\n{log}")
        libs[label] = ctypes.CDLL(str(path.with_suffix(".so")))
    return libs


def median_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def in_turns(calls: dict, check) -> None:
    """Times each call in order and then in reverse; prints both medians and
    ``check(output)``."""
    times = {label: [] for label in calls}
    for order in (list(calls), list(calls)[::-1]):
        for label in order:
            times[label].append(median_ms(calls[label]))
    for label, call in calls.items():
        print(f"  {label}: {times[label][0]:.3f} / {times[label][1]:.3f} ms; {check(call())}",
              flush=True)


def sketch_calls(libs, x, w):
    n_pts, n = x.shape
    m = w.shape[1]
    ones = torch.ones((n_pts,), dtype=torch.float32, device=x.device)
    calls = {}
    for label, lib in libs.items():
        lib.fourier_sketch_sums.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                                     ctypes.c_int] + [ctypes.c_void_p] * 5)
        lib.fourier_sketch_resident.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        resident = ctypes.c_int(0)
        if lib.fourier_sketch_resident(n, ctypes.byref(resident)):
            raise RuntimeError(f"fourier_sketch variant {label!r}: occupancy query failed")
        rows, groups, _ = fs.sketch_grid(n_pts, m, sm_count(x.device), resident.value)
        part = torch.empty((2, groups, m), dtype=torch.float64, device=x.device)
        out = torch.empty((2, m), dtype=torch.float32, device=x.device)

        def call(lib=lib, rows=rows, groups=groups, part=part, out=out):
            status = lib.fourier_sketch_sums(
                x.data_ptr(), w.data_ptr(), ones.data_ptr(), n_pts, n, m, rows, groups,
                part[0].data_ptr(), part[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                stream_ptr(x.device))
            if status:
                raise RuntimeError(f"fourier_sketch variant launch failed ({status})")
            return out
        calls[label] = call
    return calls, fs.fourier_sketch_sums_plain(x, w, ones)


def flash_calls(libs, q, k, v, rep):
    bh, s_q, hd = q.shape
    calls = {}
    for label, lib in libs.items():
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        o = torch.empty_like(q)
        lse = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)

        def call(fn=fn, o=o, lse=lse):
            status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                        bh, s_q, k.shape[1], hd, rep, 1, 0, 1.0 / hd**0.5, 1,
                        stream_ptr(q.device))
            if status:
                raise RuntimeError(f"flash_attention variant launch failed ({status})")
            return o
        calls[label] = call
    return calls, fa.flash_attention_plain(q, k, v, rep, True, 0, q_chunk=512)[0]


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    sketch_libs = build("fourier_sketch", SKETCH_VARIANTS)
    flash_libs = build("flash_attention", FLASH_VARIANTS)

    n_pts, m = 10_000_000, 1000
    x = synthetic.gaussian_mixture(0, n_pts, 10, 10, device=dev)
    g_sig, g_freq, _ = ckm.stream_keys(1, dev)
    sigma2 = frequencies.estimate_sigma2(g_sig, x[: ckm.CKMConfig(k=10, m=m).sigma2_sample],
                                         device=dev)
    w = frequencies.draw_frequencies(g_freq, m, 10, sigma2, device=dev)
    calls, (pc, ps) = sketch_calls(sketch_libs, x, w)
    print(f"[fourier_sketch] N={n_pts} n=10 m={m}", flush=True)
    in_turns(calls, lambda out: "max|d(sums/N)| = "
             f"{max(float((out[0] - pc).abs().max()), float((out[1] - ps).abs().max())) / n_pts:.3e}")
    del x, calls

    gen = torch.Generator(device=dev).manual_seed(0)
    h, kvh, s_a, hd = 32, 8, 4096, 64
    q, k, v = (torch.randn((n_h, s_a, hd), generator=gen, device=dev).to(torch.bfloat16)
               for n_h in (h, kvh, kvh))
    calls, po = flash_calls(flash_libs, q, k, v, h // kvh)
    po = po.float()
    print(f"[flash_attention] BH={h} BKV={kvh} S={s_a} hd={hd} causal bf16", flush=True)
    in_turns(calls, lambda o: "|do| against the bar 2^-7 |o| + 1e-4: "
             f"{float(((o.float() - po).abs() / (2.0**-7 * po.abs() + 1e-4)).max()):.3f} of it")


if __name__ == "__main__":
    main()
