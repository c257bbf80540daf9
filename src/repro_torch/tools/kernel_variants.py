"""Where kernels 1, 4-5 and 8 spend their time: each timed beside copies of
its source with one part of the work taken out, on one card.

    PYTHONPATH=src python3 -m repro_torch.tools.kernel_variants   (one CUDA card)
        [--structured-baseline PATH]

Each variant is the kernel's source under ``kernels/csrc/`` (with the
``.cuh`` headers it includes) with one edit, built by nvcc with the
package's flags into its own directory under ``build/variants/`` and called
through its C interface at the smoke run's main shapes: kernel 1
(``fourier_sketch``) at N = 10^7, n = 10, m = 1000 on the fit's frequencies;
kernel 4 (``structured_sketch``) at the same data on the fit's structured
operator (d = 32), at the wide shape N = 100,003, n = 2048, m = 20,000, and
at the smoke run's sweep of d = 64 .. 1024 (N = 20,001; as is and the
baseline only); kernel 5 at 1 bit at the fit shape; kernel 8
(``flash_attention``) at llama3.2-1B width, bf16, B = 1, S = 4096, causal.

``--structured-baseline PATH`` adds another ``structured_sketch.cu`` (an
earlier version, for example one written out by ``git show
<commit>:src/repro_torch/kernels/csrc/structured_sketch.cu``) to kernels 4-5's
calls, so that the two versions are compared on one card in one call.  A
source without the ``structured_sketch_resident`` entry point is launched on
the grid and float partials of that earlier interface (8 CTAs an SM, at most
16,384 rows a CTA).  That branch serves only the comparison with the source
before the one-wave redesign of kernels 4-5; the next change to those
kernels drops it and accepts only sources with the current C interface.

The variants run in turns (in order, then in reverse) and each line gives
the median of 10 CUDA-event timings per turn.  The edits drop work, so their
outputs are wrong on purpose (the error against the plain version is
printed): they show what each part costs, not a faster kernel.  One edit
keeps the bits: "no first-stage skip" sends n = 10 to the d = 32 instance
with NX = 32 instead of NX = 16, to show what skipping the zero padding's
level saves at the fit shape (kernels 4 and 5).  Kernel 8's
"P in bf16 alone" variant also shows how far rounding P to bf16 without the
lo half moves the output against the smoke's bf16 bar.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.core import ckm, freq_ops, frequencies
from repro_torch.data import synthetic
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fourier_sketch as fs
from repro_torch.kernels import freq_transform as ft
from repro_torch.kernels._launch import grid_rows, sm_count, stream_ptr

OUT = _build.BUILD_DIR.parent / "variants"

# Variant label -> {file under csrc: {old text: new text}}.
SKETCH_VARIANTS = {
    "as is": {},
    "no SFU trig (sin = r, cos = r * r)": {"sincos_reduced.cuh": {
        "  __sincosf(reduce_2pi(p), s, c);\n":
        "  const float r = reduce_2pi(p);\n  *s = r;\n  *c = r * r;\n"}},
    "no phase reduction (__sincosf(p))": {"sincos_reduced.cuh": {
        "  __sincosf(reduce_2pi(p), s, c);\n": "  __sincosf(p, s, c);\n"}},
    "one phase FMA instead of n": {"fourier_sketch.cu": {
        "for (int k = 0; k < N; ++k) p = fmaf(xv[k], wr[f][k], p);":
        "p = fmaf(xv[0], wr[f][0], p);"}},
}
NO_SKIP = "no first-stage skip (NX = 32 at n <= 16)"
STRUCTURED_VARIANTS = {
    "as is": {},
    "no trig (sin = theta, cos = theta^2)": {"structured_sketch.cu": {
        "            sincos_reduced(theta, &s, &c);\n":
        "            s = theta;\n            c = theta * theta;\n"}},
    "no butterfly (scales only)": {"structured_sketch.cu": {
        "  butterfly_regs<NX>(v);\n  butterfly_lanes<TPF>(v, t, ex);\n": ""}},
    NO_SKIP: {"structured_sketch.cu": {
        "      if (n <= 16) return instance<32, MODE, 16>(out);\n": ""}},
}
FLASH_VARIANTS = {
    "as is": {},
    "P in bf16 alone (no lo half of P V)": {"flash_attention.cu": {
        "          mma_bf16(oacc[2 * tp], lo, b[0], b[1]);\n": "",
        "          mma_bf16(oacc[2 * tp + 1], lo, b[2], b[3]);\n": ""}},
}
BASELINE = "baseline (--structured-baseline)"


def build(name: str, variants: dict, baseline: Path | None = None) -> dict[str, ctypes.CDLL]:
    """Each variant of ``csrc/<name>.cu`` and its headers written to its own
    directory and built (all nvcc processes started together), then loaded;
    ``baseline``, a whole other source, as one more variant."""
    src = (_build.CSRC / f"{name}.cu").read_bytes()
    files = {f"{name}.cu": src.decode()}
    files.update({h: (_build.CSRC / h).read_text() for h in _build._headers(src)})
    sources = {}
    for label, edits in variants.items():
        texts = dict(files)
        for fname, pairs in edits.items():
            if fname not in texts:
                raise RuntimeError(f"{name} variant {label!r}: {fname} is not among {list(texts)}")
            for old, new in pairs.items():
                if old not in texts[fname]:
                    raise RuntimeError(f"{name} variant {label!r}: {fname} no longer has {old!r}")
                texts[fname] = texts[fname].replace(old, new)
        sources[label] = texts
    if baseline is not None:
        sources[BASELINE] = {f"{name}.cu": baseline.read_text()}
    jobs = {}
    for i, (label, texts) in enumerate(sources.items()):
        folder = OUT / f"{name}_{i}"
        folder.mkdir(parents=True, exist_ok=True)
        for fname, text in texts.items():
            (folder / fname).write_text(text)
        lib = folder / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(folder / f"{name}.cu")]
        jobs[label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} variant {label!r}:\n{log}")
        libs[label] = ctypes.CDLL(str(lib))
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


def structured_calls(libs, x, op, one_bit: bool):
    """Kernel 4 (float sums, beta = 1) or kernel 5 at 1 bit (zero dither) of
    each library on ``x`` and ``op``'s signs and radii, and the plain
    version's result."""
    n_pts, n = x.shape
    nblocks, _, d = op.diags.shape
    dev = x.device
    ones = torch.ones((n_pts,), dtype=torch.float32, device=dev)
    dither = torch.zeros((nblocks, d), dtype=torch.float32, device=dev)
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    calls = {}
    for label, lib in libs.items():
        lib.structured_sketch_sums.argtypes = [ptr] * 4 + [i64, i32, i32, i32, f32, i64, i32] + [
            ptr] * 5
        lib.quantized_structured_sketch_sums.argtypes = [ptr] * 5 + [
            i64, i32, i32, i32, f32, i32, f32, i64, i32, ptr, ptr, ptr]
        if hasattr(lib, "structured_sketch_resident"):
            lib.structured_sketch_resident.argtypes = [i32] * 3 + [ctypes.POINTER(i32)] * 2
            per_sm, fb = ctypes.c_int(0), ctypes.c_int(0)
            if lib.structured_sketch_resident(d, n, 2 if one_bit else 0, ctypes.byref(per_sm),
                                              ctypes.byref(fb)):
                raise RuntimeError(f"structured_sketch variant {label!r}: occupancy query failed")
            rows, groups, _ = ft.structured_grid(n_pts, nblocks, fb.value, sm_count(dev),
                                                 per_sm.value)
            part_dtype = torch.float64
        else:
            rows, groups = grid_rows(n_pts, -(-nblocks // max(1, 256 // d)), sm_count(dev))
            part_dtype = torch.float32
        part = torch.empty((2, groups, nblocks * d), dtype=part_dtype, device=dev)
        out = torch.empty((2, nblocks, d), dtype=torch.float32, device=dev)
        q = torch.zeros((2, nblocks, d), dtype=torch.int32, device=dev)

        def call(lib=lib, rows=rows, groups=groups, part=part, out=out, q=q):
            if one_bit:
                q.zero_()
                status = lib.quantized_structured_sketch_sums(
                    x.data_ptr(), op.diags.data_ptr(), op.radii.data_ptr(), dither.data_ptr(),
                    None, n_pts, n, d, nblocks, ft.inv_sqrt(d), 1, 1.0, rows, groups,
                    q[0].data_ptr(), q[1].data_ptr(), stream_ptr(dev))
            else:
                status = lib.structured_sketch_sums(
                    x.data_ptr(), op.diags.data_ptr(), op.radii.data_ptr(), ones.data_ptr(),
                    n_pts, n, d, nblocks, ft.inv_sqrt(d), rows, groups, part[0].data_ptr(),
                    part[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(), stream_ptr(dev))
            if status:
                raise RuntimeError(f"structured_sketch variant launch failed ({status})")
            return q if one_bit else out
        calls[label] = call
    if one_bit:
        return calls, ft.quantized_structured_sketch_sums_plain(x, op.diags, op.radii, dither, 1)
    return calls, ft.structured_sketch_sums_plain(x, op.diags, op.radii, ones)


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


def max_err(out, ref, n_pts: int) -> str:
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(out, ref)) / n_pts
    return f"max|d(sums/N)| = {err:.3e}"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--structured-baseline", type=Path, default=None,
                        help="another structured_sketch.cu to time beside this one")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    sketch_libs = build("fourier_sketch", SKETCH_VARIANTS)
    structured_libs = build("structured_sketch", STRUCTURED_VARIANTS, args.structured_baseline)
    flash_libs = build("flash_attention", FLASH_VARIANTS)

    n_pts, m = 10_000_000, 1000
    x = synthetic.gaussian_mixture(0, n_pts, 10, 10, device=dev)
    g_sig, g_freq, _ = ckm.stream_keys(1, dev)
    sigma2 = frequencies.estimate_sigma2(g_sig, x[: ckm.CKMConfig(k=10, m=m).sigma2_sample],
                                         device=dev)
    w = frequencies.draw_frequencies(g_freq, m, 10, sigma2, device=dev)
    calls, ref = sketch_calls(sketch_libs, x, w)
    print(f"[fourier_sketch] N={n_pts} n=10 m={m}", flush=True)
    in_turns(calls, lambda out: max_err(out, ref, n_pts))

    # Kernels 4-5 at the fit shape; kernel 5 at 1 bit as is beside the
    # instance without the first-stage skip and the baseline only (the other
    # variants take out the float path's trig).
    op = freq_ops.make_operator("structured", g_freq, m, 10, sigma2, device=dev)
    pair = {k: v for k, v in structured_libs.items() if k in ("as is", BASELINE)}
    skip = {k: v for k, v in structured_libs.items() if k in ("as is", NO_SKIP, BASELINE)}
    for one_bit, libs in ((False, structured_libs), (True, skip)):
        calls, ref = structured_calls(libs, x, op, one_bit)
        what = "quantized_structured_sketch 1bit" if one_bit else "structured_sketch"
        print(f"[{what}] fit shape N={n_pts} n=10 d={op.d} m={m}", flush=True)
        in_turns(calls, lambda out: max_err(out, ref, n_pts))
    del x, calls
    wide_n, wide_dim, wide_m = 100_003, 2048, 20_000
    xw = synthetic.gaussian_mixture(0, wide_n, 10, wide_dim, device=dev)
    sigma2_w = frequencies.estimate_sigma2(g_sig, xw[: ckm.CKMConfig(k=10).sigma2_sample],
                                           device=dev)
    op_w = freq_ops.make_operator("structured", g_freq, wide_m, wide_dim, sigma2_w, device=dev)
    calls, ref = structured_calls(structured_libs, xw, op_w, False)
    print(f"[structured_sketch] wide N={wide_n} n={wide_dim} d={op_w.d} m={wide_m}", flush=True)
    in_turns(calls, lambda out: max_err(out, ref, wide_n))
    del calls, xw
    # The smoke run's sweep of the other block widths (N = 20,001, three
    # blocks, the last one ragged): as is beside the baseline.
    gen = torch.Generator(device=dev).manual_seed(0)
    for n_s in (40, 100, 200, 500, 1000):
        xs = torch.randn((20_001, n_s), generator=gen, device=dev)
        d_s = 1 << (n_s - 1).bit_length()
        op_s = freq_ops.make_operator("structured", g_freq, 3 * d_s - 5, n_s, 1.0, device=dev)
        calls, ref = structured_calls(pair, xs, op_s, False)
        print(f"[structured_sketch] sweep N=20001 n={n_s} d={op_s.d} m={3 * d_s - 5}",
              flush=True)
        in_turns(calls, lambda out: max_err(out, ref, 20_001))
    del calls

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
