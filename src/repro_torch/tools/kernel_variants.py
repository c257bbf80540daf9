"""Where kernels 1-6 and 8 spend their time: each timed beside copies
of its source with one part of the work taken out, on one card.

    PYTHONPATH=src python3 -m repro_torch.tools.kernel_variants   (one CUDA card)
        [--baseline NAME=PATH ...] [--only NAME,NAME,...]

Each variant is the kernel's source under ``kernels/csrc/`` (with the
``.cuh`` headers it includes) with one edit, built by nvcc with the
package's flags into its own directory under ``build/variants/`` and called
through its C interface at the smoke run's main shapes: kernel 1
(``fourier_sketch``) at N = 10^7, n = 10, m = 1000 on the fit's frequencies;
kernel 3 (``quantized_fourier_sketch``) at the same data at 1 and 4 bits on
the fit's dither, and at the sweep's n = 100 (N = 20,001, m = 300); kernel 4
(``structured_sketch``) at the fit shape on the fit's structured operator
(d = 32), at the wide shape N = 100,003, n = 2048, m = 20,000, and at the
smoke run's sweep of d = 64 .. 1024 (N = 20,001; as is and the baseline
only), and at the smoke run's wide blocks (the wide kernel: d = 4096 and
16384 on 20,001 rows, d = 8192 on 200,003 rows, there kernel 5 at 1 bit
too; with the variants that take out its butterfly and its mid-range
flushes); kernel 5 at 1 bit at the fit shape; kernel 6 (``sketch_shift``) at
the decoder's swarm (P = 80, n = 10, m = 1000, on the fit's sketch) timed
eagerly and as 100 launches replayed in a CUDA graph (device time a
launch), and at the wide shape (P = 80, n = 2048, m = 20,000, on the
materialised wide structured operator); kernel 8 (``flash_attention``) at
llama3.2-1B width, bf16, B = 1, S = 4096, causal; kernel 2
(``assign_argmin``) at the main path's N = 10^7, n = K = 10, at the LM's
KV-cache shapes (8129 clustered keys of head_dim 256, K = 64 and 16) and at
n = 784 and 2048 (K = 64, N = 20,001); its tile path with resident and
streamed point rows (N = 20,001, K = 300, n = 256 .. 736); then both of its
paths at n <= 64 (N = 10^6, K = 16 .. 128), which is where its switch was
set.

``--baseline NAME=PATH`` adds another source of kernel NAME (an earlier
version, for example one written out by ``git show
<commit>:src/repro_torch/kernels/csrc/<NAME>.cu``) to that kernel's calls,
so that the two versions are compared on one card in one call; it may be
given once per kernel.  Kernels 3 and 6 also take their sources from before
their redesign (commit 8d5cea6, with those C interfaces: kernel 3 without
``quantized_fourier_sketch_resident``, on the grid of 8 CTAs an SM and at
most 16,384 rows a CTA; kernel 6's ``sketch_shift_sums`` with its split of
m into chunks of 1024); kernel 4-5 baselines must have the current C
interface, and run on the current wrappers' grid
(``freq_transform.structured_grid`` from the baseline's own occupancy: at
wide blocks, one row a group at least); a kernel 2 baseline may have the one before its redesign
(``assign_argmin(x, c, N, n, K, labels, dist, stream)``, no launch plan).  ``--only`` runs only the named kernels (``fourier_sketch``,
``assign_argmin``, ``quantized_fourier_sketch``, ``structured_sketch``,
``sketch_shift``, ``flash_attention``).

The variants run in turns (in order, then in reverse) and each line gives
the median of 10 CUDA-event timings per turn.  The edits drop work, so their
outputs are wrong on purpose (the error against the plain version is
printed): they show what each part costs, not a faster kernel.  Some edits
keep the bits: "no first-stage skip" sends n = 10 to the d = 32 instance
with NX = 32 instead of NX = 16, to show what skipping the zero padding's
level saves at the fit shape (kernels 4 and 5); kernel 3's "F = 2" gives a
thread 2 frequencies at 1 bit instead of 4; kernel 6's "one CTA a group"
launches the narrow path with clusters of one CTA that each take all of m.
Kernel 8's "P in bf16 alone" variant also shows how far rounding P to bf16
without the lo half moves the output against the smoke's bf16 bar.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.core import ckm, freq_ops, frequencies
from repro_torch.core import quantize as qz
from repro_torch.data import synthetic
from repro_torch.kernels import _build
from repro_torch.kernels import assign_argmin as aa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fourier_sketch as fs
from repro_torch.kernels import freq_transform as ft
from repro_torch.kernels import sketch_shift as ks
from repro_torch.kernels._launch import sm_count, stream_ptr

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
QSKETCH_VARIANTS = {
    "as is": {},
    "no reduction (1 bit: codes off the raw phase; b bits: __sincosf(p))": {
        "sincos_reduced.cuh": {
            "  const float r = reduce_2pi(p);\n  *cos_pos": "  const float r = p;\n  *cos_pos",
            "  __sincosf(reduce_2pi(p), s, c);\n": "  __sincosf(p, s, c);\n"}},
    "one phase FMA instead of n": {"quantized_fourier_sketch.cu": {
        "for (int k = 0; k < N; ++k) p = fmaf(xv[k], wr[f][k], p);":
        "p = fmaf(xv[0], wr[f][0], p);"}},
    "F = 2 at 1 bit (256 frequencies a block)": {"quantized_fourier_sketch.cu": {
        "constexpr int F = ONE_BIT ? 4 : 2;": "constexpr int F = 2;"}},
    "rows unrolled 2": {"quantized_fourier_sketch.cu": {
        "#pragma unroll 4\n    for (int r = 0; r < rows; ++r) {":
        "#pragma unroll 2\n    for (int r = 0; r < rows; ++r) {"}},
}
SHIFT_VARIANTS = {
    "as is": {},
    "no SFU trig (sin = r, cos = r * r)": SKETCH_VARIANTS["no SFU trig (sin = r, cos = r * r)"],
    "no pass 2 (narrow: no f, g sums)": {"sketch_shift.cu": {
        "    for (int k = 4 * warp + sub; k < 4 * kWarps * ((n + 4 * kWarps) / (4 * kWarps));":
        "    for (int k = 4 * warp + sub; k < 0;"}},
    "no gradient phase (wide: phase B not launched)": {"sketch_shift.cu": {
        "  shift_phase_b<TP><<<": "  if (false) shift_phase_b<TP><<<"}},
    "4 candidates a cluster (narrow)": {"sketch_shift.cu": {
        "constexpr int kCands = 2; ": "constexpr int kCands = 4; "}},
    "no cluster exchange (narrow: each CTA leaves with its partial)": {"sketch_shift.cu": {
        "  if (rank != 0) {\n    cluster_wait();": "  if (rank != 0) {\n    return;",
        "  if (ranks > 1) mbar_wait_first_phase(smem_addr(&arrived));\n": ""}},
}
NO_CLUSTER = "one CTA a group (no cluster)"
NO_SKIP = "no first-stage skip (NX = 32 at n <= 16)"
STRUCTURED_VARIANTS = {
    "as is": {},
    "no trig (sin = theta, cos = theta^2)": {"structured_sketch.cu": {
        "    sincos_reduced(theta, &s, &c);\n":
        "    s = theta;\n    c = theta * theta;\n"}},
    "no butterfly (scales only)": {"structured_sketch.cu": {
        "  butterfly_regs<NX>(v);\n  butterfly_lanes<TPF>(v, t, ex);\n": ""}},
    NO_SKIP: {"structured_sketch.cu": {
        "      if (n <= 16) return instance<32, MODE, 16, FLEET>(out);\n": ""}},
    "no butterfly (wide: layout changes only)": {"structured_sketch.cu": {
        "      butterfly_regs<kEpt>(v);  // levels 1 .. 16\n": "",
        "      butterfly_regs<kEpt>(v);  // levels 32 .. 512\n": "",
        "      butterfly_strided<W::HM0>(v);  // levels 1024 .. d / 2\n": ""}},
    "no flush (wide: the group's sums written once, at its end)": {"structured_sketch.cu": {
        "    if (MODE == kFloat && ++since == kWideFlushRows) {":
        "    if (MODE == kFloat && ++since == 0) {"}},
}
# The wide kernel's own variants: the narrow shapes skip them (same code).
WIDE_ONLY = ("no butterfly (wide: layout changes only)",
             "no flush (wide: the group's sums written once, at its end)")
FLASH_VARIANTS = {
    "as is": {},
    "P in bf16 alone (no lo half of P V)": {"flash_attention.cu": {
        "          mma_bf16(oacc[2 * tp], lo, b[0], b[1]);\n": "",
        "          mma_bf16(oacc[2 * tp + 1], lo, b[2], b[3]);\n": ""}},
}
# Kernel 2's ring depth: variant label -> stages (its launch plan's too).
ASSIGN_STAGES = {f"{s} ring stages": s for s in (2, 3, 4)}
ASSIGN_VARIANTS = {
    "as is": {},
    **{label: {"assign_argmin.cu": {
        f"constexpr int kStages = {aa.TILE_STAGES};": f"constexpr int kStages = {s};"}}
       for label, s in ASSIGN_STAGES.items() if s != aa.TILE_STAGES},
    "one block an SM allowed 255 registers": {"assign_argmin.cu": {
        "__global__ void __launch_bounds__(kThreads, 2)\nassign_tiles(":
        "__global__ void __launch_bounds__(kThreads, 1)\nassign_tiles("}},
    "no staging (cp.async not issued)": {"assign_argmin.cu": {
        "    if (t < steps) {\n      const int kt = t / nch": "    if (t < 0) {\n      const int kt = t / nch"}},
    "one feature chunk (32 features, whatever n)": {"assign_argmin.cu": {
        "  const int nch = (n + kBK - 1) / kBK;\n  const int tiles":
        "  const int nch = 1;\n  const int tiles"}},
    "no products (staging, norms, epilogue and merge only)": {"assign_argmin.cu": {
        "          acc[i][j] = fmaf(xv[i].x, cv[j].x, acc[i][j]);\n"
        "          acc[i][j] = fmaf(xv[i].y, cv[j].y, acc[i][j]);\n"
        "          acc[i][j] = fmaf(xv[i].z, cv[j].z, acc[i][j]);\n"
        "          acc[i][j] = fmaf(xv[i].w, cv[j].w, acc[i][j]);\n": ""}},
}
BASELINE = "baseline (--baseline)"


def build(name: str, variants: dict, baseline: Path | None = None,
          report: str | None = None) -> dict[str, ctypes.CDLL]:
    """Each variant of ``csrc/<name>.cu`` and its headers written to its own
    directory and built (all nvcc processes started together), then loaded;
    ``baseline``, a whole other source, as one more variant.  With
    ``report``, prints the registers and spills ptxas gives each variant's
    entry functions whose names hold that string."""
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
        text = baseline.read_text()
        # The headers it includes: its own folder's where it has them, else
        # the package's.
        sources[BASELINE] = {f"{name}.cu": text, **{
            h: (baseline.parent / h if (baseline.parent / h).exists() else _build.CSRC / h)
            .read_text() for h in _build._headers(text.encode())}}
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
        for chunk in log.split("Compiling entry function")[1:] if report else ():
            fn = chunk.split("'")[1]
            if report in fn:
                regs = chunk.split("Used ")[1].split(" registers")[0]
                spill = chunk.split(" bytes spill stores")[0].split(",")[-1].strip()
                print(f"[ptxas {name}] {label}: {fn}: {regs} registers, {spill} B spilled",
                      flush=True)
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


class Clocks:
    """``nvidia-smi``'s SM clock (MHz) and power draw (W), sampled every
    100 ms while the ``with`` block runs; prints their range after it."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate()
        rows = [[float(v) for v in ln.split(",")] for ln in out.splitlines() if ln.count(",") == 1]
        if rows:
            mhz, watts = sorted(r[0] for r in rows), sorted(r[1] for r in rows)
            print(f"  clocks.sm {mhz[0]:.0f}-{mhz[-1]:.0f} MHz (median "
                  f"{statistics.median(mhz):.0f}), power.draw {watts[0]:.0f}-{watts[-1]:.0f} W "
                  f"over {len(rows)} samples", flush=True)


def in_turns(calls: dict, check) -> None:
    """Times each call in order and then in reverse; prints both medians and
    ``check(output)``, and the SM clock and power over the turns."""
    times = {label: [] for label in calls}
    with Clocks():
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
        lib.structured_sketch_resident.argtypes = [i32] * 3 + [ctypes.POINTER(i32)] * 2
        per_sm, fb = ctypes.c_int(0), ctypes.c_int(0)
        if lib.structured_sketch_resident(d, n, 2 if one_bit else 0, ctypes.byref(per_sm),
                                          ctypes.byref(fb)):
            raise RuntimeError(f"structured_sketch variant {label!r}: occupancy query failed")
        rows, groups, _ = ft.structured_grid(n_pts, nblocks, fb.value, sm_count(dev),
                                             per_sm.value, d)
        part = torch.empty((2, groups, nblocks * d), dtype=torch.float64, device=dev)
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


def qsketch_calls(libs, x, w, dither, bits):
    """Kernel 3 of each library at ``bits`` on ``x``, ``w`` and ``dither``,
    and the plain version's result.  A library without the occupancy entry
    point (the source before the redesign) runs on that source's grid."""
    n_pts, n = x.shape
    m = w.shape[1]
    dev = x.device
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    scale = float(qz.quantization_scale(bits))
    calls = {}
    for label, lib in libs.items():
        lib.quantized_fourier_sketch_sums.argtypes = [ptr] * 4 + [
            i64, i32, i32, i32, f32, i64, i32, ptr, ptr, ptr]
        if hasattr(lib, "quantized_fourier_sketch_resident"):
            lib.quantized_fourier_sketch_resident.argtypes = [i32, i32] + [
                ctypes.POINTER(i32)] * 2
            resident, freqs = ctypes.c_int(0), ctypes.c_int(0)
            if lib.quantized_fourier_sketch_resident(n, int(bits == 1), ctypes.byref(resident),
                                                     ctypes.byref(freqs)):
                raise RuntimeError(f"quantized_fourier_sketch variant {label!r}: occupancy "
                                   "query failed")
            rows, groups, _ = fs.sketch_grid(n_pts, m, sm_count(dev), resident.value,
                                             freqs.value)
        else:
            rows, groups = _grid_before_one_wave(n_pts, -(-m // 256), sm_count(dev))
        q = torch.zeros((2, m), dtype=torch.int32, device=dev)

        def call(lib=lib, rows=rows, groups=groups, q=q):
            q.zero_()
            status = lib.quantized_fourier_sketch_sums(
                x.data_ptr(), w.data_ptr(), dither.data_ptr(), None, n_pts, n, m,
                int(bits == 1), scale, rows, groups, q[0].data_ptr(), q[1].data_ptr(),
                stream_ptr(dev))
            if status:
                raise RuntimeError(f"quantized_fourier_sketch variant launch failed ({status})")
            return q
        calls[label] = call
    return calls, fs.quantized_fourier_sketch_sums_plain(x, w, dither, bits)


def _grid_before_one_wave(n_pts: int, col_blocks: int, sms: int) -> tuple[int, int]:
    """Kernel 3's ``(rows_per_group, groups)`` before its one-wave redesign
    (commit 8d5cea6): about 8 blocks an SM, each of 256 to 16,384 rows."""
    groups = max(1, -(-8 * sms // col_blocks))
    groups = max(min(groups, max(1, -(-n_pts // 256))), -(-n_pts // 16384))
    rows = max(1, -(-n_pts // groups))
    return rows, max(1, -(-n_pts // rows))


def _split_before_clusters(p_cand: int, m: int, sms: int) -> tuple[int, int]:
    """Kernel 6's grid along m before its cluster redesign (commit
    8d5cea6): whole chunks of 1024 frequencies, split so that the grid of
    4-candidate blocks reaches 2 blocks an SM."""
    chunks = -(-m // 1024)
    wanted = max(1, -(-2 * sms // -(-p_cand // 4)))
    per_split = -(-chunks // min(chunks, wanted, 65535))
    return per_split * 1024, -(-chunks // per_split)


def shift_calls(libs, c, w, z1, z2, cluster_off: bool = False):
    """Kernel 6 of each library on ``c``, ``w``, ``z1``, ``z2`` (the current
    C interface's narrow or wide path by n, or the earlier
    ``sketch_shift_sums``),
    plus, with ``cluster_off``, the as-is source's narrow path with clusters
    of one CTA; and the plain version's result."""
    p_cand, n = c.shape
    m = w.shape[1]
    dev = c.device
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    out = torch.empty((p_cand * (n + 1),), dtype=torch.float32, device=dev)
    geo = ks.wide_grid(p_cand, n, m, sm_count(dev))
    scratch = torch.empty((max(geo["scratch"], 1),), dtype=torch.float32, device=dev)
    old_len, old_splits = _split_before_clusters(p_cand, m, sm_count(dev))
    part = torch.empty((old_splits * p_cand * (n + 1),), dtype=torch.float32, device=dev)
    args = (c.data_ptr(), w.data_ptr(), z1.data_ptr(), z2.data_ptr(), p_cand, n, m)
    entries = [(label, lib, False) for label, lib in libs.items()]
    if cluster_off and n <= ks.NARROW_MAX_N:
        entries.append((NO_CLUSTER, libs["as is"], True))
    calls = {}
    for label, lib, single in entries:
        if hasattr(lib, "sketch_shift_narrow"):
            lib.sketch_shift_narrow.argtypes = [ptr] * 4 + [i32] * 5 + [ptr, ptr]
            lib.sketch_shift_wide.argtypes = [ptr] * 4 + [i32] * 6 + [ptr, ptr, ptr]
            if n > ks.NARROW_MAX_N:
                def launch(lib=lib):
                    return lib.sketch_shift_wide(*args, geo["tp"], geo["splits"],
                                                 geo["split_len"], scratch.data_ptr(),
                                                 out.data_ptr(), stream_ptr(dev))
            else:
                cluster, split_len, _ = (1, m, 0) if single else ks.shift_grid(p_cand, m)

                def launch(lib=lib, cluster=cluster, split_len=split_len):
                    return lib.sketch_shift_narrow(*args, cluster, split_len, out.data_ptr(),
                                                   stream_ptr(dev))
        else:
            lib.sketch_shift_sums.argtypes = [ptr] * 4 + [i32] * 5 + [ptr, ptr, ptr]

            def launch(lib=lib):
                return lib.sketch_shift_sums(*args, old_len, old_splits, part.data_ptr(),
                                             out.data_ptr(), stream_ptr(dev))

        def call(launch=launch):
            status = launch()
            if status:
                raise RuntimeError(f"sketch_shift variant launch failed ({status})")
            return out[:p_cand], out[p_cand:].view(p_cand, n)
        calls[label] = call
    return calls, ks.sketch_shift_sums_plain(c, w, z1, z2)


def in_graph_us(calls: dict, launches: int = 100) -> None:
    """Each call captured ``launches`` times into a CUDA graph; prints the
    device time a launch of the replayed graph (median of 10 replays), in
    turns, as ``in_turns`` does."""
    graphs = {}
    for label, call in calls.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                call()
        graphs[label] = graph
    times = {label: [] for label in graphs}
    for order in (list(graphs), list(graphs)[::-1]):
        for label in order:
            times[label].append(median_ms(graphs[label].replay) * 1e3 / launches)
    for label in graphs:
        print(f"  {label}: {times[label][0]:.3f} / {times[label][1]:.3f} us a launch in a graph",
              flush=True)


def assign_calls(libs, x, c, path=None, resident=None):
    """Kernel 2 of each library on ``x`` and ``c``: through the launch plan
    (``aa.assign_plan``, ``path`` and ``resident`` forcing a choice; an
    ASSIGN_STAGES variant's plan sized for its ring) where the library has one,
    else through the C interface from before the redesign; and the plain
    version's result."""
    n_pts, n = x.shape
    k = c.shape[0]
    dev = x.device
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    labels = torch.empty((n_pts,), dtype=torch.int32, device=dev)
    dist = torch.empty((n_pts,), dtype=torch.float32, device=dev)
    out = (x.data_ptr(), c.data_ptr(), n_pts, n, k)
    calls = {}
    for label, lib in libs.items():
        if hasattr(lib, "assign_argmin_init"):
            lib.assign_argmin.argtypes = [ptr, ptr, i64, i32, i32, i32, i32, i64, i64] + [ptr] * 3
            if lib.assign_argmin_init():
                raise RuntimeError(f"assign_argmin variant {label!r}: shared-memory opt-in failed")
            stages = aa.TILE_STAGES
            aa.TILE_STAGES = ASSIGN_STAGES.get(label, stages)
            try:
                plan = aa.assign_plan(n_pts, n, k, path, resident)
            finally:
                aa.TILE_STAGES = stages

            def launch(lib=lib, plan=plan):
                return lib.assign_argmin(*out, plan.path == "tile", plan.resident, plan.grid,
                                         plan.smem, labels.data_ptr(), dist.data_ptr(),
                                         stream_ptr(dev))
        else:
            lib.assign_argmin.argtypes = [ptr, ptr, i64, i32, i32] + [ptr] * 3

            def launch(lib=lib):
                return lib.assign_argmin(*out, labels.data_ptr(), dist.data_ptr(),
                                         stream_ptr(dev))

        def call(launch=launch):
            status = launch()
            if status:
                raise RuntimeError(f"assign_argmin variant launch failed ({status})")
            return labels, dist
        calls[label] = call
    return calls, aa.assign_argmin_plain(x, c)


def host_us(x, c, call, reps: int = 2000) -> None:
    """Host microseconds a call of kernel 2's wrapper (``aa.assign_argmin``)
    and of the bare C call, back to back (where the device keeps up, the
    host time a launch), and of the wrapper's steps before its C call."""
    dev = x.device
    steps = {
        "wrapper": lambda: aa.assign_argmin(x, c),
        "C call": call,
        "  input checks": lambda: (aa._check_inputs(x, c), aa.check_cuda((("x", x), ("c", c)))),
        "  launch plan": lambda: aa.assign_plan(*x.shape, c.shape[0]),
        "  two outputs (new_empty)": lambda: (x.new_empty(x.shape[0], dtype=torch.int32),
                                              x.new_empty(x.shape[0])),
        "  on_device, _lib, stream_ptr": lambda: (aa.on_device(dev), aa._lib(dev),
                                                 aa.stream_ptr(dev)),
    }
    for label, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        print(f"  {label}: {(time.perf_counter() - t0) / reps * 1e6:.1f} us a call, host "
              "clock, back to back", flush=True)


def assign_check(out, ref) -> str:
    """Kernel 2's distance error and label flips against the plain version."""
    labels, dist = out
    return (f"max|d dist| = {float((dist - ref[1]).abs().max()):.3e}, labels differing "
            f"{int((labels != ref[0]).sum())}")


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


def max_err(out, ref, n_pts: int, what: str = "sums/N") -> str:
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(out, ref)) / n_pts
    return f"max|d({what})| = {err:.3e}"


KERNELS = ("fourier_sketch", "assign_argmin", "quantized_fourier_sketch", "structured_sketch",
           "sketch_shift", "flash_attention")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", action="append", default=[], metavar="NAME=PATH",
                        help="another csrc/NAME.cu to time beside this one")
    parser.add_argument("--only", default=",".join(KERNELS),
                        help="comma-separated kernels to run (default: all)")
    args = parser.parse_args()
    baselines = {}
    for spec in args.baseline:
        name, _, path = spec.partition("=")
        if name not in KERNELS or not path:
            parser.error(f"--baseline takes NAME=PATH with NAME one of {KERNELS}: {spec!r}")
        baselines[name] = Path(path)
    only = set(args.only.split(","))
    if only - set(KERNELS):
        parser.error(f"--only takes names from {KERNELS}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    tables = {"fourier_sketch": SKETCH_VARIANTS, "assign_argmin": ASSIGN_VARIANTS,
              "quantized_fourier_sketch": QSKETCH_VARIANTS,
              "structured_sketch": STRUCTURED_VARIANTS, "sketch_shift": SHIFT_VARIANTS,
              "flash_attention": FLASH_VARIANTS}
    libs = {name: build(name, tables[name], baselines.get(name),
                        "assign_tiles" if name == "assign_argmin" else None)
            for name in KERNELS if name in only}

    n_pts, m = 10_000_000, 1000
    x = synthetic.gaussian_mixture(0, n_pts, 10, 10, device=dev)
    g_sig, g_freq, g_dither = ckm.stream_keys(1, dev)
    sigma2 = frequencies.estimate_sigma2(g_sig, x[: ckm.CKMConfig(k=10, m=m).sigma2_sample],
                                         device=dev)
    w = frequencies.draw_frequencies(g_freq, m, 10, sigma2, device=dev)
    if "fourier_sketch" in libs:
        calls, ref = sketch_calls(libs["fourier_sketch"], x, w)
        print(f"[fourier_sketch] N={n_pts} n=10 m={m}", flush=True)
        in_turns(calls, lambda out: max_err(out, ref, n_pts))

    if "assign_argmin" in libs:
        assign_phase(libs["assign_argmin"], x, dev)

    if "quantized_fourier_sketch" in libs:
        # Kernel 3 at the fit shape, 1 and 4 bits; then the sweep's n = 100
        # (the chunked path), as is beside the baseline.
        dither = qz.draw_dither(g_dither, m)
        for bits in (1, 4):
            calls, ref = qsketch_calls(libs["quantized_fourier_sketch"], x, w, dither, bits)
            print(f"[quantized_fourier_sketch {bits}bit] fit shape N={n_pts} n=10 m={m}",
                  flush=True)
            in_turns(calls, lambda out: max_err(out, ref, n_pts, "q/N"))
        gen = torch.Generator(device=dev).manual_seed(0)
        xs = torch.randn((20_001, 100), generator=gen, device=dev) * 2
        ws = torch.randn((100, 300), generator=gen, device=dev)
        pair = {k: v for k, v in libs["quantized_fourier_sketch"].items()
                if k in ("as is", BASELINE)}
        for bits in (1, 4):
            calls, ref = qsketch_calls(pair, xs, ws, qz.draw_dither(g_dither, 300), bits)
            print(f"[quantized_fourier_sketch {bits}bit] sweep N=20001 n=100 m=300", flush=True)
            in_turns(calls, lambda out: max_err(out, ref, 20_001, "q/N"))
        del xs, calls

    if "structured_sketch" in libs:
        structured_libs = libs["structured_sketch"]
        # Kernels 4-5 at the fit shape; kernel 5 at 1 bit as is beside the
        # instance without the first-stage skip and the baseline only (the
        # other variants take out the float path's trig).
        op = freq_ops.make_operator("structured", g_freq, m, 10, sigma2, device=dev)
        pair = {k: v for k, v in structured_libs.items() if k in ("as is", BASELINE)}
        skip = {k: v for k, v in structured_libs.items() if k in ("as is", NO_SKIP, BASELINE)}
        narrow = {k: v for k, v in structured_libs.items() if k not in WIDE_ONLY}
        for one_bit, group in ((False, narrow), (True, skip)):
            calls, ref = structured_calls(group, x, op, one_bit)
            what = "quantized_structured_sketch 1bit" if one_bit else "structured_sketch"
            print(f"[{what}] fit shape N={n_pts} n=10 d={op.d} m={m}", flush=True)
            in_turns(calls, lambda out: max_err(out, ref, n_pts))

    if "sketch_shift" in libs:
        # Kernel 6 at the decoder's swarm on the fit's sketch, eagerly and
        # in a graph (with the narrow path's clusters of one CTA beside).
        gen = torch.Generator(device=dev).manual_seed(0)
        lo, hi = torch.amin(x, 0), torch.amax(x, 0)
        c_s, s_s = fs.fourier_sketch_sums_plain(x[:1_000_000], w, torch.ones(
            (1_000_000,), device=dev))
        z = torch.cat([c_s, -s_s]) / 1_000_000
        cand = (lo + torch.rand((80, 10), generator=gen, device=dev) * (hi - lo)).contiguous()
        calls, ref = shift_calls(libs["sketch_shift"], cand, w, z[:m], z[m:], cluster_off=True)
        print(f"[sketch_shift] decoder shape P=80 n=10 m={m}", flush=True)
        in_turns(calls, lambda out: max_err(out, ref, m, "f, g / m"))
        in_graph_us(calls)
    del x

    if {"structured_sketch", "sketch_shift"} & set(libs):
        wide_n, wide_dim, wide_m = 100_003, 2048, 20_000
        xw = synthetic.gaussian_mixture(0, wide_n, 10, wide_dim, device=dev)
        sigma2_w = frequencies.estimate_sigma2(g_sig, xw[: ckm.CKMConfig(k=10).sigma2_sample],
                                               device=dev)
        op_w = freq_ops.make_operator("structured", g_freq, wide_m, wide_dim, sigma2_w,
                                      device=dev)
        if "structured_sketch" in libs:
            calls, ref = structured_calls(narrow, xw, op_w, False)
            print(f"[structured_sketch] wide N={wide_n} n={wide_dim} d={op_w.d} m={wide_m}",
                  flush=True)
            in_turns(calls, lambda out: max_err(out, ref, wide_n))
        if "sketch_shift" in libs:
            ones = torch.ones((wide_n,), device=dev)
            c_w, s_w = ft.structured_sketch_sums_plain(xw, op_w.diags, op_w.radii, ones)
            z_w = torch.cat([c_w.reshape(-1)[:wide_m], -s_w.reshape(-1)[:wide_m]]) / wide_n
            lo_w, hi_w = torch.amin(xw, 0), torch.amax(xw, 0)
            cand = (lo_w + torch.rand((80, wide_dim), generator=gen, device=dev)
                    * (hi_w - lo_w)).contiguous()
            w_dense = op_w.materialize().contiguous()
            calls, ref = shift_calls(libs["sketch_shift"], cand, w_dense, z_w[:wide_m],
                                     z_w[wide_m:])
            print(f"[sketch_shift] wide P=80 n={wide_dim} m={wide_m}", flush=True)
            in_turns(calls, lambda out: max_err(out, ref, wide_m, "f, g / m"))
            del w_dense
        del calls, xw
        if "structured_sketch" in libs:
            # The smoke run's sweep of the other block widths (N = 20,001,
            # three blocks, the last one ragged): as is beside the baseline.
            gen = torch.Generator(device=dev).manual_seed(0)
            for n_s in (40, 100, 200, 500, 1000):
                xs = torch.randn((20_001, n_s), generator=gen, device=dev)
                d_s = 1 << (n_s - 1).bit_length()
                op_s = freq_ops.make_operator("structured", g_freq, 3 * d_s - 5, n_s, 1.0,
                                              device=dev)
                calls, ref = structured_calls(pair, xs, op_s, False)
                print(f"[structured_sketch] sweep N=20001 n={n_s} d={op_s.d} m={3 * d_s - 5}",
                      flush=True)
                in_turns(calls, lambda out: max_err(out, ref, 20_001))
            del calls
            wide_blocks_phase(structured_libs, g_freq, dev)

    if "flash_attention" in libs:
        gen = torch.Generator(device=dev).manual_seed(0)
        h, kvh, s_a, hd = 32, 8, 4096, 64
        q, k, v = (torch.randn((n_h, s_a, hd), generator=gen, device=dev).to(torch.bfloat16)
                   for n_h in (h, kvh, kvh))
        calls, po = flash_calls(libs["flash_attention"], q, k, v, h // kvh)
        po = po.float()
        print(f"[flash_attention] BH={h} BKV={kvh} S={s_a} hd={hd} causal bf16", flush=True)
        in_turns(calls, lambda o: "|do| against the bar 2^-7 |o| + 1e-4: "
                 f"{float(((o.float() - po).abs() / (2.0**-7 * po.abs() + 1e-4)).max()):.3f} "
                 "of it")


def wide_blocks_phase(libs, g_freq, dev) -> None:
    """Kernel 4 at the smoke run's wide blocks (the wide kernel): d = 4096
    and 16384 on 20,001 rows (n = d and 12288, two blocks and one), d = 8192
    (n = 6144, two blocks) on 200,003 rows, and kernel 5 at 1 bit there;
    every variant but the narrow kernel's own.  Then the monitor's update
    (4 rows) at d_model 4096, 6144 and 12288 (K = 4) and at 12288 with K =
    8 (24 blocks): as is beside the baseline."""
    wide = {k: v for k, v in libs.items() if k != NO_SKIP}
    gen = torch.Generator(device=dev).manual_seed(31)
    for n, m, n_pts in ((4096, 2 * 4096 - 5, 20_001), (12288, 16384 - 5, 20_001),
                        (6144, 2 * 8192 - 5, 200_003)):
        op = freq_ops.make_operator("structured", g_freq, m, n, 1.0, device=dev)
        xs = torch.randn((n_pts, n), generator=gen, device=dev)
        for one_bit in (False, True) if op.d == 8192 else (False,):
            group = {k: v for k, v in wide.items()
                     if not one_bit or "no flush" not in k}
            calls, ref = structured_calls(group, xs, op, one_bit)
            what = "quantized_structured_sketch 1bit" if one_bit else "structured_sketch"
            print(f"[{what}] wide block N={n_pts} n={n} d={op.d} m={m}", flush=True)
            in_turns(calls, lambda out: max_err(out, ref, n_pts))
        del xs, op, calls
    pair = {k: v for k, v in libs.items() if k in ("as is", BASELINE)}
    for dim, k in ((4096, 4), (6144, 4), (12288, 4), (12288, 8)):
        op = freq_ops.make_operator("structured", g_freq, 4 * k * dim, dim, 1.0, device=dev)
        xs = torch.randn((4, dim), generator=gen, device=dev)
        calls, ref = structured_calls(pair, xs, op, False)
        print(f"[structured_sketch] monitor update N=4 n={dim} d={op.d} "
              f"nblocks={op.nblocks}", flush=True)
        in_turns(calls, lambda out: max_err(out, ref, 4))
        del xs, op, calls


def assign_phase(libs, x, dev) -> None:
    """Kernel 2: every library at the main path's shape (10 centroids of the
    fit's data), at the KV-cache shapes (the smoke run's planted keys: 64
    clusters of head_dim 256, 8129 keys, centroids drawn from the keys) and
    at n = 784 and 2048 (the KV shapes also as 100 launches in a CUDA
    graph); then the as-is library's tile path with resident and streamed
    rows, and its two paths at n <= 64."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cents = x[torch.randperm(x.shape[0], generator=gen, device=dev)[:10]].contiguous()
    calls, ref = assign_calls(libs, x, cents)
    print(f"[assign_argmin] main shape N={x.shape[0]} n=10 K=10", flush=True)
    in_turns(calls, lambda out: assign_check(out, ref))
    planted = torch.randn((64, 256), generator=gen, device=dev) * 4
    keys = (planted[torch.randint(0, 64, (8129,), generator=gen, device=dev)]
            + 0.1 * torch.randn((8129, 256), generator=gen, device=dev))
    shapes = [(keys, k_s, f"kv shape N=8129 n=256 K={k_s}") for k_s in (64, 16)]
    for n_s in (784, 2048):
        xs = torch.randn((20_001, n_s), generator=gen, device=dev) * 3
        shapes.append((xs, 64, f"N=20001 n={n_s} K=64"))
    for xs, k_s, what in shapes:
        cs = xs[torch.randperm(xs.shape[0], generator=gen, device=dev)[:k_s]].contiguous()
        calls, ref = assign_calls(libs, xs, cs)
        print(f"[assign_argmin] {what}", flush=True)
        in_turns(calls, lambda out: assign_check(out, ref))
        if xs.shape[0] == 8129:  # launches this short: the device time alone
            in_graph_us(calls)
            host_us(xs, cs, calls["as is"])
    del shapes, keys
    as_is = {"as is": libs["as is"]}
    # Resident point rows against rows streamed with each centroid tile.
    for n_s in (256, 512, 736):
        xs = torch.randn((20_001, n_s), generator=gen, device=dev) * 3
        cs = torch.randn((300, n_s), generator=gen, device=dev) * 3
        both = {}
        for resident in (True, False):
            calls, ref = assign_calls(as_is, xs, cs, "tile", resident)
            both["resident rows" if resident else "streamed rows"] = calls["as is"]
        print(f"[assign_argmin staging] N=20001 n={n_s} K=300", flush=True)
        in_turns(both, lambda out: assign_check(out, ref))
    # The switch at n <= 64: the point path against the tile path.
    for n_s in (10, 16, 32, 64):
        xs = torch.randn((1_000_000, n_s), generator=gen, device=dev) * 3
        for k_s in (16, 32, 48, 64, 128):
            cs = torch.randn((k_s, n_s), generator=gen, device=dev) * 3
            both = {}
            for path in ("point", "tile"):
                calls, ref = assign_calls(as_is, xs, cs, path)
                both[f"{path} path"] = calls["as is"]
            print(f"[assign_argmin paths] N=1000000 n={n_s} K={k_s}", flush=True)
            in_turns(both, lambda out: assign_check(out, ref))


if __name__ == "__main__":
    main()
