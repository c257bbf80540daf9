"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    PYTHONPATH=src python3 chip_smoke.py      (the script also finds src/ itself)

Phases, one line each: the card's name and power limit; the kernels' build
(nvcc, one process per source, all started together, into build/kernels/);
the data (the paper's large-scale setting: N = 10^7 points of a 10-cluster
Gaussian mixture in R^10, m = 1000 frequencies); each kernel held against its
plain PyTorch version at the main path's shapes and at ragged ones; ckm.fit,
ckm.fit_streaming and lloyd.kmeans, each with the launch counts it caused;
the SSE of CKM against k-means with 5 replicates; where fit's time goes (the
sketch pass alone, and a short decode under torch.profiler); then one JSON
line of per-kernel numbers and, last, the device line.  Any failed check
raises and the script exits non-zero before the last line.  Without a CUDA
card it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# Data and run sizes: the paper's Fig. 4 / §4 large-scale setting.
N, K, DIM, M = 10_000_000, 10, 10, 1000
STREAM_CHUNKS = 10
KMEANS_REPLICATES = 5
RAGGED_N = 1_000_003
DATA_SEED, FIT_SEED, KMEANS_SEED = 0, 1, 2
TIMED_LAUNCHES = 10

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

# Tolerances against the plain versions on the card, with their reasons.
# fourier_sketch, on sums / N: the repo's 1e-4 bar across engine backends.
SKETCH_TOL = 1e-4
# assign_argmin distances: ||x||^2 - 2 x.c + ||c||^2 in float32, in two
# expression orders, differs by a few ulps of its largest terms: the bar is
# 32 ulps (4e-6) of max ||x_i||^2 + max ||c_k||^2.
DIST_RTOL = 4e-6
# |z_stream - z|: the same points summed over other batch boundaries.
STREAM_TOL = 1e-5
# CKM's SSE over k-means x5 SSE: CKM's decode varies with the seed, and this
# bar catches a broken port, not that variation.
MAX_RELATIVE_SSE = 1.5


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def median_ms(fn) -> float:
    """Median of TIMED_LAUNCHES CUDA-event timings, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_LAUNCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    memory rate and FP32 operations over the FP32 peak, in ms."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sketch_bound(n_pts: int, n: int, m: int) -> tuple[float, str]:
    # Bytes: x, w, beta read once, the two (m,) sums written once.  Operations
    # per (point, frequency): n FMAs of the phase (2n), sin and cos counted as
    # one each (an understatement: sincosf takes tens of instructions), and
    # two weighted FMA accumulates (4).
    n_bytes = 4 * (n_pts * n + n * m + n_pts + 2 * m)
    return bound(n_bytes, n_pts * m * (2 * n + 6))


def assign_bound(n_pts: int, n: int, k: int) -> tuple[float, str]:
    # Bytes: x and c read once, labels and distances written once (8 B a
    # point).  Operations per (point, centroid): the dot product (2n), the
    # scale-and-subtract and the compare (3).
    n_bytes = 4 * (n_pts * n + k * n) + 8 * n_pts
    return bound(n_bytes, n_pts * k * (2 * n + 3))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    lines = log.splitlines()
    regs = [ln.split("Used ")[1].split(" registers")[0] for ln in lines if "Used " in ln]
    spilled = any("spill stores" in ln and " 0 bytes spill stores" not in ln for ln in lines)
    return f"registers per kernel {regs}, spills {'yes' if spilled else 'none'}"


def check_sketch(fs, x, w, beta, label):
    """fourier_sketch kernel vs its plain version on the card."""
    n_pts = x.shape[0]
    c1, s1 = fs.fourier_sketch_sums(x, w, beta)
    c2, s2 = fs.fourier_sketch_sums(x, w, beta)
    torch.cuda.synchronize()
    repeatable = torch.equal(c1, c2) and torch.equal(s1, s2)
    pc, ps = fs.fourier_sketch_sums_plain(x, w, beta)
    err = max(
        float(torch.amax(torch.abs(c1 - pc))), float(torch.amax(torch.abs(s1 - ps)))
    ) / n_pts
    check(err <= SKETCH_TOL, f"fourier_sketch {label}: max|d(sums/N)| {err:.3e} > {SKETCH_TOL}")
    check(repeatable, f"fourier_sketch {label}: two launches differ bitwise")
    line = (
        f"[fourier_sketch {label}] N={n_pts} n={x.shape[1]} m={w.shape[1]} "
        f"max|d(sums/N)|={err:.3e} (tol {SKETCH_TOL}) bitwise-repeatable"
    )
    out = {"max_abs_err": err}
    out["ms"] = median_ms(lambda: fs.fourier_sketch_sums(x, w, beta))
    out["plain_ms"] = median_ms(lambda: fs.fourier_sketch_sums_plain(x, w, beta))
    out["bound_ms"], out["bound_by"] = sketch_bound(n_pts, x.shape[1], w.shape[1])
    line += (
        f"  kernel {out['ms']:.3f} ms  plain {out['plain_ms']:.3f} ms  "
        f"bound {out['bound_ms']:.3f} ms ({out['bound_by']})"
    )
    print(line, flush=True)
    return out


def check_assign(aa, x, c, label, dup_of=None):
    """assign_argmin kernel vs its plain version on the card.  Labels may
    differ only at near-ties, where the distances to both labels agree within
    the distance tolerance.  With ``dup_of = (i, j)``, centroid j repeats centroid
    i < j and must never win (ties go to the lowest index)."""
    lab, dist = aa.assign_argmin(x, c)
    plab, pdist = aa.assign_argmin_plain(x, c)
    scale = float(torch.amax(torch.sum(x * x, dim=1)) + torch.amax(torch.sum(c * c, dim=1)))
    tol = DIST_RTOL * scale
    err = float(torch.amax(torch.abs(dist - pdist)))
    check(err <= tol, f"assign_argmin {label}: max|d dist| {err:.3e} > {tol:.3e}")
    diff = torch.nonzero(lab != plab).reshape(-1)
    if diff.numel():
        d_all = torch.sum((x[diff][:, None, :] - c[None]) ** 2, dim=-1)
        gap = torch.abs(
            d_all.gather(1, lab[diff].long()[:, None]) - d_all.gather(1, plab[diff].long()[:, None])
        )
        check(float(gap.max()) <= tol, f"assign_argmin {label}: label mismatch off a tie")
    line = (
        f"[assign_argmin {label}] N={x.shape[0]} n={x.shape[1]} K={c.shape[0]} "
        f"max|d dist|={err:.3e} (tol {tol:.2e}) near-tie label flips={diff.numel()}"
    )
    if dup_of is not None:
        check(int((lab == dup_of[1]).sum()) == 0, f"assign_argmin {label}: tie not to lowest index")
        line += " ties-to-lowest"
    out = {"max_abs_err": err}
    out["ms"] = median_ms(lambda: aa.assign_argmin(x, c))
    out["plain_ms"] = median_ms(lambda: aa.assign_argmin_plain(x, c))
    out["bound_ms"], out["bound_by"] = assign_bound(x.shape[0], x.shape[1], c.shape[0])
    line += (
        f"  kernel {out['ms']:.3f} ms  plain {out['plain_ms']:.3f} ms  "
        f"bound {out['bound_ms']:.3f} ms ({out['bound_by']})"
    )
    print(line, flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(1)

    from repro_torch.core import ckm, frequencies, lloyd
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels import assign_argmin as aa
    from repro_torch.kernels import fourier_sketch as fs

    # Full-precision FP32 for every product the plain versions take.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. The card.
    print(card_line(), flush=True)

    # 2. The build.
    t0 = time.perf_counter()
    libs = _build.build()
    print(
        f"[build] {time.perf_counter() - t0:.1f}s: " + ", ".join(p.name for p in libs),
        flush=True,
    )
    for name, log in sorted(_build.PTXAS.items()):
        print(f"[ptxas {name}] {ptxas_summary(log)}", flush=True)

    # 3. The data.
    t0 = time.perf_counter()
    x = synthetic.gaussian_mixture(DATA_SEED, N, K, DIM, device=dev)
    torch.cuda.synchronize()
    print(f"[data] N={N} K={K} n={DIM} m={M} in {time.perf_counter() - t0:.2f}s", flush=True)

    # 4. Each kernel against its plain version, at the main path's shapes.
    cfg = ckm.CKMConfig(k=K, m=M)
    g_sig, g_freq, _ = ckm.stream_keys(FIT_SEED, dev)
    sigma2 = frequencies.estimate_sigma2(g_sig, x[: cfg.sigma2_sample], device=dev)
    w = frequencies.draw_frequencies(g_freq, M, DIM, sigma2, device=dev)
    ones = torch.ones((N,), dtype=torch.float32, device=dev)
    results = {"fourier_sketch": check_sketch(fs, x, w, ones, "fit shape")}
    chunk = N // STREAM_CHUNKS
    check_sketch(fs, x[:chunk], w, ones[:chunk], "stream-batch shape")
    check_sketch(fs, x[:RAGGED_N], w, ones[:RAGGED_N], "ragged")
    gen = torch.Generator(device=dev).manual_seed(DATA_SEED)
    beta = torch.rand((20_001,), generator=gen, device=dev)
    for n_small in (3, 70):
        xs = torch.randn((20_001, n_small), generator=gen, device=dev) * 2
        ws = torch.randn((n_small, 300), generator=gen, device=dev)
        check_sketch(fs, xs, ws, beta, f"n={n_small}")

    cents = x[torch.randperm(N, generator=gen, device=dev)[:K]].contiguous()
    results["assign_argmin"] = check_assign(aa, x, cents, "kmeans shape")
    dup = cents.clone()
    dup[3] = dup[0]
    check_assign(aa, x[:RAGGED_N], dup, "ragged", dup_of=(0, 3))
    for n_small in (3, 70):
        xs = torch.randn((20_001, n_small), generator=gen, device=dev) * 3
        cs = torch.randn((7, n_small), generator=gen, device=dev) * 3
        check_assign(aa, xs, cs, f"n={n_small}")

    # 5-7. The main path, each phase with the launch counts it caused.
    launches = {"fourier_sketch": 0, "assign_argmin": 0}
    phase_s = {}

    def run(label, fn, needs):
        fs.LAUNCHES = aa.LAUNCHES = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = phase_s[label] = time.perf_counter() - t0
        counts = {"fourier_sketch": fs.LAUNCHES, "assign_argmin": aa.LAUNCHES}
        for name, n_launch in counts.items():
            launches[name] += n_launch
        check(counts[needs] >= 1, f"{label} did not launch the {needs} kernel")
        print(f"[{label}] {secs:.2f}s  launches {counts}", flush=True)
        return out

    res = run("fit", lambda: ckm.fit(FIT_SEED, x, cfg, device=dev), "fourier_sketch")
    check(tuple(res.centroids.shape) == (K, DIM), "fit centroids shape")
    check(bool(torch.isfinite(res.centroids).all()), "fit centroids finite")
    check(abs(float(res.weights.sum()) - 1.0) < 1e-4, "fit weights sum to 1")

    batches = torch.split(x, chunk)
    res_s = run(
        "fit_streaming",
        lambda: ckm.fit_streaming(FIT_SEED, iter(batches), cfg, device=dev),
        "fourier_sketch",
    )
    dz = float(torch.amax(torch.abs(res_s.sketch - res.sketch)))
    check(dz <= STREAM_TOL, f"|z_stream - z| {dz:.3e} > {STREAM_TOL}")
    check(bool(torch.isfinite(res_s.centroids).all()), "fit_streaming centroids finite")

    km = run(
        "kmeans",
        lambda: lloyd.kmeans(
            KMEANS_SEED, x, lloyd.LloydConfig(k=K, replicates=KMEANS_REPLICATES), device=dev
        ),
        "assign_argmin",
    )

    # 8. Quality.
    sse_ckm = float(ckm.sse(x, res.centroids, device=dev)) / N
    sse_stream = float(ckm.sse(x, res_s.centroids, device=dev)) / N
    sse_km = float(km.sse) / N
    rel = sse_ckm / sse_km
    print(
        f"[quality] SSE/N ckm {sse_ckm:.4f}  ckm-stream {sse_stream:.4f}  "
        f"kmeans x{KMEANS_REPLICATES} {sse_km:.4f} (iters {km.iters})  "
        f"relative SSE {rel:.4f} (stream {sse_stream / sse_km:.4f}, limit "
        f"{MAX_RELATIVE_SSE})  |z_stream - z|={dz:.2e} (tol {STREAM_TOL})  "
        f"sigma2={float(res.sigma2):.4f}",
        flush=True,
    )
    check(rel <= MAX_RELATIVE_SSE, f"relative SSE {rel:.4f} > {MAX_RELATIVE_SSE}")

    # 9. Where fit's time goes: the sketch pass alone, then a short decode
    # under the profiler (its wall time includes the profiler's own cost).
    t0 = time.perf_counter()
    ckm.compute_sketch(FIT_SEED, x, cfg, device=dev)
    torch.cuda.synchronize()
    sketch_s = time.perf_counter() - t0
    short = dataclasses.replace(cfg, atom_steps=30, joint_steps=20, final_steps=100)
    adam_steps = 2 * K * (short.atom_steps + short.joint_steps) + short.final_steps
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        ckm.decode_sketch(FIT_SEED, res.sketch, res.freq_op, *res.bounds, short, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_ops = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in device_ops) / 1e6
    n_ops = sum(e.count for e in device_ops)
    print(
        f"[fit time] fit {phase_s['fit']:.2f}s = sketch pass {sketch_s:.3f}s + decode "
        f"{phase_s['fit'] - sketch_s:.2f}s; profiled short decode ({adam_steps} Adam "
        f"steps): wall {wall:.2f}s, device busy {busy:.3f}s ({100 * busy / wall:.1f}%), "
        f"{n_ops} device operations, {n_ops / adam_steps:.1f} per Adam step"
        + ("" if busy else " (the profiler saw no device time: busy share not measured)"),
        flush=True,
    )

    # 10. Per-kernel numbers.
    meta = {
        "fourier_sketch": ("src/repro_torch/kernels/csrc/fourier_sketch.cu",
                           "src/repro/kernels/fourier_sketch.py:131"),
        "assign_argmin": ("src/repro_torch/kernels/csrc/assign_argmin.cu",
                          "src/repro/kernels/assign_argmin.py:35"),
    }
    rows = []
    for name, (source, replaces) in meta.items():
        r = results[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": rows}), flush=True)

    # 11. The device line.
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
