"""Kernel 5's 1-bit codes at d = 1024 against the boundary rule, over many
draws (one CUDA card; never imports JAX).

    PYTHONPATH=src python3 tests/_torch_flip_probe.py [--draws 20]

Each draw is chip_smoke.py's 1-bit sweep case at n = 1000: N = SWEEP_N rows
of randn, a structured operator of m = 3 d - 5 frequencies (d = 1024) at
sigma^2 = 1 and its dither.  Draws:

- "smoke": the smoke run's own input, rebuilt by replaying its generators'
  calls in the order of its main() up to that case (sizes only: no draw
  there depends on a value);
- "smoke, kv on the shared generator": the same with section 4's kv-ckm
  inputs (planted keys, the two centroid draws, sigma^2 and the
  frequencies of kernel 1's check) drawn from the shared generator in place
  of their own, as that block's first version did;
- 0 .. D-1: rows, operator and dither from a generator of their own each.

For each draw it prints kernel 5 (1 bit) against its plain version: the
differing entries, max |dq| / N against CODE_TOL, whether
chip_smoke.structured_flips (the boundary rule) holds, and each flipped
(row, entry), found by bisecting rows (the kernel's sums are split-exact):
|cos| or |sin| of its float64 phase over the rule's tolerance, and which of
the kernel's and the plain version's codes disagrees with the float64 sign.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ckm, freq_ops, frequencies, quantize  # noqa: E402
from repro_torch.kernels import freq_transform as ft  # noqa: E402
from repro_torch.serve import kv_clustering as kvc  # noqa: E402

N_PROBE = 1000


def replay(dev, shared_kv: bool):
    """The smoke run's (rows, operator, dither) of its 1-bit sweep case at
    n = N_PROBE: every call on its generators before it, in main()'s order,
    at main()'s sizes (values that move no generator are left at 1)."""
    g_sig, g_freq, _ = ckm.stream_keys(cs.FIT_SEED, dev)
    frequencies.draw_frequencies(g_freq, cs.M, cs.DIM, 1.0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cs.DATA_SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    rand(20_001)
    for n_small in (3, 70):
        randn(20_001, n_small), randn(n_small, 300)
    torch.randperm(cs.N, generator=gen, device=dev)
    for n_small in (3, 70):
        randn(20_001, n_small), randn(7, n_small)
    if shared_kv:
        hd = get_config("gemma3-1b").head_dim_
        n_keys = cs.LM_SERVE["gemma3-1b"][1] - cs.KV_RING + 1
        planted = randn(cs.KV_CENTROIDS, hd) * 4
        keys = (planted[torch.randint(0, cs.KV_CENTROIDS, (n_keys,), generator=gen, device=dev)]
                + 0.1 * randn(n_keys, hd))
        for _ in cs.KV_SHAPE_KS:
            torch.randperm(n_keys, generator=gen, device=dev)
        s2 = float(frequencies.estimate_sigma2(gen, keys[:kvc.SIGMA2_SAMPLE], device=dev))
        frequencies.draw_frequencies(gen, 5 * cs.KV_CENTROIDS * hd, hd, s2 * kvc.SIGMA2_BOOST,
                                     device=dev)
    g_dither = ckm.stream_keys(cs.FIT_SEED, dev)[2]
    quantize.draw_dither(g_dither, cs.M)
    freq_ops.make_operator("structured", g_freq, cs.M, cs.DIM, 1.0, device=dev)
    freq_ops.make_operator("structured", g_freq, cs.WIDE_M, cs.WIDE_DIM, 1.0, device=dev)
    quantize.draw_dither(g_dither, cs.WIDE_M)
    rand(cs.SHIFT_P, cs.DIM)
    frequencies.draw_frequencies(g_freq, cs.RAGGED_M, cs.DIM, 1.0, device=dev)
    rand(cs.RAGGED_P, cs.DIM)
    rand(cs.SHIFT_P, cs.WIDE_DIM)
    for p_s, n_s, m_s in cs.SHIFT_SWEEP:
        randn(20_001, n_s), randn(n_s, m_s), rand(p_s, n_s)
    rand(cs.K, cs.DIM), randn(256, 130), randn(130), randn(130)
    rand(cs.SWEEP_N)
    quantize.draw_dither(g_dither, cs.SWEEP_M)
    for n_s in cs.SWEEP_DENSE_NS:
        randn(cs.SWEEP_N, n_s), randn(n_s, cs.SWEEP_M), randn(7, n_s)
    randn(cs.SWEEP_N, cs.LARGE_PHASE_N), randn(cs.LARGE_PHASE_N, cs.SWEEP_M)
    for n_s in cs.SWEEP_STRUCTURED_NS:
        xs = randn(cs.SWEEP_N, n_s)
        d_s = max(32, 1 << (n_s - 1).bit_length())
        op = freq_ops.make_operator("structured", g_freq, 3 * d_s - 5, n_s, 1.0, device=dev)
        dither = quantize.draw_dither(g_dither, 3 * d_s - 5)
        if n_s == N_PROBE:
            return xs, op, dither
    raise RuntimeError(f"the smoke's structured sweep has no n = {N_PROBE}")


def fresh(dev, i: int):
    g = device_mod.generator(device_mod.derive_seed(cs.DATA_SEED, 400, i), dev)
    d_s = 1 << (N_PROBE - 1).bit_length()
    xs = torch.randn((cs.SWEEP_N, N_PROBE), generator=g, device=dev)
    op = freq_ops.make_operator("structured", g, 3 * d_s - 5, N_PROBE, 1.0, device=dev)
    return xs, op, quantize.draw_dither(g, 3 * d_s - 5)


def flipped_rows(kernel, plain, lo, hi, entries, out):
    """Rows in [lo, hi) where the kernel's code differs from the plain
    version's at one of ``entries`` ((which, flat index) pairs), by
    bisection on the split-exact sums."""
    got, ref = kernel(lo, hi), plain(lo, hi)
    live = [(w, j) for w, j in entries
            if int(got[w].reshape(-1)[j]) != int(ref[w].reshape(-1)[j])]
    if not live:
        return
    if hi - lo == 1:
        out.extend((lo, w, j) for w, j in live)
        return
    mid = (lo + hi) // 2
    flipped_rows(kernel, plain, lo, mid, live, out)
    flipped_rows(kernel, plain, mid, hi, live, out)


def probe(label, xs, op, dither) -> bool:
    n_pts = xs.shape[0]
    padded = torch.nn.functional.pad(dither, (0, op.nblocks * op.d - op.m))
    padded = padded.reshape(op.nblocks, op.d).contiguous()

    def kernel(lo, hi):
        return ft.quantized_structured_sketch_sums(xs[lo:hi], op.diags, op.radii, padded, 1)

    def plain(lo, hi):
        return ft.quantized_structured_sketch_sums_plain(xs[lo:hi], op.diags, op.radii, padded, 1)

    got, ref = kernel(0, n_pts), plain(0, n_pts)
    diff = torch.stack([(a.long() - b.long()).reshape(-1) for a, b in zip(got, ref)])
    entries = [tuple(e) for e in torch.nonzero(diff).tolist()]
    err = float(diff.abs().max()) / n_pts
    try:
        _, n_near, _ = cs.structured_flips(f"probe {label}", xs, op, padded, got, ref)
        rule = f"boundary rule holds ({n_near} boundary rows)"
        ok = True
    except RuntimeError as exc:
        rule, ok = f"BOUNDARY RULE FAILS: {exc}", False
    print(f"[flip probe {label}] N={n_pts} n={N_PROBE} d={op.d} m={op.m}: differing entries "
          f"{len(entries)}, max|dq|/N {err:.3e} ({'over' if err > cs.CODE_TOL else 'within'} "
          f"CODE_TOL {cs.CODE_TOL}); {rule}", flush=True)
    rows = []
    flipped_rows(kernel, plain, 0, n_pts, entries, rows)
    w64 = cs.structured_w64(op)
    d64 = padded.reshape(-1).double()
    for r, which, j in rows:
        xr = xs[r].double()
        theta = float(xr @ w64[:, j] + d64[j])
        mag = float(xr.abs() @ w64[:, j].abs() + d64[j].abs())
        trig = torch.cos(torch.tensor(theta, dtype=torch.float64)) if which == 0 else \
            torch.sin(torch.tensor(theta, dtype=torch.float64))
        sign64 = 1 if float(trig) >= 0 else -1
        k_code = int(kernel(r, r + 1)[which].reshape(-1)[j])
        p_code = int(plain(r, r + 1)[which].reshape(-1)[j])
        tol = 1e-6 * (1 + mag)
        print(f"  row {r} {'cos' if which == 0 else 'sin'} entry {j}: phase {theta:.6f}, "
              f"|trig| {abs(float(trig)):.3e} = {abs(float(trig)) / tol:.3f} x tol {tol:.3e}; "
              f"float64 sign {sign64:+d}, kernel {k_code:+d}, plain {p_code:+d}", flush=True)
    return ok


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--draws", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    draws = [("smoke", lambda: replay(dev, False)),
             ("smoke, kv on the shared generator", lambda: replay(dev, True))]
    draws += [(f"draw {i}", lambda i=i: fresh(dev, i)) for i in range(args.draws)]
    failed = [label for label, make in draws if not probe(label, *make())]
    print(f"[flip probe] {len(draws)} draws; boundary rule fails on {failed or 'none'}",
          flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
