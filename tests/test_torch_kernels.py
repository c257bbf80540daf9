"""The port's kernel modules on the CPU: each plain version against the
reference's kernel (Pallas in interpret mode), the device dispatch, and the
kernel wrappers' refusal of what the CUDA kernels do not take.

The CUDA kernels themselves run only on a card; ``chip_smoke.py`` holds each
of them against its plain version there.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import freq_ops as jfo
from repro.kernels import ops as jops
from repro_torch.core import freq_ops as tfo
from repro_torch.core.engine import SketchEngine
from repro_torch.kernels import _build
from repro_torch.kernels import amp_denoise as kamp
from repro_torch.kernels import assign_argmin as aa
from repro_torch.kernels import fourier_sketch as fs
from repro_torch.kernels import freq_transform as ft
from repro_torch.kernels import ops as kops
from repro_torch.kernels import sketch_shift as kss

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]


def _sketch_inputs(seed, n_pts, feat, m):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_pts, feat)) * 2.0).astype(np.float32)
    w = rng.standard_normal((feat, m)).astype(np.float32)
    beta = rng.uniform(size=n_pts).astype(np.float32)
    return x, w, beta


@pytest.mark.parametrize(
    "n_pts,feat,m",
    [(100, 10, 130), (1, 3, 7), (333, 24, 257), (1000, 10, 1000)],
)
def test_fourier_sketch_plain_matches_reference_kernel(n_pts, feat, m):
    """Sums / N agree with the reference's Pallas kernel within 1e-4 (the
    repo's bar across sketch backends), at ragged N and m."""
    x, w, beta = _sketch_inputs(0, n_pts, feat, m)
    jc, js = jops.fourier_sketch_sums(
        jnp.asarray(x), jfo.as_operator(jnp.asarray(w)), jnp.asarray(beta),
        block_n=128, block_m=128, interpret=True,
    )
    tc, ts = fs.fourier_sketch_sums_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(beta)
    )
    np.testing.assert_allclose(tc.numpy() / n_pts, np.asarray(jc) / n_pts, atol=1e-4)
    np.testing.assert_allclose(ts.numpy() / n_pts, np.asarray(js) / n_pts, atol=1e-4)


def test_fourier_sketch_plain_chunking_is_invisible(monkeypatch):
    """Rows summed over several chunks give the one-chunk sums."""
    x, w, beta = (torch.from_numpy(a) for a in _sketch_inputs(1, 1000, 5, 64))
    whole = fs.fourier_sketch_sums_plain(x, w, beta)
    monkeypatch.setattr(fs, "_PLAIN_CHUNK", 128)
    parts = fs.fourier_sketch_sums_plain(x, w, beta)
    for a, b in zip(whole, parts):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-4)


H100_SMS = 132


@pytest.mark.parametrize("n_pts,m,resident", [
    (20_001, 300, 12), (20_001, 100, 16), (1, 7, 16), (1000, 300, 3),
    (10**7, 1000, 12), (10**8, 10**4, 4), (10**8, 10**4, 16), (10**10, 10**4, 16),
])
def test_fourier_sketch_grid_covers_each_row_once_and_fills_the_card(n_pts, m, resident):
    """Kernel 1's launch geometry: the groups' row ranges
    ``[g * rows, min(N, (g + 1) * rows))`` tile [0, N) with none empty, the
    column blocks cover m, the grid is at most one wave of the resident
    blocks, a small N still gets a block on every SM, and the double
    partials do not grow with N (under 16 MB at m = 10^4)."""
    rows, groups, col_blocks = fs.sketch_grid(n_pts, m, H100_SMS, resident)
    assert (groups - 1) * rows < n_pts <= groups * rows
    assert (col_blocks - 1) * fs.FREQS_PER_BLOCK < m <= col_blocks * fs.FREQS_PER_BLOCK
    assert groups * col_blocks <= max(resident * H100_SMS, col_blocks)
    if n_pts >= H100_SMS * fs.TILE_ROWS:
        assert groups * col_blocks >= H100_SMS
    # Two double partials per (group, frequency): bounded by the wave, not N.
    partial_bytes = 2 * 8 * groups * m
    assert partial_bytes <= 16 * max(resident * H100_SMS, col_blocks) * fs.FREQS_PER_BLOCK
    assert partial_bytes < 16 * 2**20


@pytest.mark.parametrize("n_pts,m,resident", [
    (10**7, 1000, 16), (10**7, 1000, 6), (1_000_003, 1000, 16), (20_001, 300, 8),
    (1, 7, 8), (517, 130, 3), (10**10, 10**4, 8),
])
def test_quantized_sketch_grid_covers_each_row_once_in_one_wave(n_pts, m, resident):
    """Kernel 3's launch geometry (kernel 1's ``sketch_grid`` with kernel
    3's occupancy): the row ranges tile [0, N) with none empty, the grid is
    at most one wave of the resident blocks and, where N allows a tile of
    rows a block, a full one but for a partial column of blocks; int32 sums
    need no cap on a block's rows (at N = 10^7 a block sums ~19,000 rows,
    past the float partials' old 16,384)."""
    rows, groups, col_blocks = fs.sketch_grid(n_pts, m, H100_SMS, resident)
    assert (groups - 1) * rows < n_pts <= groups * rows
    assert (col_blocks - 1) * fs.FREQS_PER_BLOCK < m <= col_blocks * fs.FREQS_PER_BLOCK
    wave = resident * H100_SMS
    assert groups * col_blocks <= max(wave, col_blocks)
    if n_pts >= wave * fs.TILE_ROWS:
        assert groups * col_blocks > wave - col_blocks
    if (n_pts, resident) == (10**7, 16):
        assert rows > 16_384


def _fma32(a, b, c):
    """float32 fma, emulated: the product of two floats is exact in float64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def test_fourier_sketch_phase_reduction_keeps_the_sfu_in_range():
    """The kernels' ``sincos_reduced`` (its constants read from
    ``sincos_reduced.cuh``), emulated in float32: for |p| <= 1e5 the reduced
    argument stays within pi + 0.004 of 0 (where ``__sincosf`` is within
    2^-21.41) and its sine and cosine are within 1.2e-7 of those of p itself;
    up to 1e6, pi + 0.04."""
    src = (Path(fs.__file__).parent / "csrc" / "sincos_reduced.cuh").read_text()
    const = {name: np.float32(float(val)) for name, val in re.findall(
        r"constexpr float (k\w+) = ([-+0-9.e]+)f;", src)}
    inv, magic = const["kInv2Pi"], const["kRoundMagic"]
    hi, lo = const["kTwoPiHi"], const["kTwoPiLo"]
    rng = np.random.default_rng(0)
    for lim, r_max in ((10.0, np.pi), (1e5, np.pi + 0.004), (1e6, np.pi + 0.04)):
        p = rng.uniform(-lim, lim, 200_000).astype(np.float32)
        k = _fma32(p, inv, magic) - magic
        r = _fma32(-k, lo, _fma32(-k, hi, p))
        assert np.abs(r).max() <= r_max * (1 + 1e-6), lim
        p64, r64 = p.astype(np.float64), r.astype(np.float64)
        assert np.abs(np.sin(r64) - np.sin(p64)).max() <= 1.2e-7, lim
        assert np.abs(np.cos(r64) - np.cos(p64)).max() <= 1.2e-7, lim


def test_build_target_follows_included_headers(tmp_path, monkeypatch):
    """A source's library path hashes the ``csrc`` headers it includes,
    directly or through another header, so editing a header rebuilds every
    source that includes it and no other; the kernels that share the SFU
    helper list its header.  No nvcc needed."""
    for name in ("fourier_sketch", "structured_sketch"):
        src = (_build.CSRC / f"{name}.cu").read_bytes()
        assert _build._headers(src) == ["sincos_reduced.cuh"], name
    assert _build._headers((_build.CSRC / "assign_argmin.cu").read_bytes()) == []
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include <cuda_runtime.h>\n#include "h1.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "h1.cuh").write_text('#pragma once\n  #include "h2.cuh"\nint h1;\n')
    (tmp_path / "h2.cuh").write_text("int h2;\n")
    (tmp_path / "h3.cuh").write_text("int h3;\n")
    assert _build._headers((tmp_path / "a.cu").read_bytes()) == ["h1.cuh", "h2.cuh"]
    before = {name: _build._target(name) for name in ("a", "b")}
    assert before["a"].parent == _build.BUILD_DIR and before["a"].name.startswith("a-")
    (tmp_path / "h3.cuh").write_text("int h3 = 1;\n")  # included by nothing
    assert {name: _build._target(name) for name in ("a", "b")} == before
    (tmp_path / "h2.cuh").write_text("int h2 = 1;\n")  # included through h1
    after = {name: _build._target(name) for name in ("a", "b")}
    assert after["a"] != before["a"] and after["b"] == before["b"]
    (tmp_path / "h2.cuh").write_text("int h2;\n")
    assert _build._target("a") == before["a"]


def _assign_inputs(seed, n_pts, feat, k):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_pts, feat)) * 3).astype(np.float32)
    c = (rng.standard_normal((k, feat)) * 3).astype(np.float32)
    return x, c


@pytest.mark.parametrize(
    "n_pts,feat,k",
    [(100, 10, 10), (1, 4, 3), (777, 5, 13), (2048, 16, 64),
     # The kernel's tile path: wide rows, several centroid tiles, ragged
     # feature chunks and point tiles.
     (1024, 256, 64), (300, 100, 65), (130, 1024, 7), (64, 784, 300)],
)
def test_assign_argmin_plain_matches_reference_kernel(n_pts, feat, k):
    """Labels equal and distances within rtol 1e-5 of the reference kernel."""
    x, c = _assign_inputs(10, n_pts, feat, k)
    jl, jd = jops.assign_argmin(jnp.asarray(x), jnp.asarray(c), block_n=128, interpret=True)
    tl, td = aa.assign_argmin_plain(torch.from_numpy(x), torch.from_numpy(c))
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


def test_assign_argmin_plain_ties_go_to_lowest_index():
    """Duplicated centroids tie exactly; the lowest index wins, as in
    ``jnp.argmin`` and the reference kernel."""
    x, c = _assign_inputs(11, 300, 4, 5)
    c = np.concatenate([c, c[[1, 0]]])  # centroid 5 == 1, centroid 6 == 0
    jl, _ = jops.assign_argmin(jnp.asarray(x), jnp.asarray(c), block_n=128, interpret=True)
    tl, _ = aa.assign_argmin_plain(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert not np.isin(tl.numpy(), [5, 6]).any()


def test_assign_argmin_plain_ties_go_to_lowest_index_at_wide_rows():
    """The tie rule at n = 256 (the kernel's tile path), with duplicates
    across the kernel's lanes, warps and centroid tiles (centroid 0 repeated
    at 3, 8, 16 and 64; 9 at 20 and 73)."""
    x, c = _assign_inputs(12, 2000, 256, 80)
    for kept, dups in ((0, [3, 8, 16, 64]), (9, [20, 73])):
        c[dups] = c[kept]
    jl, _ = jops.assign_argmin(jnp.asarray(x), jnp.asarray(c), block_n=128, interpret=True)
    tl, _ = aa.assign_argmin_plain(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert not np.isin(tl.numpy(), [3, 8, 16, 64, 20, 73]).any()
    assert np.isin([0, 9], tl.numpy()).all()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_assign_plan_covers_every_shape_the_smoke_runs():
    """Every (N, n, K) that chip_smoke.py hands kernel 2 gets a plan within
    the 227 KB a block may have (48 KB on the point path, which does not opt
    in), whose grid covers N with no empty CTA; n > 64 takes the tile path,
    and the tile path keeps its rows resident only across centroid tiles."""
    cs = _chip_smoke()
    shapes = {(cs.N, cs.DIM, cs.K), (cs.RAGGED_N, cs.DIM, cs.K), (8129, 256, 64), (8129, 256, 16),
              (63, cs.ASSIGN_WIDE_N, 7)}
    shapes |= {(20_001, n, 7) for n in (3, 70, *cs.SWEEP_DENSE_NS)}
    shapes |= {(n_pts, n, k) for n in cs.ASSIGN_SWEEP_NS for k in cs.ASSIGN_SWEEP_KS
               for n_pts in cs.ASSIGN_SWEEP_NPTS}
    shapes |= {(max(cs.ASSIGN_SWEEP_NPTS), 256, max(d) + 7) for _, d in cs.ASSIGN_TIES}
    assert {(n_pts, n, k) for n, k, n_pts in cs.ASSIGN_TIMED} <= shapes
    paths = set()
    for n_pts, n, k in sorted(shapes):
        plan = aa.assign_plan(n_pts, n, k)
        block = aa.POINT_THREADS if plan.path == "point" else aa.TILE_POINTS
        assert plan.grid * block >= n_pts > (plan.grid - 1) * block, (n_pts, n, k, plan)
        assert 0 < plan.smem <= (aa.SMEM_MAX if plan.path == "tile" else 48 * 1024), plan
        assert plan.path == "tile" or n <= aa.POINT_MAX_N
        assert not plan.resident or k > aa.TILE_CENTROIDS
        paths.add((plan.path, plan.resident))
    assert paths == {("point", False), ("tile", False), ("tile", True)}


def test_assign_plan_mirrors_the_cuda_layout():
    """The plan's constants are the CUDA source's (it refuses any other
    plan on the card), and a forced point path past 64 features raises."""
    code = (_build.CSRC / "assign_argmin.cu").read_text()
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", code)}
    assert (consts["kBM"], consts["kBN"], consts["kBK"], consts["kStages"]) == (
        aa.TILE_POINTS, aa.TILE_CENTROIDS, aa.TILE_FEATURES, aa.TILE_STAGES)
    assert consts["kThreads"] == aa.POINT_THREADS
    assert aa.assign_plan(10, 65, 3).path == "tile"
    with pytest.raises(ValueError):
        aa.assign_plan(10, 65, 3, path="point")


def test_ops_dispatch_cpu_tensors_to_the_plain_versions(monkeypatch):
    """A CPU tensor reaches the plain version and never the kernel wrapper."""

    def no_kernel(*args):
        raise AssertionError("kernel wrapper called for a CPU tensor")

    monkeypatch.setattr(fs, "fourier_sketch_sums", no_kernel)
    monkeypatch.setattr(aa, "assign_argmin", no_kernel)
    x, w, beta = (torch.from_numpy(a) for a in _sketch_inputs(2, 50, 3, 20))
    before = (fs.LAUNCHES, aa.LAUNCHES)
    for a, b in zip(kops.fourier_sketch_sums(x, w, beta), fs.fourier_sketch_sums_plain(x, w, beta)):
        assert torch.equal(a, b)
    labels, _ = kops.assign_argmin(x, x[:4].contiguous())
    assert labels.shape == (50,)
    assert (fs.LAUNCHES, aa.LAUNCHES) == before  # plain calls do not count


def _structured(n=3, m=40):
    return tfo.make_operator("structured", torch.Generator().manual_seed(0), m, n, 1.0,
                             device="cpu")


@pytest.mark.parametrize(
    "kernel",
    ["fourier_sketch", "assign_argmin", "quantized_fourier_sketch", "structured_sketch",
     "quantized_structured_sketch", "sketch_shift", "amp_denoise", "structured_sketch_fleet",
     "quantized_structured_sketch_fleet"],
)
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """The kernel wrappers launch on CUDA tensors or raise: no fallback."""
    x, w, beta = (torch.from_numpy(a) for a in _sketch_inputs(3, 20, 3, 8))
    op = _structured()
    dth = torch.zeros((op.nblocks, op.d))
    calls = {
        "fourier_sketch": lambda: fs.fourier_sketch_sums(x, w, beta),
        "assign_argmin": lambda: aa.assign_argmin(x, x[:2].contiguous()),
        "quantized_fourier_sketch": lambda: fs.quantized_fourier_sketch_sums(
            x, w, torch.zeros(8), 1),
        "structured_sketch": lambda: ft.structured_sketch_sums(x, op.diags, op.radii, beta),
        "quantized_structured_sketch": lambda: ft.quantized_structured_sketch_sums(
            x, op.diags, op.radii, dth, 4),
        "sketch_shift": lambda: kss.sketch_shift_sums(x, w, w[0], w[1]),
        "amp_denoise": lambda: kamp.amp_denoise(x, torch.tensor(1.0), x[0], x[1]),
        "structured_sketch_fleet": lambda: ft.structured_sketch_sums_fleet(
            x[None], op.diags[None], op.radii[None], beta[None]),
        "quantized_structured_sketch_fleet": lambda: ft.quantized_structured_sketch_sums_fleet(
            x[None], op.diags[None], op.radii[None], dth[None], 1),
    }
    with pytest.raises(ValueError, match="CUDA tensor"):
        calls[kernel]()


def test_ops_dispatch_new_kernels_by_device_and_operator_family(monkeypatch):
    """CPU tensors reach the plain versions of kernels 3-5 (dense quantized,
    structured float and quantized) and never the kernel wrappers; each
    result equals its plain version; no launch is counted."""

    def no_kernel(*args):
        raise AssertionError("kernel wrapper called for a CPU tensor")

    for mod, name in ((fs, "quantized_fourier_sketch_sums"), (ft, "structured_sketch_sums"),
                      (ft, "quantized_structured_sketch_sums")):
        monkeypatch.setattr(mod, name, no_kernel)
    x, w, beta = (torch.from_numpy(a) for a in _sketch_inputs(5, 50, 3, 40))
    op = _structured()
    dither = torch.rand(40, generator=torch.Generator().manual_seed(1))
    before = (fs.QUANTIZED_LAUNCHES, ft.STRUCTURED_LAUNCHES, ft.QUANTIZED_STRUCTURED_LAUNCHES)
    got = kops.quantized_fourier_sketch_sums(x, w, dither, 1)
    want = fs.quantized_fourier_sketch_sums_plain(x, w, dither, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    c, s = kops.fourier_sketch_sums(x, op, beta)
    pc, ps = ft.structured_sketch_sums_plain(x, op.diags, op.radii, beta)
    assert torch.equal(c, pc.reshape(-1)[:40]) and torch.equal(s, ps.reshape(-1)[:40])
    qc, qs = kops.quantized_fourier_sketch_sums(x, op, dither, 4)
    padded = torch.nn.functional.pad(dither, (0, op.nblocks * op.d - 40)).reshape(op.nblocks, op.d)
    pqc, pqs = ft.quantized_structured_sketch_sums_plain(x, op.diags, op.radii, padded, 4)
    assert torch.equal(qc, pqc.reshape(-1)[:40]) and torch.equal(qs, pqs.reshape(-1)[:40])
    assert (fs.QUANTIZED_LAUNCHES, ft.STRUCTURED_LAUNCHES,
            ft.QUANTIZED_STRUCTURED_LAUNCHES) == before


def test_operator_family_without_a_kernel_is_refused():
    """No unfused fallback: ops and the engine raise for a family that has
    no sketch kernel."""

    class Identity(tfo.FrequencyOperator):
        n = m = 3

        def apply(self, x):
            return x

        def to(self, device):
            return self

    x = torch.zeros((4, 3))
    with pytest.raises(TypeError, match="no sketch kernel"):
        kops.fourier_sketch_sums(x, Identity(), torch.ones(4))
    with pytest.raises(TypeError, match="no sketch kernel"):
        kops.quantized_fourier_sketch_sums(x, Identity(), torch.zeros(3), 1)
    with pytest.raises(TypeError, match="no sketch kernel"):
        SketchEngine(Identity(), device="cpu")


def test_structured_wrappers_check_shapes():
    op = _structured()
    x, _, beta = (torch.from_numpy(a) for a in _sketch_inputs(6, 20, 3, 8))
    with pytest.raises(ValueError, match="radii must be"):
        ft.structured_sketch_sums_plain(x, op.diags, op.radii[:, :4], beta)
    with pytest.raises(ValueError, match="power of two"):
        ft.structured_sketch_sums_plain(torch.zeros((2, 40)), op.diags, op.radii, beta[:2])
    with pytest.raises(ValueError, match="dither must be"):
        ft.quantized_structured_sketch_sums_plain(x, op.diags, op.radii, torch.zeros(40), 1)
    with pytest.raises(ValueError, match="shape mismatch"):
        fs.quantized_fourier_sketch_sums_plain(x, torch.zeros((3, 8)), torch.zeros(7), 1)
    with pytest.raises(TypeError, match="float32"):
        ft.structured_sketch_sums_plain(x.double(), op.diags, op.radii, beta)


def test_wrappers_check_shapes_and_dtypes():
    x, w, beta = (torch.from_numpy(a) for a in _sketch_inputs(4, 20, 3, 8))
    with pytest.raises(ValueError, match="shape mismatch"):
        fs.fourier_sketch_sums_plain(x, w[:2], beta)
    with pytest.raises(TypeError, match="float32"):
        fs.fourier_sketch_sums_plain(x.double(), w, beta)
    with pytest.raises(ValueError, match="expected x"):
        aa.assign_argmin_plain(x, x[:4, :2].contiguous())
    with pytest.raises(ValueError, match="at least one centroid"):
        aa.assign_argmin_plain(x, x[:0])
