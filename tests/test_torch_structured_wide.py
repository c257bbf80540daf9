"""The structured sketch at the wide blocks of the activation monitor
(d = 4096, 8192 and 16384: d_model 4096 to 12288), against the reference.

The port's plain versions of kernels 4 and 5 (``structured_sketch_sums_plain``
and ``quantized_structured_sketch_sums_plain``) and the float32 model of the
CUDA kernels' butterfly (level order h = 1, 2, 4, ..., lower a + b, upper
a - b, which the wide kernel keeps) are held to the reference's plain
structured sketch (``repro.core.sketch.sketch`` and ``sketch_quantized``
through a reference ``StructuredOperator``) on signs, radii, dither and rows
drawn with numpy: 1e-4 on sums / N for the float sums (the reference's bar
across sketch backends), integer code sums within twice the count of points
whose reference argument lies within 1e-5 of a code boundary.  Also the
kernels' accepted widths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import freq_ops as jfo
from repro.core import sketch as jsk
from repro_torch.kernels import freq_transform as tft

from _torch_codes import assert_sums_within_flips
from test_torch_structured import _kernel_phases

pytestmark = pytest.mark.torch_port

N_PTS = 8
# (d, nblocks, n): n past d / 2, the monitor's padding; the last block ragged.
WIDE = [(4096, 2, 4100 - 2048), (8192, 2, 6144), (16384, 1, 12288)]


def _draw(d, nblocks, n, seed):
    """Reference and port structured operators on numpy signs and radii,
    rows, weights and dither; m leaves the last block 5 short."""
    rng = np.random.default_rng(seed)
    m = nblocks * d - 5
    diags = rng.choice(np.array([-1.0, 1.0], np.float32), (nblocks, 3, d))
    radii = rng.uniform(0.05, 1.5, (nblocks, d)).astype(np.float32)
    x = (rng.standard_normal((N_PTS, n)) * 0.8).astype(np.float32)
    beta = rng.uniform(0.5, 1.5, N_PTS).astype(np.float32)
    dither = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
    jop = jfo.StructuredOperator(jnp.asarray(diags), jnp.asarray(radii), jnp.asarray(radii),
                                 n, m)
    return jop, m, diags, radii, x, beta, dither


def _padded(dither, nblocks, d):
    return torch.nn.functional.pad(torch.from_numpy(dither), (0, nblocks * d - dither.shape[0])
                                   ).reshape(nblocks, d)


@pytest.mark.parametrize("d,nblocks,n", WIDE)
def test_wide_plain_sums_match_reference(d, nblocks, n):
    """Kernel 4's plain version at a wide block: the reference's plain
    sketch, 1e-4 on sums / N."""
    jop, m, diags, radii, x, beta, _ = _draw(d, nblocks, n, d)
    ref = np.asarray(jsk.sketch(jnp.asarray(x), jop, weights=jnp.asarray(beta), chunk=N_PTS))
    tc, ts = tft.structured_sketch_sums_plain(torch.from_numpy(x), torch.from_numpy(diags),
                                              torch.from_numpy(radii), torch.from_numpy(beta))
    assert tc.shape == (nblocks, d)
    np.testing.assert_allclose(tc.reshape(-1)[:m].numpy() / N_PTS, ref[:m] / N_PTS, atol=1e-4)
    np.testing.assert_allclose(-ts.reshape(-1)[:m].numpy() / N_PTS, ref[m:] / N_PTS, atol=1e-4)


@pytest.mark.parametrize("bits", [1, 4])
@pytest.mark.parametrize("d,nblocks,n", WIDE)
def test_wide_plain_codes_match_reference(d, nblocks, n, bits):
    """Kernel 5's plain version at a wide block, 1 and 4 bits, with the
    dither zero-padded to the block tail: the reference's plain quantized
    sketch under the boundary rule."""
    jop, m, diags, radii, x, _, dither = _draw(d, nblocks, n, d + bits)
    ref = jsk.sketch_quantized(jnp.asarray(x), jop, jnp.asarray(dither), bits=bits,
                               chunk=N_PTS)
    qc, qs = tft.quantized_structured_sketch_sums_plain(
        torch.from_numpy(x), torch.from_numpy(diags), torch.from_numpy(radii),
        _padded(dither, nblocks, d), bits)
    assert qc.dtype == torch.int32 and qc.shape == (nblocks, d)
    theta = np.asarray(jop.apply(jnp.asarray(x))) + dither
    assert_sums_within_flips((qc.reshape(-1)[:m], qs.reshape(-1)[:m]), ref, theta, bits)


@pytest.mark.parametrize("d,nblocks,n", WIDE)
def test_wide_butterfly_model_matches_reference(d, nblocks, n):
    """The kernels' butterfly arithmetic (the float32 model: levels in
    ascending h, the signs folded into +-c, explicit roundings), which the
    wide kernel runs in its two layouts, at a wide block: the reference's
    plain sketch, 1e-4 on sums / N."""
    jop, m, diags, radii, x, beta, _ = _draw(d, nblocks, n, d + 7)
    phases = _kernel_phases(torch.from_numpy(x), torch.from_numpy(diags),
                            torch.from_numpy(radii))
    flat = phases.reshape(N_PTS, -1)[:, :m].double().numpy()
    ref = np.asarray(jsk.sketch(jnp.asarray(x), jop, weights=jnp.asarray(beta), chunk=N_PTS))
    np.testing.assert_allclose(beta @ np.cos(flat) / N_PTS, ref[:m] / N_PTS, atol=1e-4)
    np.testing.assert_allclose(-(beta @ np.sin(flat)) / N_PTS, ref[m:] / N_PTS, atol=1e-4)


@pytest.mark.parametrize("d", [1 << p for p in range(5, 15)])
def test_kernel_widths_accept_32_to_16384(d):
    assert tft.MAX_KERNEL_D == 16384
    tft._check_kernel_widths(d, 1)
    tft._check_kernel_widths(d, d)


@pytest.mark.parametrize("d", [16, 32768])
def test_kernel_widths_refuse_outside(d):
    with pytest.raises(ValueError, match="32 <= d <= 16384"):
        tft._check_kernel_widths(d, 1)


H100_SMS = 132
# Row teams a CTA of the wide kernel holds (512 threads in teams of d / 32),
# one CTA an SM: the ``resident`` its occupancy query reports.
WIDE_TEAMS = {4096: 4, 8192: 2, 16384: 1}
# Rows a wide-kernel thread adds in float before its double flush.
WIDE_FLUSH_ROWS = 256


@pytest.mark.parametrize("d", sorted(WIDE_TEAMS))
@pytest.mark.parametrize("n_pts,nblocks", [(4, 24), (4, 16), (1, 1), (333, 2), (20_001, 2),
                                           (200_003, 2), (10**7, 24)])
def test_wide_grid_spreads_rows_over_teams(d, n_pts, nblocks):
    """The wide kernel's grid: each team a row group, the groups tile [0, N)
    with none empty, at most one wave of the teams, and a few rows (the
    monitor's B = 4) one row a group, so the rows of a block run in
    parallel."""
    teams = WIDE_TEAMS[d]
    rows, groups, col_blocks = tft.structured_grid(n_pts, nblocks, 1, H100_SMS, teams, d)
    assert (groups - 1) * rows < n_pts <= groups * rows
    assert col_blocks == nblocks
    assert groups <= max(1, teams * H100_SMS // nblocks)
    if n_pts <= teams * H100_SMS // nblocks:
        assert rows == 1 and groups == n_pts


@pytest.mark.parametrize("d", sorted(WIDE_TEAMS))
@pytest.mark.parametrize("tenants,n_pts", [(3, 333), (1024, 4), (2, 20_001)])
def test_wide_fleet_tenant_gets_the_single_grid(monkeypatch, d, tenants, n_pts):
    """A fleet tenant of B rows gets the grid of an isolated call of B rows
    (never one sized for T B), so its sums are bitwise that call's."""
    teams = WIDE_TEAMS[d]
    monkeypatch.setattr(tft, "_resident", lambda lib, dev, d_, n, mode: (teams, 1))
    monkeypatch.setattr(tft, "sm_count", lambda dev: H100_SMS)
    got = tft._fleet_grid(None, torch.device("cpu"), tenants, n_pts, d // 2, d, 2, 0)
    assert got == tft.structured_grid(n_pts, 2, 1, H100_SMS, teams, d)[:2]


def _wide_sums_model(phases, beta, rows_per_group):
    """float32 model of the wide kernel's float sums: per group of
    ``rows_per_group`` rows, float32 running sums of beta cos and beta sin,
    added into float64 every WIDE_FLUSH_ROWS rows and at the group's end;
    the groups' float64 partials summed in group order, then float32."""
    cos_p, sin_p = torch.cos(phases), torch.sin(phases)
    b = torch.from_numpy(beta)[:, None, None]
    total_c = torch.zeros(phases.shape[1:], dtype=torch.float64)
    total_s = torch.zeros_like(total_c)
    for g0 in range(0, phases.shape[0], rows_per_group):
        part_c = torch.zeros_like(total_c)
        part_s = torch.zeros_like(total_c)
        for f0 in range(g0, min(phases.shape[0], g0 + rows_per_group), WIDE_FLUSH_ROWS):
            acc_c = torch.zeros(phases.shape[1:], dtype=torch.float32)
            acc_s = torch.zeros_like(acc_c)
            for r in range(f0, min(phases.shape[0], g0 + rows_per_group, f0 + WIDE_FLUSH_ROWS)):
                acc_c = acc_c + b[r] * cos_p[r]
                acc_s = acc_s + b[r] * sin_p[r]
            part_c += acc_c.double()
            part_s += acc_s.double()
        total_c += part_c
        total_s += part_s
    return total_c.float(), total_s.float()


@pytest.mark.parametrize("d,nblocks,n", WIDE)
def test_wide_summation_model_matches_reference(d, nblocks, n):
    """The wide kernel's summation order (the float32 model above, on the
    float32 butterfly model's phases, at the grid of one SM so that a group
    flushes mid-range) against the reference's plain sketch: 1e-4 on sums /
    N."""
    n_pts = 600
    rng = np.random.default_rng(d + 11)
    jop, m, diags, radii, _, _, _ = _draw(d, nblocks, n, d + 9)
    x = (rng.standard_normal((n_pts, n)) * 0.8).astype(np.float32)
    beta = rng.uniform(0.5, 1.5, n_pts).astype(np.float32)
    rows, groups, _ = tft.structured_grid(n_pts, nblocks, 1, 1, WIDE_TEAMS[d], d)
    assert rows > WIDE_FLUSH_ROWS or groups > 1
    phases = _kernel_phases(torch.from_numpy(x), torch.from_numpy(diags),
                            torch.from_numpy(radii))
    tc, ts = _wide_sums_model(phases, beta, rows)
    ref = np.asarray(jsk.sketch(jnp.asarray(x), jop, weights=jnp.asarray(beta), chunk=200))
    np.testing.assert_allclose(tc.reshape(-1)[:m].numpy() / n_pts, ref[:m] / n_pts, atol=1e-4)
    np.testing.assert_allclose(-ts.reshape(-1)[:m].numpy() / n_pts, ref[m:] / n_pts, atol=1e-4)


@pytest.mark.parametrize("table", ["SKETCH_VARIANTS", "QSKETCH_VARIANTS", "SHIFT_VARIANTS",
                                   "STRUCTURED_VARIANTS", "FLASH_VARIANTS"])
def test_kernel_variants_edits_match_the_sources(table):
    """Every string edit of ``tools/kernel_variants.py`` finds its text in
    the kernel source it edits (the tool raises on the card otherwise)."""
    from repro_torch.kernels import _build
    from repro_torch.tools import kernel_variants

    for label, edits in getattr(kernel_variants, table).items():
        for fname, pairs in edits.items():
            text = (_build.CSRC / fname).read_text()
            for old in pairs:
                assert old in text, (label, fname, old)
