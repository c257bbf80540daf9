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
