"""The boundary rule for comparing QCKM integer codes across frameworks.

Codes are exact except where a code's argument sits on a rounding boundary:
the two frameworks' phases and cos/sin round apart in the last bits there.
So a per-point mismatch must have the reference's argument within
``BOUNDARY`` of a boundary (``|cos θ|`` at 1 bit, ``|S·cos θ − (k + ½)|`` at
b bits), and a code sum may differ by at most twice the number of such
points.
"""

import jax.numpy as jnp
import numpy as np

from repro.core import quantize as jqz

BOUNDARY = 1e-5


def on_boundary(arg, bits: int) -> np.ndarray:
    """Where the reference's cos or sin value ``arg`` lies within
    ``BOUNDARY`` of a code boundary."""
    arg = np.asarray(arg, np.float64)
    if bits == 1:
        return np.abs(arg) < BOUNDARY
    scaled = arg * jqz.quantization_scale(bits)
    return np.abs(scaled - np.floor(scaled) - 0.5) < BOUNDARY


def assert_sums_within_flips(got, ref, theta, bits: int, valid=None) -> None:
    """Code sums ``got`` vs ``ref`` ((cos, sin) pairs of (m,) int32) for the
    reference's phases ``theta (N, m)``: each entry differs by at most twice
    the count of boundary points of its frequency (masked rows excluded)."""
    rows = np.ones((np.shape(theta)[0], 1), bool) if valid is None else (
        np.asarray(valid) != 0)[:, None]
    for g, r, trig in zip(got, ref, (jnp.cos, jnp.sin)):
        near = on_boundary(trig(jnp.asarray(theta)), bits) & rows
        diff = np.abs(np.asarray(g, np.int64) - np.asarray(r, np.int64))
        assert np.all(diff <= 2 * near.sum(axis=0)), (diff.max(), int(near.sum()))
