"""The boundary rule for comparing QCKM integer codes across frameworks.

Codes are exact except where a code's argument sits on a rounding boundary:
the two frameworks' phases and cos/sin round apart in the last bits there.
So a per-point mismatch must have the reference's argument within
``BOUNDARY`` of a boundary (``|cos θ|`` at 1 bit, ``|S·cos θ − (k + ½)|`` at
b bits), and a code sum may differ by at most twice the number of such
points.

Also the kernels' trig-free 1-bit rule (``one_bit_signs`` of
``csrc/sincos_reduced.cuh``), emulated in float32 with the header's own
constants.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from repro.core import quantize as jqz

BOUNDARY = 1e-5
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"


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


def source_constants(name: str) -> dict[str, np.float32]:
    """The ``constexpr float k...`` constants of ``csrc/<name>``."""
    src = (CSRC / name).read_text()
    return {k: np.float32(float(v))
            for k, v in re.findall(r"constexpr float (k\w+) = ([-+0-9.e]+)f;", src)}


def fma32(a, b, c):
    """float32 fma, emulated: the product of two floats is exact in float64."""
    return (np.asarray(a, np.float32).astype(np.float64) * b + c).astype(np.float32)


def reduce_2pi(p):
    """``reduce_2pi`` of ``sincos_reduced.cuh`` emulated in float32."""
    k_ = source_constants("sincos_reduced.cuh")
    k = fma32(p, k_["kInv2Pi"], k_["kRoundMagic"]) - k_["kRoundMagic"]
    return fma32(-k, k_["kTwoPiLo"], fma32(-k, k_["kTwoPiHi"], p))


def one_bit_codes(theta):
    """The 1-bit kernels' codes of float32 phases (``one_bit_signs`` of
    ``sincos_reduced.cuh``, its constants read from there): read off the
    reduced phase r, cos >= 0 <=> |r| <= pi/2 and sin >= 0 <=>
    (r >= 0) != (|r| > pi)."""
    k_ = source_constants("sincos_reduced.cuh")
    with np.errstate(invalid="ignore"):
        r = reduce_2pi(np.asarray(theta, np.float32))
        qc = np.where(np.abs(r) <= k_["kHalfPi"], 1, -1)
        qs = np.where((r >= 0) != (np.abs(r) > k_["kPi"]), 1, -1)
    return qc.astype(np.int32), qs.astype(np.int32)
