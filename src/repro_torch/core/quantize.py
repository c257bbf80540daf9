"""Universal (dithered) quantization of the sketch — QCKM, counterpart of
``repro.core.quantize``.

Per point ``x``, frequency ``w_j`` and dither ``xi_j ~ U[0, 2pi)``::

    theta_j = w_j^T x + xi_j
    1-bit:   q_c = sign(cos theta_j),            q_s = sign(sin theta_j)
    b-bit:   q_c = round(S * cos theta_j),       q_s = round(S * sin theta_j)
             with S = 2**(b-1) - 1 levels per sign

The codes are summed in int32, so a partial state is exactly split-invariant
and merges exactly.  Decoding multiplies by the E[sign] correction (``pi/4``
at 1 bit, ``1/S`` at b bits) and rotates the (cos, sin) pair back by the
dither; CLOMPR then runs on the dequantized sketch unchanged.

Conventions kept from the reference: the 1-bit code maps ``c >= 0`` to +1
(so ``-0.0`` gives +1 and NaN gives -1), ``round`` is round half to even
(``torch.round``, as ``jnp.round``), and a NaN b-bit code is 0.  The
pure-Python helpers (:func:`parse_bits`, :func:`quantization_scale`,
:func:`accumulator_capacity`, :func:`state_wire_bytes`) are copies of the
reference's, so the port needs nothing of it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "SketchQuantizer",
    "parse_bits",
    "draw_dither",
    "make_quantizer",
    "quantization_scale",
    "accumulator_capacity",
    "quantize_codes",
    "dequantize_sums",
    "state_wire_bytes",
]


def parse_bits(spec: str) -> int | None:
    """Parse a ``CKMConfig.sketch_quantization`` string.

    ``"none"`` -> ``None``; ``"1bit"`` -> 1; ``"4bit"`` -> 4; … up to 16
    bits.  Raises ``ValueError`` on anything else.
    """
    s = spec.strip().lower()
    if s in ("none", "", "float", "off"):
        return None
    if s.endswith("bit"):
        try:
            bits = int(s[:-3].rstrip("-_ "))
        except ValueError:
            bits = -1
        if 1 <= bits <= 16:
            return bits
    raise ValueError(
        f"sketch_quantization must be 'none', '1bit', or '<b>bit' (b<=16); "
        f"got {spec!r}"
    )


def quantization_scale(bits: int) -> int:
    """Integer levels per sign: 1 for the 1-bit sign code, ``2**(b-1)-1`` else."""
    return 1 if bits == 1 else (1 << (bits - 1)) - 1


def accumulator_capacity(bits: int) -> int:
    """Max number of points an int32 accumulator holds without overflow:
    ``(2**31 - 1) // scale`` (every point contributing a full-scale code)."""
    return (2**31 - 1) // quantization_scale(bits)


def draw_dither(gen: torch.Generator, m: int) -> torch.Tensor:
    """Per-frequency dither ``xi ~ U[0, 2pi)^m`` on the generator's device,
    shared by encoder and decoder."""
    u = torch.rand((m,), generator=gen, dtype=torch.float32, device=gen.device)
    return u * (2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class SketchQuantizer:
    """Universal quantizer for one frequency operator: ``bits`` plus the
    fixed ``(m,)`` float32 dither that every update and the decoder share."""

    bits: int
    dither: torch.Tensor  # (m,) f32, xi ~ U[0, 2pi)

    @property
    def scale(self) -> int:
        return quantization_scale(self.bits)


def make_quantizer(gen: torch.Generator, m: int, spec: str) -> SketchQuantizer | None:
    """``spec`` string -> quantizer (or ``None`` for the float path)."""
    bits = parse_bits(spec)
    if bits is None:
        return None
    return SketchQuantizer(bits=bits, dither=draw_dither(gen, m))


def quantize_codes(
    proj: torch.Tensor,
    dither: torch.Tensor,
    bits: int,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer codes of one projection block.

    ``proj``: (..., m) raw phases ``x @ W``; ``dither``: (m,).  Returns int32
    ``(q_cos, q_sin)`` of the same shape.  ``valid`` (broadcastable mask,
    truncated to int32 as the reference does) zeroes masked rows.
    """
    theta = proj + dither
    c, s = torch.cos(theta), torch.sin(theta)
    if bits == 1:
        one = torch.ones((), dtype=torch.int32, device=proj.device)
        qc = torch.where(c >= 0, one, -one)
        qs = torch.where(s >= 0, one, -one)
    else:
        scale = float(quantization_scale(bits))
        # A NaN phase codes to 0, as XLA's float-to-int conversion (and the
        # CUDA kernels' __float2int_rn) give; torch's cast would give INT_MIN.
        qc = torch.nan_to_num(torch.round(c * scale), nan=0.0).to(torch.int32)
        qs = torch.nan_to_num(torch.round(s * scale), nan=0.0).to(torch.int32)
    if valid is not None:
        v = valid.to(torch.int32)
        qc = qc * v
        qs = qs * v
    return qc, qs


def dequantize_sums(
    qcos: torch.Tensor, qsin: torch.Tensor, dither: torch.Tensor, bits: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """E[sign] correction: integer sums -> float ``(cos_acc, sin_acc)`` sums,
    unnormalised like the float state's, then the rotation by ``-xi``."""
    corr = math.pi / 4.0 if bits == 1 else 1.0 / quantization_scale(bits)
    sc = corr * qcos.to(torch.float32)  # ~ sum cos(theta + xi)
    ss = corr * qsin.to(torch.float32)  # ~ sum sin(theta + xi)
    cd, sd = torch.cos(dither), torch.sin(dither)
    cos_sum = cd * sc + sd * ss  # cos(t) = cos(t+xi)cos(xi) + sin(t+xi)sin(xi)
    sin_sum = cd * ss - sd * sc
    return cos_sum, sin_sum


def state_wire_bytes(m: int, count: int, bits: int | None) -> int:
    """Bytes on the wire of one partial state's two ``(m,)`` accumulators:
    ``2m`` float32 for float states; for a quantized partial over ``count``
    points, the narrowest of {1, 2, 4, 8}-byte integers that holds
    ``[-count*S, count*S]``."""
    if bits is None:
        return 2 * m * 4
    span = 2 * max(int(count), 1) * quantization_scale(bits) + 1
    needed_bits = max(8, math.ceil(math.log2(span)))
    width = next((w for w in (1, 2, 4) if 8 * w >= needed_bits), 8)
    return 2 * m * width
