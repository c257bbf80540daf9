"""Device and operator-family dispatch for the kernels (counterpart of
``repro.kernels.ops``).

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the kernel's plain PyTorch version.  Nothing else chooses
between them, and no ``try`` falls back from one to the other.  Unlike the
reference there is no padding of the data here: the kernels mask their
ragged edges.

The sketch-side entry points take a frequency operator (a raw ``(n, m)``
tensor is wrapped as a dense one) and dispatch on its family: ``"dense"``
runs the matmul-and-trig kernels (``kernels.fourier_sketch``),
``"structured"`` the WHT-chain kernels (``kernels.freq_transform``).  An
operator family with no kernel raises ``TypeError``: there is no unfused
fallback.  The decoders' entry points (``sketch_shift_scores``,
``amp_denoise``) take plain tensors: a dense ``(n, m)`` frequency matrix and
the sketch, or the pseudo-data, its variance and the box.
``flash_attention`` takes ``(B, S, H, hd)`` q, k and v, as the reference's
entry point does.

The fleet entry points (``fleet_fourier_sketch_sums``,
``quantized_fleet_fourier_sketch_sums``) take ``x (T, B, n)`` and a
``freq_ops.StackedOperator`` of T tenants and return ``(T, m)`` sums.  A
dense fleet goes to the tenant-axis entries of kernels 1 and 3, a
structured fleet to those of kernels 4 and 5: one launch for the whole
fleet either way.
"""

from __future__ import annotations

import torch

from repro_torch.core import freq_ops as fo
from repro_torch.kernels import amp_denoise as _amp
from repro_torch.kernels import assign_argmin as _assign
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fourier_sketch as _sketch
from repro_torch.kernels import freq_transform as _ft
from repro_torch.kernels import sketch_shift as _shift


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def _no_kernel(op) -> TypeError:
    return TypeError(
        f"no sketch kernel for the {type(op).__name__} operator family; the "
        "kernels take 'dense' and 'structured' operators"
    )


def _pad_dither(dither: torch.Tensor, nblocks: int, d: int) -> torch.Tensor:
    """The ``(..., m)`` dither zero-padded to the block tail, as ``(...,
    nblocks, d)`` (the tail's codes are sliced off)."""
    pad = nblocks * d - dither.shape[-1]
    return torch.nn.functional.pad(dither, (0, pad)).reshape(*dither.shape[:-1], nblocks, d)


def fourier_sketch_sums(x: torch.Tensor, w, beta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw fused sums ``(sum b cos(x Ω) (m,), sum b sin(x Ω) (m,))`` — the
    engine's float batch statistics: no ``1/N``, no stacked-real packaging."""
    op = fo.as_operator(w)
    cuda = _on_cuda(x)
    if isinstance(op, fo.StructuredOperator):
        fn = _ft.structured_sketch_sums if cuda else _ft.structured_sketch_sums_plain
        c, s = fn(x, op.diags, op.radii, beta)
        return c.reshape(-1)[: op.m], s.reshape(-1)[: op.m]
    if isinstance(op, fo.DenseOperator):
        fn = _sketch.fourier_sketch_sums if cuda else _sketch.fourier_sketch_sums_plain
        return fn(x, op.w, beta)
    raise _no_kernel(op)


def quantized_fourier_sketch_sums(
    x: torch.Tensor,
    w,
    dither: torch.Tensor,
    bits: int,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """QCKM encoder: int32 ``(q_cos_sums (m,), q_sin_sums (m,))`` of the codes
    of the dithered phases ``x Ω + xi`` (``core.quantize.quantize_codes``);
    rows with ``valid = 0`` contribute nothing."""
    op = fo.as_operator(w)
    cuda = _on_cuda(x)
    if isinstance(op, fo.StructuredOperator):
        fn = (_ft.quantized_structured_sketch_sums if cuda
              else _ft.quantized_structured_sketch_sums_plain)
        qc, qs = fn(x, op.diags, op.radii, _pad_dither(dither, op.nblocks, op.d), bits, valid)
        return qc.reshape(-1)[: op.m], qs.reshape(-1)[: op.m]
    if isinstance(op, fo.DenseOperator):
        fn = (_sketch.quantized_fourier_sketch_sums if cuda
              else _sketch.quantized_fourier_sketch_sums_plain)
        return fn(x, op.w, dither, bits, valid)
    raise _no_kernel(op)


def _fleet_columns(sums, m: int):
    """``(T, nblocks, d)`` structured fleet sums as contiguous ``(T, m)``."""
    return tuple(v.reshape(v.shape[0], -1)[:, :m].contiguous() for v in sums)


def fleet_fourier_sketch_sums(
    x: torch.Tensor, op: fo.StackedOperator, beta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each tenant's raw fused sums: ``x (T, B, n)`` against tenant t's
    operator with weights ``beta (T, B)`` -> ``(T, m)``, ``(T, m)``."""
    if op.name == "structured":
        diags, radii = op.leaves[:2]
        fn = (_ft.structured_sketch_sums_fleet if _on_cuda(x)
              else _ft.structured_sketch_sums_fleet_plain)
        return _fleet_columns(fn(x, diags, radii, beta), op.m)
    if op.name == "dense":
        fn = (_sketch.fourier_sketch_sums_fleet if _on_cuda(x)
              else _sketch.fourier_sketch_sums_fleet_plain)
        return fn(x, op.leaves[0], beta)
    raise _no_kernel(op)


def quantized_fleet_fourier_sketch_sums(
    x: torch.Tensor, op: fo.StackedOperator, dither: torch.Tensor, bits: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each tenant's int32 code sums: ``x (T, B, n)`` against tenant t's
    operator and ``dither (T, m)`` -> ``(T, m)``, ``(T, m)``."""
    if op.name == "structured":
        diags, radii = op.leaves[:2]
        fn = (_ft.quantized_structured_sketch_sums_fleet if _on_cuda(x)
              else _ft.quantized_structured_sketch_sums_fleet_plain)
        dth = _pad_dither(dither, diags.shape[1], diags.shape[3])
        return _fleet_columns(fn(x, diags, radii, dth, bits), op.m)
    if op.name == "dense":
        fn = (_sketch.quantized_fourier_sketch_sums_fleet if _on_cuda(x)
              else _sketch.quantized_fourier_sketch_sums_fleet_plain)
        return fn(x, op.leaves[0], dither, bits)
    raise _no_kernel(op)


def assign_argmin(
    x: torch.Tensor, c: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment: ``(labels (N,) int32, min d^2 (N,) f32)``."""
    if _on_cuda(x):
        return _assign.assign_argmin(x, c)
    return _assign.assign_argmin_plain(x, c)


def sketch_shift_scores(
    c: torch.Tensor, w: torch.Tensor, z: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sketched-density score and gradient at candidates ``c (P, n)``:

        f(c)  = (1/m) sum_j [cos(w_j c) z1_j - sin(w_j c) z2_j]       (P,)
        grad  = (1/m) sum_j w_j [-sin(w_j c) z1_j - cos(w_j c) z2_j]  (P, n)

    for the stacked-real sketch ``z = [z1, z2] (2m,)`` and a dense ``(n, m)``
    frequency matrix ``w`` (a structured operator is materialised by the
    caller, once per decode).  The inner step of the sketch_shift decoder.
    """
    m = w.shape[1]
    fn = _shift.sketch_shift_sums if _on_cuda(c) else _shift.sketch_shift_sums_plain
    f, g = fn(c, w, z[:m], z[m:])
    return f / m, g / m


def amp_denoise(
    r: torch.Tensor, q: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Truncated-normal posterior ``(mean (K, n), var (K, n))`` of the
    pseudo-data ``r`` with pseudo-variance ``q`` under the box prior
    ``[lower, upper]`` (the CL-AMP input channel).  ``q`` is clamped at 1e-20
    on its own device and never read by the host; the bounds broadcast to
    ``(n,)``."""
    n = r.shape[1]
    q = torch.clamp(torch.as_tensor(q, dtype=torch.float32, device=r.device).reshape(()),
                    min=1e-20)
    lo = torch.broadcast_to(lower.to(torch.float32), (n,)).contiguous()
    hi = torch.broadcast_to(upper.to(torch.float32), (n,)).contiguous()
    fn = _amp.amp_denoise if _on_cuda(r) else _amp.amp_denoise_plain
    return fn(r, q, lo, hi)


# The reference's default kv block (``repro.kernels.ops.flash_attention``):
# its wrapper pads S_kv to whole blocks, which only the causal mask hides.
_REF_BLOCK_K = 256


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Flash attention (forward) on ``q (B, S_q, H, hd)`` and ``k, v (B,
    S_kv, KV, hd)`` with ``H`` a multiple of ``KV`` (GQA): returns
    ``(B, S_q, H * hd)`` in q's dtype, without the LSE.

    The reference's contract: heads are flattened, q head ``h`` reads kv
    head ``h // (H / KV)``, and a non-causal call whose S_kv is not a whole
    number of the reference's kv blocks is refused, as the reference's pad
    assert refuses it.  The kernel masks the ragged edge itself: no padding
    copy is made.
    """
    b, s_q, h, hd = q.shape
    s_kv, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or v.shape != k.shape or k.shape[3] != hd or h % kvh:
        raise ValueError(
            f"expected q (B, S_q, H, hd), k and v (B, S_kv, KV, hd) with KV dividing H; "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    block_k = min(_REF_BLOCK_K, max(8, 1 << (s_kv - 1).bit_length()))
    if s_kv % block_k and not causal:
        raise ValueError(
            f"S_kv = {s_kv} is not a whole number of {block_k}-row kv blocks: the "
            "reference pads it, which requires the causal mask"
        )
    qf = q.transpose(1, 2).reshape(b * h, s_q, hd).contiguous()
    kf = k.transpose(1, 2).reshape(b * kvh, s_kv, hd).contiguous()
    vf = v.transpose(1, 2).reshape(b * kvh, s_kv, hd).contiguous()
    fn = _flash.flash_attention_kernel if _on_cuda(q) else _flash.flash_attention_plain
    o, _lse = fn(qf, kf, vf, h // kvh, causal, window)
    return o.reshape(b, h, s_q, hd).transpose(1, 2).reshape(b, s_q, h * hd)
