"""Truncated-normal posterior moments under a box prior (the CL-AMP input
channel): the CUDA kernel and its plain twin.

Counterpart of ``repro.kernels.amp_denoise.amp_denoise_kernel``.  For
pseudo-data ``r (K, n)``, a 0-d pseudo-variance ``q`` (clamped positive by
the caller) and bounds ``lo, hi (n,)``, both functions here return the
posterior ``(mean (K, n), var (K, n))`` of ``N(r, q)`` truncated to the box,
with the reference's guards (tail-stable erfc branch, zero boundary terms at
infinite edges, collapse to the nearest edge where the in-box mass is below
1e-12):

- :func:`amp_denoise` launches ``csrc/amp_denoise.cu`` on CUDA tensors (or
  raises) and counts each launch in ``LAUNCHES``; ``q`` stays on the device,
  so a decoder loop never waits on it;
- :func:`amp_denoise_plain` is the plain PyTorch version, the reference's
  XLA formula with ``torch.special.erfc``.

``kernels.ops.amp_denoise`` picks between them by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda

# Kernel launches since the count was last reset (plain calls do not count).
LAUNCHES = 0

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT2PI = 0.3989422804014327


def _lib() -> ctypes.CDLL:
    lib = _build.load("amp_denoise")
    fn = lib.amp_denoise
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, ptr, ptr, ptr]
        fn.restype = i32
        lib.amp_denoise_error_string.argtypes = [i32]
        lib.amp_denoise_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(r, q, lo, hi) -> None:
    if r.ndim != 2 or q.ndim != 0 or lo.ndim != 1 or hi.ndim != 1:
        raise ValueError(
            f"expected r (K, n), a 0-d q, lo and hi (n,); got {tuple(r.shape)}, "
            f"{tuple(q.shape)}, {tuple(lo.shape)}, {tuple(hi.shape)}"
        )
    if lo.shape[0] != r.shape[1] or hi.shape != lo.shape:
        raise ValueError(
            f"shape mismatch: r {tuple(r.shape)}, lo {tuple(lo.shape)}, hi {tuple(hi.shape)}"
        )
    for name, t in (("r", r), ("q", q), ("lo", lo), ("hi", hi)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def amp_denoise(
    r: torch.Tensor, q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: ``(mean (K, n), var (K, n))`` for CUDA tensors.

    ``q`` is a 0-d float32 tensor on the device, read by the kernel.  Raises
    for anything the kernel does not take (a CPU tensor, another dtype, a
    non-contiguous tensor, mismatched devices).
    """
    global LAUNCHES
    _check_inputs(r, q, lo, hi)
    dev = check_cuda((("r", r), ("q", q), ("lo", lo), ("hi", hi)))
    k_est, n = r.shape
    lib = _lib()
    with torch.cuda.device(dev):
        mean = torch.empty((k_est, n), dtype=torch.float32, device=dev)
        var = torch.empty_like(mean)
        status = lib.amp_denoise(
            r.data_ptr(), q.data_ptr(), lo.data_ptr(), hi.data_ptr(), k_est, n,
            mean.data_ptr(), var.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if status != 0:
        msg = lib.amp_denoise_error_string(status).decode()
        raise RuntimeError(f"amp_denoise kernel launch failed: {msg} ({status})")
    LAUNCHES += 1
    return mean, var


def _clip(x, lo, hi):
    """``jnp.clip``: max then min, a NaN in ``x`` passes through."""
    return torch.minimum(torch.maximum(x, lo), hi)


def amp_denoise_plain(
    r: torch.Tensor, q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the reference's XLA formula
    (``repro.kernels.ops.amp_denoise(impl="xla")``)."""
    _check_inputs(r, q, lo, hi)
    erfc = torch.special.erfc
    lo, hi = lo[None, :], hi[None, :]
    sig = torch.sqrt(q)
    a = (lo - r) / sig
    b = (hi - r) / sig
    pa = _INV_SQRT2PI * torch.exp(-0.5 * a * a)
    pb = _INV_SQRT2PI * torch.exp(-0.5 * b * b)
    z_mass = 0.5 * torch.where(
        a + b > 0,
        erfc(a * _INV_SQRT2) - erfc(b * _INV_SQRT2),
        erfc(-b * _INV_SQRT2) - erfc(-a * _INV_SQRT2),
    )
    z_mass = torch.clamp(z_mass, min=1e-30)
    inside = z_mass > 1e-12
    apa = torch.where(torch.isfinite(a), a * pa, 0.0)
    bpb = torch.where(torch.isfinite(b), b * pb, 0.0)
    frac = (pa - pb) / z_mass
    mean = r + sig * frac
    var = q * (1.0 + (apa - bpb) / z_mass - frac * frac)
    mean = torch.where(inside, mean, _clip(r, lo, hi))
    var = torch.where(inside, var, q * 1e-6)
    return _clip(mean, lo, hi), _clip(var, q * 1e-12, q)
