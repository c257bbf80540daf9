"""Fused random-Fourier-feature sketch sums: the CUDA kernel and its plain twin.

Counterpart of ``repro.kernels.fourier_sketch.fourier_sketch_kernel``.  Both
functions here compute, for ``x (N, n)``, ``w (n, m)`` and ``beta (N,)``:

    (sum_i beta_i cos(x_i W)  (m,),   sum_i beta_i sin(x_i W)  (m,))

- :func:`fourier_sketch_sums` launches ``csrc/fourier_sketch.cu`` on a CUDA
  tensor (or raises) and counts each launch in ``LAUNCHES``;
- :func:`fourier_sketch_sums_plain` is the plain PyTorch version, written as
  the reference oracle ``repro.kernels.ref.fourier_sketch_ref`` is, over
  chunks of rows so the ``(chunk, m)`` projection stays bounded.

``kernels.ops`` picks between them by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Kernel launches since the count was last reset (plain calls do not count).
LAUNCHES = 0

# Rows each block sums before its partial goes to the second pass: short
# enough that the float32 register accumulators stay accurate, long enough
# that the (row_blocks, m) partials stay small.
ROWS_PER_BLOCK = 4096
_PLAIN_CHUNK = 1 << 16


def _lib() -> ctypes.CDLL:
    lib = _build.load("fourier_sketch")
    fn = lib.fourier_sketch_sums
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [ptr, ptr, ptr, i64, i32, i32, i64, i32, ptr, ptr, ptr, ptr, ptr]
        fn.restype = i32
        lib.fourier_sketch_error_string.argtypes = [ctypes.c_int]
        lib.fourier_sketch_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor) -> None:
    if x.ndim != 2 or w.ndim != 2 or beta.ndim != 1:
        raise ValueError(
            f"expected x (N, n), w (n, m), beta (N,); got {tuple(x.shape)}, "
            f"{tuple(w.shape)}, {tuple(beta.shape)}"
        )
    if x.shape[1] != w.shape[0] or beta.shape[0] != x.shape[0]:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"beta {tuple(beta.shape)}"
        )
    for name, t in (("x", x), ("w", w), ("beta", beta)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def fourier_sketch_sums(
    x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: ``(cos_sums (m,), sin_sums (m,))`` for CUDA tensors.

    Raises for anything the kernel does not take (a CPU tensor, another
    dtype, a non-contiguous tensor, mismatched devices).  The sums are
    bitwise repeatable: no float atomics, a fixed reduction order.
    """
    global LAUNCHES
    _check_inputs(x, w, beta)
    for name, t in (("x", x), ("w", w), ("beta", beta)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_pts, n = x.shape
    m = w.shape[1]
    if m > 65535 * 256:
        raise ValueError(f"m = {m} exceeds the kernel's grid limit")
    row_blocks = max(1, -(-n_pts // ROWS_PER_BLOCK))
    lib = _lib()
    with torch.cuda.device(x.device):
        cos_part = torch.empty((row_blocks, m), dtype=torch.float32, device=x.device)
        sin_part = torch.empty_like(cos_part)
        cos_out = torch.empty((m,), dtype=torch.float32, device=x.device)
        sin_out = torch.empty_like(cos_out)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.fourier_sketch_sums(
            x.data_ptr(), w.data_ptr(), beta.data_ptr(), n_pts, n, m,
            ROWS_PER_BLOCK, row_blocks, cos_part.data_ptr(), sin_part.data_ptr(),
            cos_out.data_ptr(), sin_out.data_ptr(), stream,
        )
    if status != 0:
        msg = lib.fourier_sketch_error_string(status).decode()
        raise RuntimeError(f"fourier_sketch kernel launch failed: {msg} ({status})")
    LAUNCHES += 1
    return cos_out, sin_out


def fourier_sketch_sums_plain(
    x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``beta @ cos(x @ w)`` and ``beta @ sin(x @ w)``,
    summed over chunks of rows."""
    _check_inputs(x, w, beta)
    m = w.shape[1]
    cos_s = torch.zeros((m,), dtype=torch.float32, device=x.device)
    sin_s = torch.zeros((m,), dtype=torch.float32, device=x.device)
    for start in range(0, x.shape[0], _PLAIN_CHUNK):
        proj = x[start : start + _PLAIN_CHUNK] @ w  # (chunk, m)
        b = beta[start : start + _PLAIN_CHUNK]
        cos_s += b @ torch.cos(proj)
        sin_s += b @ torch.sin(proj)
    return cos_s, sin_s
