"""Fused nearest-centroid assignment: the CUDA kernel and its plain twin.

Counterpart of ``repro.kernels.assign_argmin.assign_argmin_kernel``.  Both
functions here return, for ``x (N, n)`` and ``c (K, n)``:

    (labels (N,) int32 — argmin_k ||x_i - c_k||^2, ties to the lowest k,
     min_dist (N,) float32 — min_k ||x_i - c_k||^2)

- :func:`assign_argmin` launches ``csrc/assign_argmin.cu`` on a CUDA tensor
  (or raises) and counts each launch in ``LAUNCHES``;
- :func:`assign_argmin_plain` is the plain PyTorch version, written as the
  reference oracle ``repro.kernels.ref.assign_argmin_ref`` is.

``kernels.ops`` picks between them by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Kernel launches since the count was last reset (plain calls do not count).
LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("assign_argmin")
    fn = lib.assign_argmin
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [ptr, ptr, i64, i32, i32, ptr, ptr, ptr]
        fn.restype = i32
        lib.assign_argmin_error_string.argtypes = [i32]
        lib.assign_argmin_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(x: torch.Tensor, c: torch.Tensor) -> None:
    if x.ndim != 2 or c.ndim != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(
            f"expected x (N, n) and c (K, n); got {tuple(x.shape)}, {tuple(c.shape)}"
        )
    if c.shape[0] < 1:
        raise ValueError("need at least one centroid")
    for name, t in (("x", x), ("c", c)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def assign_argmin(x: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: ``(labels (N,) int32, min_dist (N,) float32)``.

    Raises for anything the kernel does not take (a CPU tensor, another
    dtype, a non-contiguous tensor, mismatched devices).
    """
    global LAUNCHES
    _check_inputs(x, c)
    for name, t in (("x", x), ("c", c)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_pts, n = x.shape
    lib = _lib()
    with torch.cuda.device(x.device):
        labels = torch.empty((n_pts,), dtype=torch.int32, device=x.device)
        dist = torch.empty((n_pts,), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.assign_argmin(
            x.data_ptr(), c.data_ptr(), n_pts, n, c.shape[0],
            labels.data_ptr(), dist.data_ptr(), stream,
        )
    if status != 0:
        msg = lib.assign_argmin_error_string(status).decode()
        raise RuntimeError(f"assign_argmin kernel launch failed: {msg} ({status})")
    LAUNCHES += 1
    return labels, dist


def assign_argmin_plain(
    x: torch.Tensor, c: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version over the full ``(N, K)`` distance matrix."""
    _check_inputs(x, c)
    d2 = (
        torch.sum(x * x, dim=1, keepdim=True)
        - 2.0 * x @ c.T
        + torch.sum(c * c, dim=1)[None, :]
    )
    return torch.argmin(d2, dim=1).to(torch.int32), torch.amin(d2, dim=1)
