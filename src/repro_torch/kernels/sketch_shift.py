"""The sketch-and-shift score step: the CUDA kernel and its plain twin.

Counterpart of ``repro.kernels.sketch_shift.sketch_shift_kernel``.  For
candidates ``c (P, n)``, a dense frequency matrix ``w (n, m)`` and the halves
``z1, z2 (m,)`` of a stacked-real sketch, both functions here return the
unnormalised sums

    f_sums (P,)   = sum_j  cos(c w_j) z1_j - sin(c w_j) z2_j
    g_sums (P, n) = sum_j (-sin(c w_j) z1_j - cos(c w_j) z2_j) w_j

- :func:`sketch_shift_sums` launches ``csrc/sketch_shift.cu`` on CUDA tensors
  (or raises) and counts each launch in ``LAUNCHES``;
- :func:`sketch_shift_sums_plain` is the plain PyTorch version: ``c @ w``,
  then the two sums.

``kernels.ops.sketch_shift_scores`` picks between them by the tensor's
device and divides by m.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda, sm_count

# Kernel launches since the count was last reset (plain calls do not count).
LAUNCHES = 0
_CANDS = 4  # candidates per block (kCands in the source)
_CHUNK = 1024  # frequencies per chunk (kChunk in the source)
_BLOCKS_PER_SM = 2  # what a long m is split for


def _lib() -> ctypes.CDLL:
    lib = _build.load("sketch_shift")
    fn = lib.sketch_shift_sums
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr]
        fn.restype = i32
        lib.sketch_shift_error_string.argtypes = [i32]
        lib.sketch_shift_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(c, w, z1, z2) -> None:
    if c.ndim != 2 or w.ndim != 2 or z1.ndim != 1 or z2.ndim != 1:
        raise ValueError(
            f"expected c (P, n), w (n, m), z1 and z2 (m,); got {tuple(c.shape)}, "
            f"{tuple(w.shape)}, {tuple(z1.shape)}, {tuple(z2.shape)}"
        )
    if c.shape[1] != w.shape[0] or z1.shape[0] != w.shape[1] or z2.shape != z1.shape:
        raise ValueError(
            f"shape mismatch: c {tuple(c.shape)}, w {tuple(w.shape)}, "
            f"z1 {tuple(z1.shape)}, z2 {tuple(z2.shape)}"
        )
    for name, t in (("c", c), ("w", w), ("z1", z1), ("z2", z2)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def split_frequencies(p_cand: int, m: int, sms: int) -> tuple[int, int]:
    """``(split_len, splits)``: the frequencies of each block along the
    grid's y axis, a whole number of chunks, and how many splits.  One split
    while ``m`` fits a chunk (the decoder's shapes); for a long ``m``, enough
    splits that the grid reaches ``_BLOCKS_PER_SM`` blocks an SM.  A fixed
    function of the shape on one card, so the split-order sum repeats its
    bits."""
    chunks = -(-m // _CHUNK)
    wanted = max(1, -(-_BLOCKS_PER_SM * sms // -(-p_cand // _CANDS)))
    per_split = -(-chunks // min(chunks, wanted, 65535))
    return per_split * _CHUNK, -(-chunks // per_split)


def sketch_shift_sums(
    c: torch.Tensor, w: torch.Tensor, z1: torch.Tensor, z2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: ``(f_sums (P,), g_sums (P, n))`` for CUDA tensors.

    Raises for anything the kernel does not take (a CPU tensor, another
    dtype, a non-contiguous tensor, mismatched devices).  The sums are
    bitwise repeatable: no float atomics, a fixed reduction order.
    """
    global LAUNCHES
    _check_inputs(c, w, z1, z2)
    dev = check_cuda((("c", c), ("w", w), ("z1", z1), ("z2", z2)))
    p_cand, n = c.shape
    m = w.shape[1]
    if max(p_cand * (n + 1), n * m) >= 2**31:
        raise ValueError(f"P, n, m = {p_cand}, {n}, {m} exceed the kernel's int32 sizes")
    split_len, splits = split_frequencies(p_cand, m, sm_count(dev))
    lib = _lib()
    with torch.cuda.device(dev):
        out = torch.empty((p_cand * (n + 1),), dtype=torch.float32, device=dev)
        part = None
        if splits > 1:
            part = torch.empty((splits, p_cand * (n + 1)), dtype=torch.float32, device=dev)
        status = lib.sketch_shift_sums(
            c.data_ptr(), w.data_ptr(), z1.data_ptr(), z2.data_ptr(), p_cand, n, m,
            split_len, splits, None if part is None else part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if status != 0:
        msg = lib.sketch_shift_error_string(status).decode()
        raise RuntimeError(f"sketch_shift kernel launch failed: {msg} ({status})")
    LAUNCHES += 1
    return out[:p_cand], out[p_cand:].view(p_cand, n)


def sketch_shift_sums_plain(
    c: torch.Tensor, w: torch.Tensor, z1: torch.Tensor, z2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``proj = c @ w``, then both sums (the ``(P, m)``
    trig matrices are materialised)."""
    _check_inputs(c, w, z1, z2)
    proj = c @ w
    cosp, sinp = torch.cos(proj), torch.sin(proj)
    f = cosp @ z1 - sinp @ z2
    g = ((-sinp) * z1 - cosp * z2) @ w.T
    return f, g
